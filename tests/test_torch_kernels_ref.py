"""The port's plain attention paths against the JAX package, on the CPU.

Same numpy inputs go through JAX's oracles (``repro.kernels.ref``, the
paged gather + masked oracle), JAX's Pallas kernels in interpret mode, and
the port's plain versions. Inputs are f32; the tolerance (1e-5) only
covers summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiling
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import (
    decode_attention_masked as j_decode, gather_kv_pages as j_gather,
    paged_decode_attention as j_paged)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    decode_attention_masked, gather_kv_pages, paged_decode_attention,
    paged_flash_decode)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])    # groups 1/2/4
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_attention_ref_matches_jax(hq, hkv, causal, window):
    b, s, d = 2, 64, 16
    q, k, v = (_np(b, hq, s, d, seed=1), _np(b, hkv, s, d, seed=2),
               _np(b, hkv, s, d, seed=3))
    got = ref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            window=window)
    want = jref.attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want)
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    plan=tiling.AttentionPlan(block_q=32, block_kv=32),
                    causal=causal, window=window, interpret=True)
    _close(got, pallas)


@pytest.mark.parametrize("q_offset,window", [(32, None), (16, None),
                                             (32, 8)])
def test_attention_q_offset_matches_jax(q_offset, window):
    """A query block at an absolute offset over a deeper cache — the
    prefill-over-cache-depth and chunked-prefill contract."""
    b, hq, hkv, sq, skv, d = 1, 4, 2, 32, 64, 16
    q, k, v = (_np(b, hq, sq, d, seed=4), _np(b, hkv, skv, d, seed=5),
               _np(b, hkv, skv, d, seed=6))
    want = jref.attention_ref(q, k, v, causal=True, window=window,
                              q_offset=q_offset)
    for offset in (q_offset, torch.tensor(q_offset, dtype=torch.int32)):
        got = ops.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                            q_offset=offset)
        _close(got, want)
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    plan=tiling.AttentionPlan(block_q=16, block_kv=16),
                    causal=True, window=window, q_offset=q_offset,
                    interpret=True)
    _close(ref.attention_ref(_t(q), _t(k), _t(v), causal=True, window=window,
                             q_offset=q_offset), pallas)


@pytest.mark.parametrize("window", [None, 24])
def test_attention_blockwise_matches_jax(window):
    b, hq, hkv, s, d = 1, 4, 2, 64, 16
    q, k, v = (_np(b, hq, s, d, seed=7), _np(b, hkv, s, d, seed=8),
               _np(b, hkv, s, d, seed=9))
    got = ref.attention_ref_blockwise(_t(q), _t(k), _t(v), window=window,
                                      q_offset=0, block_q=16, block_kv=32)
    want = jref.attention_ref_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=16, block_kv=32)
    _close(got, want)
    _close(got, ref.attention_ref(_t(q), _t(k), _t(v), window=window))


def test_fully_masked_rows_are_zero():
    """window = 0 masks every key: rows come out 0, as in the reference."""
    q, k, v = _np(1, 2, 8, 16, seed=10), _np(1, 2, 8, 16, seed=11), \
        _np(1, 2, 8, 16, seed=12)
    got = ref.attention_ref(_t(q), _t(k), _t(v), causal=True, window=0)
    assert torch.count_nonzero(got) == 0
    _close(got, jref.attention_ref(q, k, v, causal=True, window=0))


def test_flash_wrapper_on_cpu_takes_the_plain_version():
    """On a CPU tensor the kernel wrapper computes its plain version and
    launches nothing; ``ops.attention(impl='kernel')`` reaches it."""
    q, k, v = (_t(_np(1, 4, 16, 16, seed=13)), _t(_np(1, 2, 16, 16, seed=14)),
               _t(_np(1, 2, 16, 16, seed=15)))
    before = flash_attention.launches
    got = ops.attention(q, k, v, impl="kernel")
    assert flash_attention.launches == before
    torch.testing.assert_close(got, ref.attention_ref(q, k, v))
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")


# ------------------------------------------------------------- paged decode

def _paged_inputs(b, hq, hkv, d, pt, p_max, cache_len, seed):
    """Per-slot contiguous K/V scattered into a shuffled page pool; pages
    past a slot's frontier stay unmapped (null page 0)."""
    rng = np.random.RandomState(seed)
    n_pages = b * p_max + 1
    ids = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.zeros((b, p_max), np.int32)
    k = rng.randn(b, hkv, p_max * pt, d).astype(np.float32)
    v = rng.randn(b, hkv, p_max * pt, d).astype(np.float32)
    kp = rng.randn(n_pages, hkv, pt, d).astype(np.float32)    # junk
    vp = rng.randn(n_pages, hkv, pt, d).astype(np.float32)
    for i in range(b):
        for p in range(p_max):
            if p * pt > cache_len[i]:
                continue                       # null entry: junk page 0
            bt[i, p] = ids.pop()
            kp[bt[i, p]] = k[i, :, p * pt:(p + 1) * pt]
            vp[bt[i, p]] = v[i, :, p * pt:(p + 1) * pt]
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    return q, kp, vp, bt, np.asarray(cache_len, np.int32)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_decode_matches_jax(hq, hkv, window):
    """cache_len 0 / exactly a page boundary / mid-page / the last
    position, with null pages past each frontier (mirrors
    tests/test_paged.py::test_paged_flash_decode_matches_oracle)."""
    d, pt, p_max = 16, 8, 4
    lens = [0, 8, 13, 31]
    q, kp, vp, bt, cl = _paged_inputs(4, hq, hkv, d, pt, p_max, lens, seed=0)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                 window=window)
    jargs = tuple(jnp.asarray(x) for x in (q, kp, vp, bt, cl))
    _close(got, j_paged(*jargs, window=window))
    _close(got, j_paged(*jargs, window=window, impl="pallas"))
    jk = j_gather(jargs[1], jargs[3], seq_axis=1)
    jv = j_gather(jargs[2], jargs[3], seq_axis=1)
    _close(got, j_decode(jargs[0], jk, jv, jargs[4], window=window))
    # the wrapper's plain version on CPU is the same function
    _close(paged_flash_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                              window=window), got)


def test_gather_kv_pages_matches_jax_exactly():
    pages = _np(9, 2, 4, 8, seed=3)
    bt = np.asarray([[3, 1, 0], [8, 2, 5]], np.int32)
    got = gather_kv_pages(_t(pages), _t(bt), seq_axis=1)
    want = j_gather(jnp.asarray(pages), jnp.asarray(bt), seq_axis=1)
    assert got.shape == (2, 2, 12, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [1, 3])
def test_decode_attention_masked_matches_jax(s):
    """The dense-slab oracle with per-row frontiers, single- and
    multi-token (verify-chunk) queries."""
    b, hq, hkv, t, d = 3, 4, 2, 24, 16
    q, k, v = (_np(b, hq, s, d, seed=20), _np(b, hkv, t, d, seed=21),
               _np(b, hkv, t, d, seed=22))
    cl = np.asarray([0, 7, 20], np.int32)
    for window in (None, 5):
        got = decode_attention_masked(_t(q), _t(k), _t(v), _t(cl),
                                      window=window)
        want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(cl), window=window)
        _close(got, want)


def test_paged_multi_token_and_noncausal_take_the_oracle():
    """Multi-token queries and causal=False gather + oracle, as in the
    reference's dispatch; quantized pools are not ported yet."""
    d, pt, p_max = 16, 8, 4
    q, kp, vp, bt, cl = _paged_inputs(2, 4, 2, d, pt, p_max, [5, 20], seed=1)
    q3 = np.concatenate([q, q, q], axis=2)
    for qq, causal in ((q3, True), (q, False)):
        got = paged_decode_attention(_t(qq), _t(kp), _t(vp), _t(bt), _t(cl),
                                     causal=causal)
        want = j_paged(jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(bt), jnp.asarray(cl), causal=causal)
        _close(got, want)
    with pytest.raises(NotImplementedError, match="quantized"):
        paged_decode_attention(_t(q), _t(kp).to(torch.int8),
                               _t(vp).to(torch.int8), _t(bt), _t(cl),
                               k_scale=torch.ones(kp.shape[0]),
                               v_scale=torch.ones(kp.shape[0]))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both Hopper kernels against their plain versions at small shapes
    (bf16, atol = rtol = 2e-2). The full-shape check is chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(1, 16, 37, 128), rnd(1, 2, 80, 128), rnd(1, 2, 80, 128)
    for kw in ({}, {"window": 16}, {"q_offset": 8}):
        torch.testing.assert_close(
            flash_attention(q, k, v, **kw).float(),
            ref.attention_ref(q, k, v, **kw).float(), atol=2e-2, rtol=2e-2)
    qd = rnd(3, 16, 1, 128)
    kp, vp = rnd(13, 2, 16, 128), rnd(13, 2, 16, 128)
    bt = torch.arange(1, 13, device=dev, dtype=torch.int32).reshape(3, 4)
    cl = torch.tensor([0, 16, 63], dtype=torch.int32, device=dev)
    for window in (None, 7):
        torch.testing.assert_close(
            paged_flash_decode(qd, kp, vp, bt, cl, window=window).float(),
            paged_decode_attention(qd, kp, vp, bt, cl, window=window,
                                   impl="ref").float(), atol=2e-2, rtol=2e-2)
