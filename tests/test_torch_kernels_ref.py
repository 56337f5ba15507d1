"""The port's plain attention paths against the JAX package, on the CPU.

Same numpy inputs go through JAX's oracles (``repro.kernels.ref``, the
paged gather + masked oracle), JAX's Pallas kernels in interpret mode, and
the port's plain versions. Inputs are f32; the tolerance (1e-5) only
covers summation order. The paged kernel's split page walk (per-split
``(m, l, acc)`` partials merged in split order) is emulated here in f32
and held to the same oracles at 1e-5. The ``cuda`` tests hold both Hopper
kernels to their plain versions (bf16, atol = rtol = 2e-2), flash also at
(D, Dv) = (192, 128) and (64, 64) (seamless-m4t's encoder, causal
decoder and cross-attention down to one query row), and windowed at
(128, 128) (gemma3's 1024 window over 4096 positions, and paged decode at
frontiers past it), the paged kernel's output bit for bit across batch
compositions and block-table widths, and flash at (128, 128) bit for bit
to the outputs of the kernel before its (D, Dv) template.
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
from repro_torch.kernels.flash_attention import (HEAD_DIMS, check_inputs,
                                                 flash_attention, tma_strides)
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (
    MERGE_NODE, SPLIT_TOKENS, decode_attention_masked, gather_kv_pages,
    paged_decode_attention, paged_flash_decode, paged_flash_decode_plain,
    split_geometry)

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


@pytest.mark.parametrize("d,dv", [(128, 128), (192, 128), (64, 64),
                                  (32, 32), (16, 16),
                                  (192, 192), (128, 64), (256, 128),
                                  (128, 192), (64, 128), (32, 16), (8, 8)])
def test_flash_wrapper_shape_checks(d, dv):
    """The wrapper's checks (run before any launch): (D, Dv) in
    ``HEAD_DIMS`` = {(128, 128), (192, 128), (64, 64), (32, 32), (16, 16)}
    pass and give the output's
    shape with Dv, every other pair raises; so do a K narrower than Q, V
    off K's sequence, a batch or GQA grouping q does not share, f32 and a
    strided last axis."""
    def t(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    q, k, v = t(2, 8, 5, d), t(2, 2, 7, d), t(2, 2, 7, dv)
    if (d, dv) in HEAD_DIMS:
        assert check_inputs(q, k, v) == (2, 8, 5, dv)
    else:
        with pytest.raises(ValueError, match="HEAD_DIMS|Dv"):
            check_inputs(q, k, v)
    assert HEAD_DIMS == ((128, 128), (192, 128), (64, 64), (32, 32),
                         (16, 16))
    good = (t(2, 8, 5, 192), t(2, 2, 7, 192), t(2, 2, 7, 128))
    for bad in ((good[0], t(2, 2, 7, 128), good[2]),
                (good[0], good[1], t(2, 2, 6, 128)),
                (good[0], t(1, 2, 7, 192), t(1, 2, 7, 128)),
                (good[0], t(2, 3, 7, 192), t(2, 3, 7, 128))):
        with pytest.raises(ValueError):
            check_inputs(*bad)
    with pytest.raises(TypeError, match="bf16"):
        check_inputs(good[0].float(), *good[1:])
    wide = t(2, 2, 7, 256)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        check_inputs(good[0], good[1], wide)


def test_attention_with_a_narrower_v_matches_jax():
    """Dv != D (MLA's prefill: D = nope + rope, Dv = v) through
    ``ops.attention``'s plain path and the blockwise oracle, against the
    reference's oracle at 1e-5."""
    b, hq, hkv, sq, skv = 1, 4, 4, 24, 40
    q, k, v = (_np(b, hq, sq, 24, seed=16), _np(b, hkv, skv, 24, seed=17),
               _np(b, hkv, skv, 16, seed=18))
    want = jref.attention_ref(q, k, v, causal=True, q_offset=16)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, q_offset=16)
    assert got.shape == (b, hq, sq, 16)
    _close(got, want)
    _close(ref.attention_ref_blockwise(_t(q), _t(k), _t(v), q_offset=16,
                                       block_q=8, block_kv=8), want)


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


def _merge(parts):
    """Partials (m, l, acc) merged in order with the log-sum-exp rescale:
    the merged partial."""
    top = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l_, acc in parts:
        w = torch.exp(m - top)
        num = num + acc * w[:, None]
        den = den + l_ * w
    return top, den, num


def _split_walk(q, kp, vp, bt, cl, window=None):
    """The kernel's algorithm in f32, step by step: each slot's visible
    positions [lo, hi) cut into splits of ``pages_per_split`` pages, each
    live split's (m, l, acc) over its own positions, then the merge in
    split order (log-sum-exp rescale): in one level when the live splits
    lie in one node of MERGE_NODE splits, else each node's splits, then the
    nodes. Returns the output and, per slot, the live splits."""
    b, hq, _, d = q.shape
    _, hkv, pt, _ = kp.shape
    p_max = bt.shape[1]
    group = hq // hkv
    geom = split_geometry(b, hkv, group, pt, p_max, d)
    span = geom.pages_per_split * pt
    k = gather_kv_pages(kp, bt, seq_axis=1).float()
    v = gather_kv_pages(vp, bt, seq_axis=1).float()
    qg = q.float().reshape(b, hkv, group, d)
    out = torch.zeros((b, hkv, group, d))
    live = []
    for i in range(b):
        front = int(cl[i])
        hi = min(front + 1, p_max * pt)
        lo = 0 if window is None else max(0, front - window + 1)
        splits = [s for s in range(geom.n_splits)
                  if max(lo, s * span) < min(hi, (s + 1) * span)]
        live.append(splits)
        for h in range(hkv):
            parts = []
            for s in splits:
                a, z = max(lo, s * span), min(hi, (s + 1) * span)
                sc = qg[i, h] @ k[i, h, a:z].T * d ** -0.5     # (group, n)
                m = sc.max(dim=1).values
                e = torch.exp(sc - m[:, None])
                parts.append((m, e.sum(dim=1), e @ v[i, h, a:z]))
            if not parts:
                continue
            nodes = sorted({s // MERGE_NODE for s in splits})
            if len(nodes) > 1:
                parts = [_merge([pt_ for s, pt_ in zip(splits, parts)
                                 if s // MERGE_NODE == nd]) for nd in nodes]
            _, den, num = _merge(parts)
            out[i, h] = num / den[:, None]
    return out.reshape(b, hq, 1, d), live


#: (frontiers, window, live splits per slot) at pt = 8 (a split is 64
#: positions, 8 pages) over P = 20 pages (not a multiple of the split)
SPLIT_CASES = {
    "frontier-0": ([0, 0], None, [[0], [0]]),
    "split-boundary": ([63, 64], None, [[0], [0, 1]]),
    "one-short-and-last": ([127, 159], None, [[0, 1], [0, 1, 2]]),
    "window-crosses-a-boundary": ([100, 70], 50, [[0, 1], [0, 1]]),
    "window-empties-splits": ([150, 140], 20, [[2], [1, 2]]),
}


@pytest.mark.parametrize("lens,window,nodes", [
    ([1500, 1023], None, [[0, 1], [0]]),
    ([1500, 1100], 200, [[1], [0, 1]]),
])
def test_two_level_merge_matches_jax(lens, window, nodes):
    """Slots whose live splits span two merge nodes (16 splits, 1024
    positions at pt = 8) merge each node, then the nodes: the oracle's
    output, the port's and JAX's."""
    d, pt, p_max = 16, 8, 200
    q, kp, vp, bt, cl = _paged_inputs(2, 4, 2, d, pt, p_max, lens, seed=6)
    got, splits = _split_walk(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                              window=window)
    assert [sorted({s // MERGE_NODE for s in sp}) for sp in splits] == nodes
    _close(got, decode_attention_masked(
        _t(q), gather_kv_pages(_t(kp), _t(bt), seq_axis=1),
        gather_kv_pages(_t(vp), _t(bt), seq_axis=1), _t(cl), window=window))
    _close(got, j_paged(*(jnp.asarray(x) for x in (q, kp, vp, bt, cl)),
                        window=window))


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_page_walk_matches_jax(case, hq, hkv):
    """The split walk with its ordered merge gives the masked oracle's
    output (the port's and JAX's, oracle and Pallas page walk) at a
    frontier of 0, frontiers on and one short of a split boundary, the last
    position of a block-table row that no split divides, a window across a
    boundary and a window that empties whole splits; pages past each
    frontier are null."""
    lens, window, live = SPLIT_CASES[case]
    d, pt, p_max = 16, 8, 20
    q, kp, vp, bt, cl = _paged_inputs(2, hq, hkv, d, pt, p_max, lens,
                                      seed=5)
    got, splits = _split_walk(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                              window=window)
    assert splits == live
    _close(got, decode_attention_masked(
        _t(q), gather_kv_pages(_t(kp), _t(bt), seq_axis=1),
        gather_kv_pages(_t(vp), _t(bt), seq_axis=1), _t(cl), window=window))
    jargs = tuple(jnp.asarray(x) for x in (q, kp, vp, bt, cl))
    _close(got, j_paged(*jargs, window=window))
    _close(got, j_paged(*jargs, window=window, impl="pallas"))


def test_split_geometry_depends_only_on_the_table_width():
    """Grid (n_splits, Hkv, B) and the f32 workspace (B, Hkv, n_splits,
    group, D + 2) follow from B, Hkv, group, page size and P alone (no
    frontier enters), with the source's SPLIT_TOKENS and its size check."""
    text = (build.CSRC / "paged_attention.cu").read_text()
    assert f"constexpr int SPLIT_TOKENS = {SPLIT_TOKENS};" in text
    assert f"constexpr int NODE = {MERGE_NODE};" in text
    assert ("(long long)batch * hkv * (n_splits + n_nodes) * group * (D + 2)"
            in text)
    assert "n_counters < batch * hkv * (n_nodes + 1)" in text
    assert "const dim3 grid(n_splits, hkv, batch);" in text
    main = split_geometry(4, 2, 8, 16, 36, 128)     # qwen's decode step
    assert main.pages_per_split == 4 and main.n_splits == 9
    assert main.n_nodes == 1 and main.grid == (9, 2, 4)
    assert main.workspace_floats == 4 * 2 * (9 + 1) * 8 * 130
    assert main.counters == 4 * 2 * 2
    assert split_geometry(4, 2, 8, 16, 64, 128).grid == (16, 2, 4)
    long = split_geometry(4, 2, 8, 16, 256, 128)    # 4 slots x 4096
    assert long.n_splits == 64 and long.n_nodes == 4
    assert long.counters == 4 * 2 * 5
    for pt, pps in ((8, 8), (16, 4), (5, 12), (48, 1), (64, 1)):
        geom = split_geometry(3, 1, 2, pt, 25, 128)
        assert geom.pages_per_split == pps
        assert geom.n_splits == -(-25 // pps)
    assert split_geometry(1, 2, 8, 16, 36, 128).workspace_floats \
        * 4 == main.workspace_floats
    assert split_geometry(4, 2, 8, 16, 37, 128).n_nodes == 1
    assert split_geometry(4, 2, 8, 16, 65, 128).n_nodes == 2


@pytest.mark.parametrize("source,parts", [
    ("paged_attention.cu", (
        '#include "hopper.cuh"', "hopper::cp_async16(ks + at",
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
        "atomicAdd(counter, 1)", "const dim3 grid(n_splits, hkv, batch);")),
    ("mamba_scan.cu", (
        '#include "hopper.cuh"', "hopper::cp_async16(",
        "hopper::cp_async_wait_all();", "transpose_sub<T>(",
        "__shfl_xor_sync(0xffffffffu, send, 8)",
        "mamba_scan_step_kernel<T>")),
])
def test_redesigned_kernels_keep_their_design(source, parts):
    """The split page walk stages pages with cp.async and runs its products
    on mma.sync with an in-launch merge; the scan stages a cp.async ring,
    transposes it, sums y with the transposed butterfly and has its
    one-step kernel: a later edit cannot quietly drop them."""
    text = (build.CSRC / source).read_text()
    for part in parts:
        assert part in text, part
    assert "hopper.cuh" in [p.name for p in build._sources(source[:-3])]


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
    reference's dispatch; so does a quantized pool (int8 codes with per-page
    scales, dequantized after the gather, against the reference's same
    path), and the paged kernel refuses one."""
    d, pt, p_max = 16, 8, 4
    q, kp, vp, bt, cl = _paged_inputs(2, 4, 2, d, pt, p_max, [5, 20], seed=1)
    q3 = np.concatenate([q, q, q], axis=2)
    for qq, causal in ((q3, True), (q, False)):
        got = paged_decode_attention(_t(qq), _t(kp), _t(vp), _t(bt), _t(cl),
                                     causal=causal)
        want = j_paged(jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(bt), jnp.asarray(cl), causal=causal)
        _close(got, want)
    codes = [np.clip(np.round(np.asarray(x, np.float32) * 40), -127,
                     127).astype(np.int8) for x in (kp, vp)]
    scales = [np.linspace(0.01, 0.03, kp.shape[0]).astype(np.float32)] * 2
    got = paged_decode_attention(_t(q), *map(_t, codes), _t(bt), _t(cl),
                                 k_scale=_t(scales[0]), v_scale=_t(scales[1]))
    want = j_paged(jnp.asarray(q), *map(jnp.asarray, codes), jnp.asarray(bt),
                   jnp.asarray(cl), k_scale=jnp.asarray(scales[0]),
                   v_scale=jnp.asarray(scales[1]))
    _close(got, want)
    with pytest.raises(NotImplementedError, match="quantized"):
        paged_decode_attention(_t(q), *map(_t, codes), _t(bt), _t(cl),
                               k_scale=_t(scales[0]), v_scale=_t(scales[1]),
                               impl="kernel")


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


def test_flash_tma_strides_read_the_models_views_in_place():
    """The model's q/k/v are ``transpose(1, 2)`` views of (B, S, H, D)
    tensors: TMA reads them through their own strides (no copy). A size-1
    dim is never stepped and takes stride D; a stride off the 16-byte grain
    needs a copy (None)."""
    x = torch.zeros((2, 40, 16, 128), dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert tma_strides(view) == (40 * 16 * 128, 128, 16 * 128)
    assert tma_strides(x[:1].transpose(1, 2)) == (128, 128, 16 * 128)
    assert tma_strides(torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16)) \
        == (128, 128, 128)
    odd = torch.zeros((1, 2, 5, 130), dtype=torch.bfloat16)[..., :128]
    assert tma_strides(odd) is None
    assert tma_strides(odd.clone(memory_format=torch.contiguous_format)) \
        == (128, 5 * 128, 128)


#: flash cases on the card: (B, Hq, Hkv, Sq, Skv, kwargs, transposed views)
FLASH_CASES = {
    "admission-b4-sq256": (4, 16, 2, 256, 256, {}, False),
    "ragged-sq300-skv333": (1, 16, 2, 300, 333, {}, False),
    "model-views": (2, 16, 2, 200, 256, {}, True),
    "window": (1, 16, 2, 512, 576, {"window": 64}, False),
    "q-offset": (1, 16, 2, 37, 576, {"q_offset": 16}, False),
    "mha": (1, 16, 16, 512, 576, {}, False),
    "non-causal": (1, 8, 2, 100, 130, {"causal": False}, False),
    # jamba-1.5-large-398b's admission at its widths: 64 query heads over 8
    "jamba-admission-views": (4, 64, 8, 256, 256, {}, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_cases_on_the_card(case):
    """The tensor-core flash kernel against its plain version (bf16, atol
    = rtol = 2e-2): the one-shot's admission batch, an Sq no query tile
    divides over a ragged Skv, the strided views models/attention.py
    passes, a window, a q_offset, Hq == Hkv, no causal mask and jamba's
    admission (64 query heads over 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, hq, hkv, sq, skv, kw, views = FLASH_CASES[case]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(bb, h, s):
        shape = (bb, s, h, 128) if views else (bb, h, s, 128)
        t = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return t.transpose(1, 2) if views else t

    q, k, v = rnd(b, hq, sq), rnd(b, hkv, skv), rnd(b, hkv, skv)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               ref.attention_ref(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)


#: flash cases at MLA's widths on the card: (B, H, Sq, Skv, kwargs),
#: D = 192 (nope 128 + rope 64), Dv = 128, Hq = Hkv (deepseek-v2)
#: seamless-m4t-medium's three kinds of call at (64, 64), 16 heads over
#: 16: (B, Sq, Skv, kwargs)
FLASH_D64_CASES = {
    "encoder": (4, 512, 512, {"causal": False}),
    "decoder-prefill": (4, 256, 256, {}),
    "cross": (4, 256, 512, {"causal": False}),
    "cross-one-row": (4, 1, 512, {"causal": False}),
    "ragged-at-offset": (2, 300, 333, {"q_offset": 33}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_D64_CASES))
def test_flash_kernel_d64_on_the_card(case):
    """The kernel at (D, Dv) = (64, 64) on the model's ``transpose(1, 2)``
    views against its plain version (bf16, atol = rtol = 2e-2), one launch
    counted for its instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, sq, skv, kw = FLASH_D64_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(3)

    def view(seq):
        return torch.randn((b, seq, 16, 64), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    q, k, v = view(sq), view(skv), view(skv)
    before = flash_attention.launches_by_dims[64, 64]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_dims[64, 64] == before + 1
    torch.testing.assert_close(got.float(), ref.attention_ref(
        q, k, v, **kw).float(), atol=2e-2, rtol=2e-2)


#: flash at (32, 32) and (16, 16), the training examples' self-attention:
#: (B, Hq, Hkv, S, D, kwargs)
FLASH_NARROW_CASES = {
    "quickstart": (8, 8, 4, 256, 32, {}),
    "elastic-restart": (8, 4, 2, 64, 16, {}),
    "d32-ragged-at-offset": (2, 8, 2, 300, 32, {"q_offset": 33}),
    "d16-window": (2, 4, 2, 333, 16, {"window": 40}),
    "d16-noncausal-one-row": (3, 4, 4, 1, 16, {"causal": False}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_NARROW_CASES))
def test_flash_kernel_narrow_heads_on_the_card(case):
    """The kernel at (D, Dv) = (32, 32) and (16, 16) (the (64, 64) tile
    over tensors D wide) on the model's ``transpose(1, 2)`` views against
    its plain version (bf16, atol = rtol = 2e-2), one launch counted for its
    instance, the output D wide."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, hq, hkv, n, d, kw = FLASH_NARROW_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(5)

    def view(heads, seq):
        return torch.randn((b, seq, heads, d), generator=g,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    skv = n + kw.get("q_offset", 0)
    q, k, v = view(hq, n), view(hkv, skv), view(hkv, skv)
    before = flash_attention.launches_by_dims[d, d]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_dims[d, d] == before + 1
    assert got.shape == (b, hq, n, d)
    torch.testing.assert_close(got.float(), ref.attention_ref(
        q, k, v, **kw).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_windowed_kernels_past_the_window_on_the_card():
    """gemma3's window on the card: flash (128, 128) over 4096 positions
    with a 1024 window (the blocks behind the band skipped), and paged
    decode at frontiers 2048-4095 with the same window, each against its
    plain version (bf16, atol = rtol = 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = rnd(1, 32, 4096, 128), rnd(1, 16, 4096, 128), rnd(1, 16, 4096,
                                                                 128)
    torch.testing.assert_close(
        flash_attention(q, k, v, window=1024).float(),
        ref.attention_ref(q, k, v, window=1024).float(), atol=2e-2,
        rtol=2e-2)
    pt, p = 16, 256
    kp, vp = rnd(4 * p + 1, 16, pt, 128), rnd(4 * p + 1, 16, pt, 128)
    bt = (torch.randperm(4 * p, generator=g, device="cuda") + 1).reshape(
        4, p).to(torch.int32)
    cl = torch.tensor([2048, 2900, 3333, 4095], dtype=torch.int32,
                      device="cuda")
    qd = rnd(4, 32, 1, 128)
    torch.testing.assert_close(
        paged_flash_decode(qd, kp, vp, bt, cl, window=1024).float(),
        paged_flash_decode_plain(qd, kp, vp, bt, cl, window=1024).float(),
        atol=2e-2, rtol=2e-2)


FLASH_MLA_CASES = {
    "admission-b4-sq256": (4, 128, 256, 256, {}),
    "over-the-depth": (4, 128, 256, 288, {}),
    "ragged-at-offset": (2, 16, 300, 333, {"q_offset": 33}),
    "window": (1, 16, 300, 333, {"window": 50}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_MLA_CASES))
def test_flash_kernel_mla_widths_on_the_card(case):
    """The kernel at (D, Dv) = (192, 128) against its plain version (bf16,
    atol = rtol = 2e-2), its output (B, H, Sq, 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, h, sq, skv, kw = FLASH_MLA_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = rnd(b, h, sq, 192), rnd(b, h, skv, 192), rnd(b, h, skv, 128)
    before = flash_attention.launches
    got = flash_attention(q, k, v, scale=192 ** -0.5, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (b, h, sq, 128)
    torch.testing.assert_close(
        got.float(), ref.attention_ref(q, k, v, scale=192 ** -0.5,
                                       **kw).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_kernel_at_128_is_unchanged_on_the_card():
    """At (D, Dv) = (128, 128) the templated kernel's outputs equal, bit for
    bit, those of the kernel before the template: ``chip_smoke.py``'s
    FLASH_DIGESTS over its numpy-seeded cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hashlib
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for i, case in enumerate(smoke.FLASH_DIGEST_CASES):
        q, k, v, kw = smoke.flash_digest_inputs(case, 100 + i)
        out = flash_attention(q, k, v, **kw)
        digest = hashlib.sha256(
            out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        assert digest[:16] == smoke.FLASH_DIGESTS[case], case


def _card_pool(b, p_max, lens, *, hq=16, hkv=2, pt=16, seed=0,
               pool_pages=None):
    """A bf16 pool on the card with each slot's pages shuffled and the
    entries past its frontier null, as the scheduler leaves them."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = pool_pages or b * p_max + 1
    kp = torch.randn((n_pages, hkv, pt, 128), generator=g,
                     device=dev).bfloat16()
    vp = torch.randn((n_pages, hkv, pt, 128), generator=g,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    bt = perm[:b * p_max].reshape(b, p_max).to(torch.int32)
    mapped = (torch.arange(p_max, device=dev)[None, :] * pt
              <= torch.as_tensor(lens, device=dev)[:, None])
    bt = torch.where(mapped, bt, 0).contiguous()
    cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, hq, 1, 128), generator=g, device=dev).bfloat16()
    return q, kp, vp, bt, cl


#: paged cases on the card at pt = 16 (a split is 4 pages): (B, P,
#: frontiers, window)
PAGED_CARD_CASES = {
    "frontiers-0-boundary-last": (8, 40, [0, 63, 64, 639, 1, 127, 333, 17],
                                  None),
    "window-crosses": (4, 36, [100, 300, 575, 64], 50),
    "window-empties-splits": (4, 36, [400, 575, 200, 130], 20),
    "window-0": (2, 8, [5, 100], 0),
    "p-not-a-split-multiple": (3, 37, [591, 580, 512], None),
    "two-level-merge": (3, 100, [1599, 1023, 1100], None),
    "two-level-window": (2, 100, [1599, 1100], 700),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAGED_CARD_CASES))
def test_paged_split_cases_on_the_card(case):
    """The split page walk against its plain version (bf16, atol = rtol =
    2e-2) at split-edge frontiers and windows, with one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, p_max, lens, window = PAGED_CARD_CASES[case]
    q, kp, vp, bt, cl = _card_pool(b, p_max, lens)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, kp, vp, bt, cl, window=window)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    want = paged_flash_decode_plain(q, kp, vp, bt, cl, window=window)
    if window == 0:       # nothing visible: the kernel writes zeros
        assert torch.count_nonzero(got) == 0
        return
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_paged_decode_is_batch_and_width_invariant_on_the_card():
    """A slot's output is bit for bit the same decoded alone or in a batch
    of 4, and with its block-table row 36, 64 or 100 pages wide
    (null-padded), repeated launches included (the merge's counters
    reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lens = [300, 575, 17, 128]
    q, kp, vp, bt, cl = _card_pool(4, 36, lens, seed=3)
    batch = paged_flash_decode(q, kp, vp, bt, cl)
    for i in range(4):
        alone = paged_flash_decode(q[i:i + 1], kp, vp, bt[i:i + 1],
                                   cl[i:i + 1])
        assert torch.equal(alone, batch[i:i + 1]), i
    for width in (64, 100):     # 100 pages: two merge nodes' worth
        wide = torch.zeros((4, width), dtype=torch.int32, device=bt.device)
        wide[:, :36] = bt
        assert torch.equal(paged_flash_decode(q, kp, vp, wide, cl), batch)
    assert torch.equal(paged_flash_decode(q, kp, vp, bt, cl), batch)


@pytest.mark.cuda
def test_paged_decode_long_context_on_the_card():
    """4 slots x 4096 positions (256 pages each, 64 splits a slot) against
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, kp, vp, bt, cl = _card_pool(4, 256, [4095, 4000, 2048, 3333], seed=4)
    got = paged_flash_decode(q, kp, vp, bt, cl)
    torch.testing.assert_close(
        got.float(), paged_flash_decode_plain(q, kp, vp, bt, cl).float(),
        atol=2e-2, rtol=2e-2)
