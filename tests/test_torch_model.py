"""The port's dense GQA model against the JAX package, on the CPU.

Weights come from the reference's ``Model.init`` through the numpy bridge,
inputs from numpy seeds. Layers compare in bf16 at ``rtol = 1.6e-2`` (1-2
bf16 ulp: the two frameworks round bf16 at different places). Whole
models compare f32 logits: prefill plus 16 teacher-forced decode steps
over the dense slab and over the paged pool, within ``LOGIT_TOL = 1e-2``.
Measured on the CPU: max |dlogit| 8.6e-3 (mistral-nemo-12b, paged decode;
prefill 4-6e-3, logits up to ~0.5). It comes from bf16 roundings that
differ between the frameworks, SiLU above all: XLA's bf16 SiLU and
PyTorch's differ in the last bit of about a third of their outputs.
Wherever the reference's top-2 margin exceeds 2e-2, the argmax
must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.models import layers as jl
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, layers, transformer
from repro_torch.models.bridge import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
LOGIT_TOL = 1e-2
MARGIN = 2e-2
BF16_RTOL = 1.6e-2
ARCHS = ["qwen2.5-3b", "yi-6b", "mistral-nemo-12b"]


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) per arch, built once."""
    out = {}
    for arch in ARCHS:
        jm = j_build_model(j_get_reduced(arch))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(get_reduced(arch), device="cpu")
        out[arch] = (jm, jp, tm, params_from_numpy(_to_np(jp), "cpu"))
    return out


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _close_bf16(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


# ------------------------------------------------------------------ bridge

def test_bridge_round_trip_and_tree_parity(pair):
    """The reference's params load by a plain tree map: same keys, same
    shapes, no transposes — and the port's own init makes the same tree."""
    _, jp, tm, tp = pair["qwen2.5-3b"]
    jnp_tree = _to_np(jp)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jnp_tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jnp_tree)
    assert jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(own)) \
        == shapes


# ------------------------------------------------------------------ layers

def test_rmsnorm_linear_mlp_match_jax():
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(2, 5, 64))
    w, b = rng.randn(64, 48).astype(np.float32), rng.randn(48).astype(
        np.float32)
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x, torch.bfloat16)
    _close_bf16(layers.rmsnorm({"scale": _t(scale)}, xt),
                jl.rmsnorm({"scale": jnp.asarray(scale)}, xb).astype(
                    jnp.float32))
    _close_bf16(layers.linear(xt, _t(w), _t(b)),
                jl.linear(xb, jnp.asarray(w), jnp.asarray(b)).astype(
                    jnp.float32))
    mp = {"w_gate": rng.randn(64, 96).astype(np.float32) / 8,
          "w_up": rng.randn(64, 96).astype(np.float32) / 8,
          "w_down": rng.randn(96, 64).astype(np.float32) / 10}
    _close_bf16(layers.mlp({k: _t(v) for k, v in mp.items()}, xt),
                jl.mlp({k: jnp.asarray(v) for k, v in mp.items()}, xb)
                .astype(jnp.float32))


def test_embed_unembed_rope_match_jax():
    rng = np.random.RandomState(1)
    table = (rng.randn(256, 32) * 0.02).astype(np.float32)
    toks = rng.randint(0, 256, size=(2, 7)).astype(np.int32)
    tp, jp = {"embed": _t(table)}, {"embed": jnp.asarray(table)}
    emb = layers.embed(tp, _t(toks))
    _close_bf16(emb, jl.embed(jp, jnp.asarray(toks)).astype(jnp.float32))
    x = _bf16(rng.randn(2, 7, 32))
    logits = layers.unembed_logits(tp, _t(x, torch.bfloat16))
    assert logits.dtype == torch.float32            # f32 logits, never bf16
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jl.unembed_logits(
            jp, jnp.asarray(x, jnp.bfloat16))), rtol=1e-5, atol=1e-6)
    q = _bf16(rng.randn(2, 4, 7, 16))
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    _close_bf16(layers.apply_rope(_t(q, torch.bfloat16), _t(pos), 1e6),
                jl.apply_rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos),
                              1e6).astype(jnp.float32))


# ----------------------------------------------------------- whole models

def _check_logits(got, want, what):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL, f"{what}: max |dlogit| {err:.3e}"
    flat_j = want.reshape(-1, want.shape[-1])
    flat_t = got.reshape(-1, got.shape[-1])
    top2 = np.sort(flat_j, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > MARGIN
    assert (flat_t.argmax(-1) == flat_j.argmax(-1))[decided].all(), what
    return err


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_dense_decode_match_jax(pair, arch):
    """Prefill logits, then 16 teacher-forced decode steps over the dense
    slab (0-d cache_len, the one-shot generate path)."""
    jm, jp, tm, tp = pair[arch]
    cfg = tm.cfg
    rng = np.random.RandomState(2)
    b, s, steps, max_len = 2, 9, 16, 32
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, b)).astype(np.int32)
    j_decode = jax.jit(jm.decode_step)
    jl_, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len)
    tl_, tstate = tm.prefill(tp, {"tokens": _t(prompt)}, max_len)
    _check_logits(tl_, jl_, f"{arch} prefill")
    for i in range(steps):
        jl_, jstate = j_decode(jp, jnp.asarray(forced[i])[:, None], jstate,
                               jnp.asarray(s + i, jnp.int32))
        tl_, tstate = tm.decode_step(tp, _t(forced[i])[:, None], tstate,
                                     torch.tensor(s + i, dtype=torch.int32))
        _check_logits(tl_, jl_, f"{arch} dense decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(pair, arch):
    """Two prompts of different lengths prefilled one at a time, cut into
    pages at shuffled block-table rows, then 16 teacher-forced decode steps
    over the paged pool with per-slot frontiers."""
    jm, jp, tm, tp = pair[arch]
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    pt, p_max, n_pages, steps = 8, 4, 10, 16
    depth = pt * p_max
    lens = [5, 11]
    bt = np.asarray([[3, 7, 1, 9], [2, 8, 5, 4]], np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, 2)).astype(np.int32)
    import repro.models.transformer as jt
    jpool = {"caches": jt.init_paged_caches(jm.cfg, 2, n_pages, pt)}
    tpool = {"caches": transformer.init_paged_caches(cfg, 2, n_pages, pt,
                                                     "cpu")}
    for slot, n in enumerate(lens):
        prompt = rng.randint(2, cfg.vocab_size, size=(1, n)).astype(np.int32)
        last = np.asarray([n - 1], np.int32)
        jl_, jrow = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, depth,
                               last_pos=jnp.asarray(last))
        tl_, trow = tm.prefill(tp, {"tokens": _t(prompt)}, depth,
                               last_pos=_t(last))
        _check_logits(tl_, jl_, f"{arch} paged admission {slot}")
        jpool = jm.slot_update_paged(jpool, jrow, jnp.asarray(slot),
                                     jnp.asarray(bt[slot]), pt)
        tpool = tm.slot_update_paged(tpool, trow, slot, _t(bt[slot]), pt)
    cache_len = np.asarray(lens, np.int32)
    j_decode = jax.jit(jm.decode_step)
    for i in range(steps):
        jl_, jpool = j_decode(jp, jnp.asarray(forced[i])[:, None], jpool,
                              jnp.asarray(cache_len),
                              block_tables=jnp.asarray(bt))
        tl_, tpool = tm.decode_step(tp, _t(forced[i])[:, None], tpool,
                                    _t(cache_len), block_tables=_t(bt))
        _check_logits(tl_, jl_, f"{arch} paged decode step {i}")
        cache_len = cache_len + 1


def test_unported_families_raise():
    """Other families name the ROADMAP item that brings them."""
    for arch in ("jamba-1.5-large-398b", "deepseek-v2-236b",
                 "qwen3-moe-30b-a3b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_reduced(arch), device="cpu")

