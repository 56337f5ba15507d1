"""The port's SSM path (falcon-mamba) against the JAX package, on the CPU;
the selective-scan kernel against its plain version on the card.

Inputs come from numpy seeds, weights from the reference's ``init`` through
the numpy bridge, on the ``falcon-mamba-7b-smoke`` config (2 layers,
d_model 64, d_inner 128, d_state 8). Tolerances:

* the selective scan (f32): within 2e-4 of JAX's oracle and of its Pallas
  kernel in interpret mode, over ``tests/test_kernels.py``'s sweep and the
  carried-state split, the tolerance of ``test_mamba_scan_sweep``;
* one mamba block (bf16 out): atol = rtol = 1.6e-2, 1-2 bf16 ulp, as the
  layers of ``test_torch_model.py`` (the frameworks round bf16 at
  different places);
* whole models: f32 logits of prefill and of 16 teacher-forced decode
  steps (dense and paged) within ``LOGIT_TOL = 1e-2``; the loss within 1e-2
  relative;
* greedy tokens and the squeezed paged stream's tokens equal to the
  reference's, except where the reference's own teacher-forced top-2
  margin is under ``TIE_TOL = 2e-2`` (the test computes that margin and
  never skips a divergence); the stream's counters exactly equal.

Within the port the paged stream equals one-shot ``Engine.generate`` bit for
bit, and prefill plus decode steps give a full-sequence forward's logits
within 1e-4 (only the unembed's sums change with the row count). The ``cuda`` tests run the kernel on the card: bf16 y within atol =
rtol = 2e-2 of the plain version, f32 y and the final state within 2e-4,
several plans bit for bit equal, and a split scan equal to the full one.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import tiling as jtiling
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as jmamba_scan
from repro.models import build_model as j_build_model
from repro.models import ssm as jssm
from repro.serve import scheduler as j_sm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.core import tiling
from repro_torch.core.target import use_target
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.mamba_scan import (BLOCK_D, MAX_DS, SMEM_BYTES,
                                            SPLIT, mamba_scan,
                                            mamba_scan_plain, staging_bytes)
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, layers, ssm, transformer
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig

torch.set_num_threads(1)
ARCH = "falcon-mamba-7b"
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 1.6e-2
LOGIT_TOL = 1e-2
MARGIN = 2e-2
TIE_TOL = 2e-2
ECFG = dict(max_len=32, eos_token=1, sync_interval=4)
COUNTERS = ("preemptions", "spilled_pages", "restores", "chunks",
            "decode_steps", "host_syncs", "spill_high_water")
SWEEP = [(length, chunk, di, ds) for length, chunk in ((64, 16), (128, 64),
                                                      (128, 128))
         for di, ds in ((128, 16), (256, 8))]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32), np.float64)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _scan_inputs(b, length, di, ds, seed):
    """``tests/test_kernels.py``'s distributions, from a numpy seed."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, length, di).astype(np.float32) * 0.1
    dt = np.log1p(np.exp(rs.randn(b, length, di))).astype(np.float32) * 0.1
    a = -np.exp(rs.randn(di, ds).astype(np.float32) * 0.1)
    bb = rs.randn(b, length, ds).astype(np.float32) * 0.1
    c = rs.randn(b, length, ds).astype(np.float32) * 0.1
    d = np.ones((di,), np.float32)
    return x, dt, a, bb, c, d


# ------------------------------------------------------ the scan vs JAX

@pytest.mark.parametrize("length,chunk,di,ds", SWEEP)
def test_selective_scan_matches_jax_oracle_and_pallas(length, chunk, di, ds):
    args = _scan_inputs(2, length, di, ds, seed=11)
    jargs = [jnp.asarray(t) for t in args]
    want = jref.selective_scan_ref(*jargs)
    pallas = jmamba_scan(*jargs, plan=jtiling.ScanChunkPlan(chunk),
                         interpret=True)
    got = ops.selective_scan(*(_t(t) for t in args),
                             plan=tiling.ScanChunkPlan(chunk))
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)
    np.testing.assert_allclose(_np(got), _np(pallas), **SCAN_TOL)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_selective_scan_state_carry_matches_jax(impl):
    """Prefix with ``return_state``, the rest from ``h0``: each part and the
    carried state against the reference's oracle, and the split against the
    port's full scan."""
    x, dt, a, bb, c, d = _scan_inputs(2, 56, 128, 16, seed=12)
    cut = 23
    j = [jnp.asarray(t) for t in (x, dt, a, bb, c, d)]
    t = [_t(v) for v in (x, dt, a, bb, c, d)]

    def parts(fn, xs):
        y1, h = fn(xs[0][:, :cut], xs[1][:, :cut], xs[2], xs[3][:, :cut],
                   xs[4][:, :cut], xs[5], return_state=True)
        y2, h2 = fn(xs[0][:, cut:], xs[1][:, cut:], xs[2], xs[3][:, cut:],
                    xs[4][:, cut:], xs[5], h0=h, return_state=True)
        return y1, h, y2, h2

    want = parts(jref.selective_scan_ref, j)
    got = parts(lambda *a_, **k: ops.selective_scan(*a_, impl=impl, **k), t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **SCAN_TOL)
    full = ops.selective_scan(*t, impl=impl)
    np.testing.assert_allclose(
        np.concatenate([_np(got[0]), _np(got[2])], axis=1), _np(full),
        **SCAN_TOL)


def test_scan_dispatch_on_cpu():
    """``auto`` takes the plain version for CPU tensors (counted, no
    launch); ``kernel`` needs a CUDA tensor; the wrapper itself computes the
    plain version for a CPU tensor and refuses other devices."""
    t = [_t(v) for v in _scan_inputs(1, 8, 32, 4, seed=13)]
    before = (mamba_scan.launches, mamba_scan_plain.calls)
    y = ops.selective_scan(*t)
    assert (mamba_scan.launches, mamba_scan_plain.calls) == (
        before[0], before[1] + 1)
    with pytest.raises(ValueError, match="impl='kernel' runs the "
                                         "mamba_scan kernel on the card"):
        ops.selective_scan(*t, impl="kernel")
    torch.testing.assert_close(
        mamba_scan(*t, plan=tiling.ScanChunkPlan(4)), y, rtol=0, atol=0)
    assert mamba_scan.launches == before[0]
    meta = [v.to("meta") for v in t]
    with pytest.raises(ValueError, match="unsupported device"):
        mamba_scan(*meta, plan=tiling.ScanChunkPlan(4))


def test_wrapper_checks_what_the_kernel_takes():
    meta = [v.to("meta") for v in (_t(u) for u in _scan_inputs(
        2, 48, 64, 16, seed=15))]
    x, dt, a, bb, c, d = meta
    plan = tiling.ScanChunkPlan(16)
    with pytest.raises(ValueError, match="at most 16 states"):
        wide = torch.empty((64, 32), device="meta")
        bc = torch.empty((2, 48, 32), device="meta")
        mamba_scan(x, dt, wide, bc, bc, d, plan=plan)
    with pytest.raises(ValueError, match="chunk 32 does not divide the "
                                         "length 48"):
        mamba_scan(*meta, plan=tiling.ScanChunkPlan(32))
    big = SMEM_BYTES // staging_bytes(1, 16) + 1
    x_long = torch.empty((2, big, 64), device="meta")
    bc_long = torch.empty((2, big, 16), device="meta")
    with pytest.raises(ValueError, match=rf"staging {big} steps.*"
                                         rf"{SMEM_BYTES} B"):
        mamba_scan(x_long, x_long, a, bc_long, bc_long, d,
                   plan=tiling.ScanChunkPlan(big))
    with pytest.raises(TypeError, match="f32 or bf16"):
        mamba_scan(x.half(), dt, a, bb, c, d, plan=plan)
    with pytest.raises(TypeError, match="x = b = c"):
        mamba_scan(x.bfloat16(), dt, a, bb, c, d, plan=plan)
    with pytest.raises(TypeError, match="f32 dt, a, d and h0"):
        mamba_scan(x, dt.bfloat16(), a, bb, c, d, plan=plan)
    with pytest.raises(TypeError, match="f32 dt, a, d and h0"):
        mamba_scan(x, dt, a.bfloat16(), bb, c, d, plan=plan)
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan(x, dt, a, bb, c, d, plan=plan,
                   h0=torch.empty((2, 64, 8), device="meta"))


def test_kernel_limits_match_the_cuda_source():
    text = (build.CSRC / "mamba_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("MAX_DS") == MAX_DS == 16
    assert const("SPLIT") == SPLIT
    assert const("BD") == BLOCK_D
    assert const("MAX_SMEM") == SMEM_BYTES == 232448
    assert "sizeof(float) * size_t(chunk) * (2 * BD + 2 * ds)" in text
    assert staging_bytes(8, 16) == 4 * 8 * (2 * BLOCK_D + 2 * 16)


# ---------------------------------------------------- the block vs JAX

def _block_params(cfg, seed=0):
    jp = jssm.init_mamba(cfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_block_matches_jax(with_cache):
    jcfg, cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp, tp = _block_params(jcfg, seed=3)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x, torch.bfloat16)
    jcache = tcache = None
    if with_cache:
        conv = rng.randn(2, cfg.ssm_conv - 1, cfg.ssm_d_inner) * 0.5
        state = rng.randn(2, cfg.ssm_d_inner, cfg.ssm_d_state) * 0.5
        jcache = {"conv": jnp.asarray(conv, jnp.float32),
                  "ssm": jnp.asarray(state, jnp.float32)}
        tcache = {"conv": _t(conv, torch.float32),
                  "ssm": _t(state, torch.float32)}
    want, jnew = jssm.mamba_block(jp, xb, cfg=jcfg, cache=jcache)
    got, tnew = ssm.mamba_block(tp, xt, cfg=cfg, cache=tcache)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    if with_cache:
        assert tnew is tcache                       # updated in place
        for name in ("conv", "ssm"):
            assert tnew[name].dtype == torch.float32
            np.testing.assert_allclose(_np(tnew[name]), _np(jnew[name]),
                                       rtol=BF16_TOL, atol=BF16_TOL)


def test_init_and_caches_keep_the_reference_tree():
    """Same leaves and shapes as the reference's init and caches (dense
    and paged: one recurrent row per slot, never paged)."""
    import repro.models.transformer as jt
    jcfg, cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def shapes(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: np.empty(tuple(a.shape), np.int8), tree))[0]
        return [(jax.tree_util.keystr(p), a.shape) for p, a in flat]

    assert shapes(tp) == shapes(jp)
    for j, t in ((jt.init_caches(jcfg, 3, 16),
                  transformer.init_caches(cfg, 3, 16, "cpu")),
                 (jt.init_paged_caches(jcfg, 3, 10, 8),
                  transformer.init_paged_caches(cfg, 3, 10, 8, "cpu"))):
        assert shapes(t) == shapes(j)
    assert [k for *_, k in transformer.paged_cache_kinds(cfg)] == [False]


# ----------------------------------------------------- whole models

@pytest.fixture(scope="module")
def pair():
    jm = j_build_model(j_get_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(ARCH), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


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


def test_prefill_and_dense_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(2)
    b, s, steps, max_len = 2, 9, 16, 32
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, b)).astype(np.int32)
    j_decode = jax.jit(jm.decode_step)
    jl_, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len)
    tl_, tstate = tm.prefill(tp, {"tokens": _t(prompt)}, max_len)
    _check_logits(tl_, jl_, "prefill")
    for i in range(steps):
        jl_, jstate = j_decode(jp, jnp.asarray(forced[i])[:, None], jstate,
                               jnp.asarray(s + i, jnp.int32))
        tl_, tstate = tm.decode_step(tp, _t(forced[i])[:, None], tstate,
                                     torch.tensor(s + i, dtype=torch.int32))
        _check_logits(tl_, jl_, f"dense decode step {i}")


def test_paged_decode_matches_jax(pair):
    """Two prompts prefilled one at a time, their recurrent rows scattered
    at slots 1 and 0 of a paged pool, then 16 teacher-forced decode steps
    with per-slot frontiers and block tables."""
    import repro.models.transformer as jt
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    pt, p_max, n_pages, steps = 8, 4, 10, 16
    lens = [5, 11]
    bt = np.asarray([[3, 7, 1, 9], [2, 8, 5, 4]], np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, 2)).astype(np.int32)
    jpool = {"caches": jt.init_paged_caches(jm.cfg, 2, n_pages, pt)}
    tpool = {"caches": transformer.init_paged_caches(cfg, 2, n_pages, pt,
                                                     "cpu")}
    for slot in (1, 0):
        n = lens[slot]
        prompt = rng.randint(2, cfg.vocab_size, size=(1, n)).astype(np.int32)
        jl_, jrow = jm.prefill(jp, {"tokens": jnp.asarray(prompt)},
                               pt * p_max)
        tl_, trow = tm.prefill(tp, {"tokens": _t(prompt)}, pt * p_max)
        _check_logits(tl_, jl_, f"paged admission {slot}")
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
        _check_logits(tl_, jl_, f"paged decode step {i}")
        cache_len = cache_len + 1


def test_decode_steps_match_the_full_forward(pair):
    """Within the port, prefill and decode steps that carry the recurrent
    state give the logits of one full-sequence forward without caches (the
    relation the reference's ``test_prefill_then_decode_matches_full_
    forward`` holds at 5e-2). On the CPU the GEMMs do not depend on the
    row count, so only the unembed's sums may differ: within 1e-4."""
    _, _, tm, tp = pair
    cfg = tm.cfg
    toks = _t(np.random.RandomState(9).randint(2, cfg.vocab_size,
                                               size=(2, 24)), torch.int32)
    x, _ = transformer.forward(cfg, tp, toks)
    full = layers.unembed_logits(tp["tok"], x)
    got, state = tm.prefill(tp, {"tokens": toks[:, :8]}, 32)
    worst = (got[:, -1] - full[:, 7]).abs().max()
    for i in range(8, 24):
        got, state = tm.decode_step(tp, toks[:, i:i + 1], state,
                                    torch.tensor(i, dtype=torch.int32))
        worst = max(worst, (got[:, -1] - full[:, i]).abs().max())
    assert worst <= 1e-4, float(worst)


def test_prepare_is_bit_identical_for_mamba(pair):
    """Casting the mamba matrices to bf16 once gives the logits that the
    per-op casts give; a_log, dt_bias and ssm_d stay f32."""
    _, _, tm, tp = pair
    prepared = tm.prepare(tp)
    leaf = prepared["groups"]["blocks"]["pos0"]["mamba"]
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj", "conv_w",
                 "conv_b"):
        assert leaf[name].dtype == torch.bfloat16, name
    for name in ("a_log", "dt_bias", "ssm_d"):
        assert leaf[name].dtype == torch.float32, name
    toks = _t(np.random.RandomState(4).randint(2, 512, size=(2, 7)))
    a, _ = tm.prefill(tp, {"tokens": toks}, 16)
    b, _ = tm.prefill(prepared, {"tokens": toks}, 16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_matches_jax(pair):
    jm, jp, tm, tp = pair
    rng = np.random.RandomState(6)
    toks = rng.randint(2, tm.cfg.vocab_size, size=(2, 24)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((2, 1), np.int32)], 1)
    labels[0, :3] = -1
    want, jaux = jm.loss(jp, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    got, aux = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)},
                       plans=tm.kernel_plans(24))
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 2 * 23 - 3
    chunked, _ = transformer.lm_loss(tm.cfg, tp, _t(toks), _t(labels),
                                     loss_chunk=8)
    np.testing.assert_allclose(float(chunked), float(got), rtol=1e-6)


# ----------------------------------------------------------- serving

@pytest.fixture(scope="module")
def engines(pair):
    jm, jp, tm, tp = pair
    return (jm, jp, JEngine(jm, jp, JEngineConfig(**ECFG)),
            Engine(tm, tp, EngineConfig(**ECFG)))


def _assert_tokens_match(jm, jp, prompt, want, got, what):
    """Equal, or parted where the reference's own teacher-forced top-2
    margin is a near-tie (and the port's token is within it)."""
    assert len(got) == len(want), what
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if t is None:
        return
    seq = np.concatenate([prompt, np.asarray(want[:t], np.int32)])[None]
    logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq)}, seq.shape[1])
    row = np.asarray(logits[0, -1, :jm.cfg.vocab_size], np.float64)
    top2 = np.sort(row)[-2:]
    assert top2[1] - top2[0] < TIE_TOL, (what, t, top2)
    assert row[got[t]] >= top2[1] - TIE_TOL, (what, t)


def test_greedy_generate_matches_jax(engines):
    jm, jp, jeng, teng = engines
    cfg = teng.model.cfg
    toks = np.random.RandomState(7).randint(2, cfg.vocab_size, size=(3, 8))
    want, _ = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)},
                            n_steps=20)
    got, _ = teng.generate({"tokens": _t(toks, torch.int32)}, n_steps=20)
    want = np.asarray(want)
    assert got.shape == want.shape and got.shape[1] >= 16
    for i in range(3):
        _assert_tokens_match(jm, jp, toks[i].astype(np.int32),
                             want[i].tolist(), got[i].tolist(), f"row {i}")


def _squeezed(sched_mod, cfg, n_layer0=6, n_layer1=8):
    """A pool of six 8-token layer-0 pages for three slots. An
    attention-free model has no KV bytes per page, so the byte overrides
    count pages (``derive_page_geometry`` divides by max(page_bytes, 1))."""
    return sched_mod.derive_page_geometry(
        cfg, ECFG["max_len"], page_tokens=8, max_slots=3,
        layer0_bytes=n_layer0, layer1_bytes=n_layer1)


def _prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=n).astype(np.int32)
            for n in (6, 9, 4, 7)]


def _serve(engine, sched_mod, cfg, prompts, **geom):
    sch = sched_mod.Scheduler(n_slots=3, pages=_squeezed(sched_mod, cfg,
                                                         **geom))
    for p in prompts:
        sch.submit(p, 20)
    return engine.serve(scheduler=sch)


def test_squeezed_paged_serve_matches_jax(engines):
    """Same stream, same weights, a pool that must preempt, spill and
    restore the recurrent rows: equal counters and equal tokens."""
    jm, jp, jeng, teng = engines
    cfg = teng.model.cfg
    prompts = _prompts(cfg.vocab_size)
    with jax.transfer_guard_device_to_host("disallow"):
        want = _serve(jeng, j_sm, jm.cfg, prompts)
    got = _serve(teng, sm, cfg, prompts)
    for key in COUNTERS:
        assert got.stats[key] == want.stats[key], key
    assert got.stats["preemptions"] >= 1
    assert got.stats["spilled_pages"] >= 1
    assert got.stats["restores"] >= 1
    assert got.stats["host_syncs"] == got.stats["chunks"]
    for rid, prompt in enumerate(prompts):
        _assert_tokens_match(jm, jp, prompt, want.outputs[rid],
                             got.outputs[rid], f"request {rid}")


def test_paged_serve_matches_generate_bit_for_bit(engines):
    """Within the port: the squeezed paged stream (which spills and
    restores rows) and a roomy one emit what one-shot generate emits."""
    teng = engines[3]
    cfg = teng.model.cfg
    toks = np.random.RandomState(8).randint(2, cfg.vocab_size, size=(4, 8))
    want, _ = teng.generate({"tokens": _t(toks, torch.int32)}, n_steps=20)
    prompts = [t.astype(np.int32) for t in toks]
    tight = _serve(teng, sm, cfg, prompts)
    roomy = _serve(teng, sm, cfg, prompts, n_layer0=16)
    assert tight.stats["preemptions"] >= 1
    assert roomy.stats["preemptions"] == 0
    for i in range(4):
        ref_row = want[i].tolist()
        for report in (tight, roomy):
            got = report.outputs[i]
            assert got == ref_row[:len(got)]
            assert len(got) == 20 or got[-1] == teng.ecfg.eos_token


def test_pool_rows_and_seats(engines):
    """Layer 0 holds one recurrent row per slot, layer 1 one seat per spill
    page (``src/repro/serve/pool.py:187-193``)."""
    teng = engines[3]
    cfg = teng.model.cfg
    sch = sm.Scheduler(n_slots=3, pages=_squeezed(sm, cfg))
    pool, spill = teng.pools.init_paged_pool(sch)
    row = pool.state["caches"]["blocks"]["pos0"]
    seat = spill["blocks"]["pos0"]
    assert row["ssm"].shape == (cfg.n_layers, 3, cfg.ssm_d_inner,
                                cfg.ssm_d_state)
    assert seat["conv"].shape == (cfg.n_layers, sch.pages.n_spill_pages,
                                  cfg.ssm_conv - 1, cfg.ssm_d_inner)


def test_launch_serve_falcon_on_cpu(capsys):
    assert cli.main(["--arch", ARCH, "--stream", "4", "--paged", "--batch",
                     "2", "--prompt-len", "8", "--gen-len", "6",
                     "--sync-interval", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "completed 4/4" in out and "falcon-mamba-7b-smoke" in out
    assert cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                     "--gen-len", "4", "--device", "cpu"]) == 0
    assert "gen=4" in capsys.readouterr().out


# --------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_inputs(dev, b, length, di, ds, dtype, seed):
    x, dt, a, bb, c, d = (_t(v).to(dev) for v in _scan_inputs(
        b, length, di, ds, seed))
    return x.to(dtype), dt, a, bb.to(dtype), c.to(dtype), d


@pytest.mark.cuda
@pytest.mark.parametrize("length,chunk,di,ds", SWEEP + [(300, 4, 8192, 16),
                                                         (1, 8, 8192, 16),
                                                         (37, 8, 100, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain_on_card(length, chunk, di, ds,
                                                 dtype):
    dev = _cuda()
    x, dt, a, bb, c, d = _card_inputs(dev, 2, length, di, ds, dtype, 21)
    h0 = torch.randn((2, di, ds), device=dev) * 0.1
    plan = tiling.ScanChunkPlan(chunk)
    before = mamba_scan.launches
    y, h = ops.selective_scan(x, dt, a, bb, c, d, plan=plan, h0=h0,
                              return_state=True)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    wy, wh = ref.selective_scan_ref(x, dt, a, bb, c, d, h0=h0,
                                    return_state=True)
    tol = SCAN_TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(y.float(), wy.float(), **tol)
    torch.testing.assert_close(h, wh, **SCAN_TOL)


@pytest.mark.cuda
def test_mamba_scan_kernel_chunk_invariance_and_split_on_card():
    dev = _cuda()
    x, dt, a, bb, c, d = _card_inputs(dev, 1, 512, 8192, 16,
                                      torch.bfloat16, 22)
    outs = [ops.selective_scan(x, dt, a, bb, c, d,
                               plan=tiling.ScanChunkPlan(ch))
            for ch in (1, 8, 64, 512)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    cut = 200
    y1, h = ops.selective_scan(x[:, :cut], dt[:, :cut], a, bb[:, :cut],
                               c[:, :cut], d, return_state=True,
                               plan=tiling.ScanChunkPlan(8))
    y2, h2 = ops.selective_scan(x[:, cut:], dt[:, cut:], a, bb[:, cut:],
                                c[:, cut:], d, h0=h, return_state=True,
                                plan=tiling.ScanChunkPlan(8))
    full, hf = ops.selective_scan(x, dt, a, bb, c, d, return_state=True,
                                  plan=tiling.ScanChunkPlan(8))
    torch.testing.assert_close(torch.cat([y1, y2], 1).float(), full.float(),
                               **SCAN_TOL)
    torch.testing.assert_close(h2, hf, **SCAN_TOL)


@pytest.mark.cuda
def test_mamba_scan_kernel_refuses_on_card():
    dev = _cuda()
    x, dt, a, bb, c, d = _card_inputs(dev, 1, 64, 256, 16, torch.float32, 23)
    with pytest.raises(ValueError, match="does not divide"):
        from repro_torch.kernels.mamba_scan import mamba_scan as kernel
        kernel(x[:, :60], dt[:, :60], a, bb[:, :60], c[:, :60], d,
               plan=tiling.ScanChunkPlan(16))
    wide = torch.zeros((256, 32), device=dev)
    with pytest.raises(ValueError, match="at most 16 states"):
        ops.selective_scan(x, dt, wide, torch.zeros((1, 64, 32), device=dev),
                           torch.zeros((1, 64, 32), device=dev), d,
                           plan=tiling.ScanChunkPlan(16))
    with use_target("tpu-v5e"), pytest.raises(ValueError,
                                              match="select a GPU target"):
        ops.selective_scan(x, dt, a, bb, c, d)
