"""The port's multi-head latent attention (MLA) against the JAX package's,
on the CPU.

Two configs: the reference's equivalence-matrix ``TINY_MLA``
(``tests/test_equivalence_matrix.py``; no q-LoRA) and deepseek-v2's
``REDUCED`` (q-LoRA 48, latent 32, rope 8, MoE after a dense first layer).
Weights come from the reference's ``init_mla`` / ``Model.init`` through the
numpy bridge; activations are numpy-seeded bf16. Tolerances:

* one MLA layer (bf16 out): atol = rtol = 1.6e-2, 1-2 bf16 ulp, as the
  layers of ``test_torch_model.py`` — prefill with no cache and into a
  dense slab (decompress + attention), the absorbed latent-space decode at
  a 0-d and at a per-slot offset, and the per-slot verify chunk (k + 1
  rows a slot); the latent the slab holds afterwards at the same
  tolerance;
* whole models over the paged latent pool at fp16, int8 and fp8: one
  decode step and one verify forward after each framework's own prefill
  and page cut, f32 logits within ``LOGIT_TOL = 1e-2`` (quantized pools:
  the same, since both frameworks quantize the same way and the rows they
  quantize differ by bf16 ulps); routes of deepseek's MoE layers are held
  by ``test_torch_model.py``'s rule;
* the row moves bit for bit: the same prefilled row cut into the pool
  (``slot_update_paged``) and read back (``gather_row_paged``) by both
  frameworks gives the same page bytes and scales and the same bf16 view,
  at every codec (the reference run eagerly, as in
  ``test_torch_kv_quant.py``);
* served streams of ``TINY_MLA`` over an int8 and an fp8 latent pool (the
  counterpart of ``tests/test_kv_quant.py::test_mla_serves_quantized``):
  every request completes, the scheduler counters equal the reference's,
  and the tokens too, but where the reference's own teacher-forced top-2
  margin is a near-tie (``TIE_TOL = 2e-2``);
* deepseek-v2's smoke config on a tight latent pool that preempts, at
  fp16, int8 and fp8 (spilled through the int8 tier): counters equal the
  reference's; at fp16 and int8 the tokens equal a roomy pool's, bit for
  bit (same-codec tier copies move codes and scales verbatim).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models.config import LayerKind as JLayerKind
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import scheduler as j_sm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.kernels.paged_attention import FP8, as_bits
from repro_torch.models import attention, build_model, transformer
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig

from test_torch_model import routing  # noqa: F401
from test_torch_serve_modes import _assert_tokens_match

torch.set_num_threads(1)
BF16_TOL = 1.6e-2
LOGIT_TOL = 1e-2
MAX_LEN, PT = 64, 8

_TINY_MLA = dict(name="tiny-eq-mla", family="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                 vocab_size=128, use_mla=True, kv_lora_rank=16,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
CONFIGS = {
    "tiny-eq-mla": (ModelConfig(**_TINY_MLA), JModelConfig(**_TINY_MLA)),
    "deepseek-v2-236b": (get_reduced("deepseek-v2-236b"),
                         j_get_reduced("deepseek-v2-236b")),
}
CODECS = {"fp16": (torch.bfloat16, jnp.bfloat16, False),
          "int8": (torch.int8, jnp.int8, True),
          "fp8": (FP8, jnp.float8_e4m3fn, False)}
KIND, JKIND = LayerKind(attn="mla"), JLayerKind(attn="mla")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _tb(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16)


def _close(got, want, tol=BF16_TOL):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------ layer

@pytest.fixture(scope="module", params=sorted(CONFIGS))
def layer(request):
    """(port cfg, reference cfg, reference layer params, port params)."""
    tcfg, jcfg = CONFIGS[request.param]
    jp = jattn.init_mla(jcfg, jax.random.PRNGKey(7))
    return tcfg, jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _positions(b, s, start):
    start = np.broadcast_to(np.asarray(start, np.int32).reshape(-1, 1), (b, 1))
    return (start + np.arange(s, dtype=np.int32)[None]).astype(np.int32)


def _prefill_both(tcfg, jcfg, jp, tp, x, depth):
    """Each framework's MLA prefill of ``x`` into its own dense slab."""
    b, s, _ = x.shape
    pos = _positions(b, s, 0)
    jcache = jattn.init_mla_cache(jcfg, b, depth)
    jy, jcache = jattn.mla_attention(jp, jnp.asarray(x, jnp.bfloat16),
                                     cfg=jcfg, kind=JKIND,
                                     positions=jnp.asarray(pos),
                                     cache=jcache, cache_len=0)
    tcache = attention.init_mla_cache(tcfg, b, depth, "cpu")
    ty, _ = attention.mla_attention(tp, _tb(x), cfg=tcfg, kind=KIND,
                                    positions=torch.from_numpy(pos),
                                    cache=tcache, cache_len=0)
    return jy, jcache, ty, tcache


def test_prefill_matches_jax(layer):
    """No cache (the loss forward) and into a dense slab over its whole
    depth (the serving prefill): decompress + attention."""
    tcfg, jcfg, jp, tp = layer
    x = _bf16((2, 9, tcfg.d_model), 1)
    pos = _positions(2, 9, 0)
    jy, _ = jattn.mla_attention(jp, jnp.asarray(x, jnp.bfloat16), cfg=jcfg,
                                kind=JKIND, positions=jnp.asarray(pos))
    ty, _ = attention.mla_attention(tp, _tb(x), cfg=tcfg, kind=KIND,
                                    positions=torch.from_numpy(pos))
    _close(ty, jy)
    jy, jcache, ty, tcache = _prefill_both(tcfg, jcfg, jp, tp, x, 24)
    _close(ty, jy)
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("offsets", ["scalar", "per-slot", "verify"])
def test_absorbed_decode_matches_jax(layer, offsets):
    """After a 9-token prefill, one decode step at a 0-d offset (the
    one-shot path), one at per-slot offsets (the stream), and a 3-row
    verify chunk at per-slot offsets: all take the latent-space branch."""
    tcfg, jcfg, jp, tp = layer
    b, depth = 2, 24
    _, jcache, _, tcache = _prefill_both(tcfg, jcfg, jp, tp,
                                         _bf16((b, 9, tcfg.d_model), 2),
                                         depth)
    s = 3 if offsets == "verify" else 1
    lens = np.asarray([9, 9] if offsets == "scalar" else [9, 5], np.int32)
    x = _bf16((b, s, tcfg.d_model), 3)
    pos = _positions(b, s, lens)
    j_len = jnp.asarray(9, jnp.int32) if offsets == "scalar" \
        else jnp.asarray(lens)
    t_len = torch.tensor(9, dtype=torch.int32) if offsets == "scalar" \
        else torch.from_numpy(lens)
    jy, jcache = jattn.mla_attention(jp, jnp.asarray(x, jnp.bfloat16),
                                     cfg=jcfg, kind=JKIND,
                                     positions=jnp.asarray(pos),
                                     cache=jcache, cache_len=j_len)
    ty, tcache = attention.mla_attention(tp, _tb(x), cfg=tcfg, kind=KIND,
                                         positions=torch.from_numpy(pos),
                                         cache=tcache, cache_len=t_len)
    _close(ty, jy)
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name])


# ------------------------------------------------------ pools and codecs

@pytest.fixture(scope="module")
def models():
    """Per config: (reference model, its params, port model, port params)."""
    out = {}
    for name, (tcfg, jcfg) in CONFIGS.items():
        jm = j_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(tcfg, device="cpu")
        out[name] = (jm, jp, tm,
                     params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _pools(tm, jm, codec, n_pages, batch=2):
    import repro.models.transformer as jt
    tdt, jdt, scaled = CODECS[codec]
    tpool = {"caches": transformer.init_paged_caches(
        tm.cfg, batch, n_pages, PT, "cpu", dtype=tdt, quant_scales=scaled)}
    jpool = {"caches": jt.init_paged_caches(
        jm.cfg, batch, n_pages, PT, dtype=jdt, quant_scales=scaled)}
    return tpool, jpool


def _check_logits(got, want, what, skip_rows=()):
    keep = [r for r in range(got.shape[0]) if r not in skip_rows]
    err = np.abs(got.numpy()[keep] - np.asarray(want)[keep]).max() \
        if keep else 0.0
    assert err <= LOGIT_TOL, f"{what}: max |dlogit| {err:.3e}"


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_latent_pool_matches_jax(models, name, codec, routing):
    """Two prompts prefilled one at a time and cut into a shuffled latent
    pool at the codec, then a decode step and a 3-column verify forward
    over the pool with per-slot frontiers."""
    jm, jp, tm, tp = models[name]
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    p_max, n_pages = 4, 10
    depth = PT * p_max
    lens = [5, 11]
    bt = np.asarray([[3, 7, 1, 9], [2, 8, 5, 4]], np.int32)
    tpool, jpool = _pools(tm, jm, codec, n_pages)
    parted = set()
    for slot, n in enumerate(lens):
        prompt = rng.randint(2, cfg.vocab_size, size=(1, n)).astype(np.int32)
        last = np.asarray([n - 1], np.int32)
        _, jrow = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, depth,
                             last_pos=jnp.asarray(last))
        _, trow = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, depth,
                             last_pos=torch.from_numpy(last))
        if routing(1, f"{name} {codec} admission {slot}"):
            parted.add(slot)
        jpool = jm.slot_update_paged(jpool, jrow, jnp.asarray(slot),
                                     jnp.asarray(bt[slot]), PT)
        tpool = tm.slot_update_paged(tpool, trow, slot,
                                     torch.from_numpy(bt[slot]), PT)
    cl = np.asarray(lens, np.int32)
    toks = rng.randint(2, cfg.vocab_size, size=(2, 3)).astype(np.int32)
    jl_, jpool = jm.decode_step(jp, jnp.asarray(toks[:, :1]), jpool,
                                jnp.asarray(cl), block_tables=jnp.asarray(bt))
    tl_, tpool = tm.decode_step(tp, torch.from_numpy(toks[:, :1]), tpool,
                                torch.from_numpy(cl),
                                block_tables=torch.from_numpy(bt))
    what = f"{name} {codec} paged decode"
    _check_logits(tl_, jl_, what, parted | routing(2, what))
    cl = cl + 1
    jl_, _ = jm.verify_step(jp, jnp.asarray(toks), jpool, jnp.asarray(cl),
                            block_tables=jnp.asarray(bt))
    tl_, _ = tm.verify_step(tp, torch.from_numpy(toks), tpool,
                            torch.from_numpy(cl),
                            block_tables=torch.from_numpy(bt))
    what = f"{name} {codec} paged verify"
    _check_logits(tl_, jl_, what, parted | routing(2, what))


def _j(t):
    """A port tensor as a reference array with the same bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype == FP8:
        return jnp.asarray(as_bits(t).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _bits(x):
    if torch.is_tensor(x):
        return as_bits(x).contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_row_moves_equal_the_reference(models, codec):
    """The same prefilled row (the port's) cut into the latent pool and
    gathered back by both frameworks: equal page bytes, scales and bf16
    views, bit for bit."""
    jm, _, tm, tp = models["tiny-eq-mla"]
    rng = np.random.RandomState(4)
    prompt = rng.randint(2, 128, size=(1, 13)).astype(np.int32)
    _, trow = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, PT * 4)
    jrow = jax.tree.map(_j, trow)
    block = np.asarray([6, 2, 9, 0], np.int32)
    tpool, jpool = _pools(tm, jm, codec, 10, batch=1)
    with jax.disable_jit():
        jpool = jm.slot_update_paged(jpool, jrow, jnp.asarray(0),
                                     jnp.asarray(block), PT)
        jback = jm.gather_row_paged(jpool, jnp.asarray(block), PT)
    tm.slot_update_paged(tpool, trow, 0, torch.from_numpy(block), PT)
    tback = tm.gather_row_paged(tpool, torch.from_numpy(block), PT)
    for g in tpool["caches"]:
        for key, leaf in tpool["caches"][g].items():
            for name, t in leaf.items():
                assert _bits(t) == _bits(jpool["caches"][g][key][name]), \
                    (codec, g, key, name)
            for name, t in tback["caches"][g][key].items():
                assert t.shape == jback["caches"][g][key][name].shape
                assert _bits(t) == _bits(jback["caches"][g][key][name]), \
                    (codec, g, key, name)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_latent_stream_matches_the_reference(models, kv_quant):
    """``TINY_MLA`` served over an int8 / fp8 latent pool by both engines:
    every request completes; counters equal; tokens equal but at the
    reference's near-ties."""
    jm, jp, tm, tp = models["tiny-eq-mla"]
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(2, 128, size=n).astype(np.int32), 8)
            for n in (15, 21, 11)]
    reps = []
    for eng, mod, cfg in ((JEngine(jm, jp, JEngineConfig(max_len=MAX_LEN,
                                                          sync_interval=4)),
                           j_sm, jm.cfg),
                          (Engine(tm, tp, EngineConfig(max_len=MAX_LEN,
                                                       sync_interval=4)),
                           sm, tm.cfg)):
        geom = mod.derive_page_geometry(cfg, MAX_LEN, page_tokens=PT,
                                        max_slots=3, layer0_bytes=128 * 1024,
                                        layer1_bytes=256 * 1024,
                                        kv_quant=kv_quant)
        sch = mod.Scheduler(3, pages=geom)
        rids = [sch.submit(p, g).rid for p, g in reqs]
        rep = eng.serve(scheduler=sch)
        reps.append(([rep.outputs[r] for r in rids], rep.stats))
    (want, jst), (got, tst) = reps
    assert all(len(o) == 8 for o in got)
    assert tst["layer0_codec"] == jst["layer0_codec"] == kv_quant
    for key in ("chunks", "decode_steps", "host_syncs", "n_pages",
                "pages_high_water", "preemptions"):
        assert tst[key] == jst[key], key
    for (prompt, _), w, g in zip(reqs, want, got):
        _assert_tokens_match(jm, jp, prompt, w, g, kv_quant)


def _latent_geometry(mod, cfg, kv_quant, n_layer0):
    """A two-tier latent pool of ``n_layer0`` fp16 pages' bytes of 8-token
    pages for three slots; a 1-byte codec packs about twice the pages
    into them."""
    pb = mod.kv_bytes_per_token(cfg) * PT
    return mod.derive_page_geometry(cfg, 32, page_tokens=PT, max_slots=3,
                                    layer0_bytes=pb * n_layer0,
                                    layer1_bytes=pb * 8, kv_quant=kv_quant)


@pytest.mark.parametrize("kv_quant", ["fp16", "int8", "fp8"])
def test_latent_pool_spills_and_restores(models, kv_quant):
    """deepseek-v2's smoke config (MLA + MoE) on a tight latent pool that
    preempts: every latent page spills to layer 1 and comes back (fp8
    pages through the int8 spill tier: the cross-codec re-encode). The
    scheduler counters equal the reference's on the same geometry; at
    fp16 and int8 (same-codec copies, bit for bit) the tokens equal a
    roomy pool's that never spilled."""
    jm, jp, tm, tp = models["deepseek-v2-236b"]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(2, tm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 9, 4, 7)]
    ecfg = dict(max_len=32, sync_interval=4)
    codec = None if kv_quant == "fp16" else kv_quant
    tight_pages = 6 if codec is None else 3       # ~6 pages either way
    reps = {}
    for name, eng, mod, cfg, n_layer0 in (
            ("ref", JEngine(jm, jp, JEngineConfig(**ecfg)), j_sm, jm.cfg,
             tight_pages),
            ("tight", Engine(tm, tp, EngineConfig(**ecfg)), sm, tm.cfg,
             tight_pages),
            ("roomy", Engine(tm, tp, EngineConfig(**ecfg)), sm, tm.cfg, 16)):
        sch = mod.Scheduler(3, pages=_latent_geometry(mod, cfg, codec,
                                                      n_layer0))
        rids = [sch.submit(p, 20).rid for p in prompts]
        rep = eng.serve(scheduler=sch)
        reps[name] = ([rep.outputs[r] for r in rids], rep.stats)
    (_, want), (tight, got), (roomy, roomy_st) = (reps["ref"], reps["tight"],
                                                  reps["roomy"])
    assert got["preemptions"] >= 1 and got["restores"] >= 1
    assert roomy_st["preemptions"] == 0
    assert got["layer0_codec"] == want["layer0_codec"] == kv_quant
    for key in ("preemptions", "spilled_pages", "restores", "chunks",
                "decode_steps", "host_syncs", "layer1_codec"):
        assert got[key] == want[key], key
    assert all(len(o) == 20 for o in tight)
    if kv_quant != "fp8":
        assert tight == roomy
