"""M-RoPE and the vision-frontend stub (``qwen2-vl-2b``) against the JAX
package, on the CPU.

``apply_mrope`` is held to the reference's with three *different* position
streams (temporal, height, width), at the smoke config's sections (2, 3,
3) and the published (16, 24, 24): on the served path the three streams
are one position broadcast three times, where M-RoPE equals RoPE and the
section split goes unchecked. In f32 both compute the same angles, so they
agree within 2e-5 (the frameworks' cos / sin of angles up to 5e3 rad); in
bf16 within ``BF16_RTOL = 1.6e-2`` (1-2 bf16 ulp, as the layer tests of
``test_torch_model.py``).

``qwen2-vl-2b``'s smoke config (2 layers, head_dim 16, 8 frontend
positions) serves with the same stub embeddings (numpy-seeded, rounded to
bf16) and the reference's weights through the numpy bridge: prefill logits
and 12 teacher-forced dense decode steps within ``LOGIT_TOL = 1e-2`` (the
2-layer tolerance of ``test_torch_model.py``; measured here 6.1e-3),
the argmax equal wherever the reference's top-2 margin exceeds 2e-2;
``Engine.generate``'s greedy tokens equal but at the reference's own
near-ties (``TIE_TOL = 2e-2``, ``test_torch_serve.py``'s rule) and within
``checks.LOGIT_TOL`` of a teacher-forced forward that takes the frontend
(the card's rule); and ``Model.loss`` within 1e-3 relative with equal
label counts. The reference's refusals hold: no pool, no resumed prefill,
no speculative verify, no ``--stream``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.models import layers as jl
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, layers
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.frontends import fake_frontend
from repro_torch.serve import checks
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.pool import PoolManager

torch.set_num_threads(1)
ARCH = "qwen2-vl-2b"
LOGIT_TOL = 1e-2
MARGIN = 2e-2
TIE_TOL = 2e-2
BF16_RTOL = 1.6e-2
ECFG = dict(max_len=48, eos_token=1, sync_interval=4)


@pytest.fixture(scope="module")
def pair():
    jm = j_build_model(j_get_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(ARCH), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _frontend(cfg, b, seed):
    """Stub patch embeddings, bf16, the same bits for both packages."""
    x = (np.random.RandomState(seed).randn(b, cfg.frontend_len, cfg.d_model)
         * 0.02).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _check_logits(got, want, what):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL, f"{what}: max |dlogit| {err:.3e}"
    flat_j, flat_t = want.reshape(-1, want.shape[-1]), got.reshape(
        -1, got.shape[-1])
    top2 = np.sort(flat_j, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > MARGIN
    assert (flat_t.argmax(-1) == flat_j.argmax(-1))[decided].all(), what
    return err


# ------------------------------------------------------------------ M-RoPE

@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax_with_distinct_streams(sections, hd):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 7, hd).astype(np.float32)
    pos3 = np.stack([rng.randint(0, 40, (2, 7)), rng.randint(0, 600, (2, 7)),
                     rng.randint(0, 5000, (2, 7))]).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos3}) == 3   # three streams
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # each section follows its own stream: not RoPE on any one of them
    for p in pos3:
        rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(p),
                                 1e6)
        assert not torch.allclose(rope, got, atol=1e-3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_b = jl.apply_mrope(xb, jnp.asarray(pos3), 1e6, sections)
    got_b = layers.apply_mrope(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(pos3), 1e6, sections)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(want_b.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


def test_mrope_of_one_stream_is_rope_and_sections_must_fit():
    """The served path's three equal streams: M-RoPE is RoPE bit for bit.
    Sections that do not sum to head_dim / 2 raise."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 4, 5, 16).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 900, (2, 5)).astype(np.int32))
    got = layers.apply_mrope(x, pos[None].expand(3, 2, 5), 1e6, (2, 3, 3))
    assert torch.equal(got, layers.apply_rope(x, pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(x, pos[None].expand(3, 2, 5), 1e6, (2, 3, 4))


def test_fake_frontend_shape_and_scale():
    cfg = get_reduced(ARCH)
    x = fake_frontend(cfg, 3, torch.Generator().manual_seed(0))
    assert x.shape == (3, cfg.frontend_len, cfg.d_model)
    assert x.dtype == torch.bfloat16
    assert 0.01 < float(x.float().std()) < 0.04
    assert fake_frontend(cfg, 2, torch.Generator().manual_seed(0),
                         length=5).shape == (2, 5, cfg.d_model)


# ----------------------------------------------------------- whole model

def test_prefill_and_dense_decode_match_jax(pair):
    """Prefill over 8 frontend + 9 text positions, then 12 teacher-forced
    decode steps at frontier ``Sf + S + i`` over the dense slab."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(2)
    b, s, steps, max_len = 2, 9, 12, 40
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, b)).astype(np.int32)
    jf, tf = _frontend(cfg, b, 3)
    jl_, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt),
                                  "frontend_embeds": jf}, max_len)
    tl_, tstate = tm.prefill(tp, {"tokens": torch.from_numpy(prompt),
                                  "frontend_embeds": tf}, max_len)
    worst = _check_logits(tl_, jl_, "qwen2-vl prefill")
    j_decode = jax.jit(jm.decode_step)
    start = cfg.frontend_len + s
    for i in range(steps):
        jl_, jstate = j_decode(jp, jnp.asarray(forced[i])[:, None], jstate,
                               jnp.asarray(start + i, jnp.int32))
        tl_, tstate = tm.decode_step(
            tp, torch.from_numpy(forced[i])[:, None], tstate,
            torch.tensor(start + i, dtype=torch.int32))
        worst = max(worst, _check_logits(
            tl_, jl_, f"qwen2-vl dense decode step {i}"))
    print(f"qwen2-vl prefill + decode: max |dlogit| {worst:.3e}")


def test_generate_tokens_match_jax(pair):
    """One-shot ``Engine.generate`` with the same stub embeddings: equal
    greedy tokens, but where the reference's own teacher-forced top-2
    margin at the parting step is under TIE_TOL; the cache frontier counts
    the frontend positions (the engine's ``prompt_len + frontend_len``)."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(4)
    b, s, n = 3, 7, 16
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    jf, tf = _frontend(cfg, b, 5)
    want, _ = JEngine(jm, jp, JEngineConfig(**ECFG)).generate(
        {"tokens": jnp.asarray(prompt), "frontend_embeds": jf}, n)
    teng = Engine(tm, tp, EngineConfig(**ECFG))
    got, _ = teng.generate({"tokens": torch.from_numpy(prompt),
                            "frontend_embeds": tf}, n)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (b, n)
    assert teng.last_stats["host_syncs"] >= 1
    for r in range(b):      # the card's rule: one forward, frontend first
        assert checks.teacher_forced_gap(
            cfg, teng.params, prompt[r], got[r],
            frontend_embeds=tf[r:r + 1]) <= checks.LOGIT_TOL
    for r in range(b):
        t = next((i for i in range(n) if want[r, i] != got[r, i]), None)
        if t is None:
            continue
        seq = np.concatenate([prompt[r], want[r, :t]])[None].astype(np.int32)
        logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq),
                                    "frontend_embeds": jf[r:r + 1]},
                               seq.shape[1] + cfg.frontend_len)
        row = np.asarray(logits[0, -1, :cfg.vocab_size], np.float64)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] < TIE_TOL, (r, t, top2)
        assert row[got[r, t]] >= top2[1] - TIE_TOL, (r, t)


def test_loss_matches_jax(pair):
    """``Model.loss`` with frontend embeddings: the frontend positions carry
    no label; loss within 1e-3 relative, the same label count."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(6)
    toks = rng.randint(2, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jf, tf = _frontend(cfg, 2, 7)
    jtot, jd = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels),
                            "frontend_embeds": jf})
    ttot, td = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels),
                            "frontend_embeds": tf})
    np.testing.assert_allclose(float(td["loss"]), float(jd["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-3)
    assert float(td["tokens"]) == float(jd["tokens"]) == 2 * 15


# ---------------------------------------------------------------- refusals

def test_frontend_model_serves_one_shot_only(pair, capsys):
    """As in the reference: both pools, resumed prefill and speculative
    verify refuse a frontend model, and ``--stream`` is an argument
    error; the one-shot CLI serves it."""
    _, _, tm, tp = pair
    cfg = tm.cfg
    pools = PoolManager(tm, EngineConfig(**ECFG))
    with pytest.raises(NotImplementedError, match="one-shot"):
        pools.init_pool(2)
    geom = sm.derive_page_geometry(cfg, 48, page_tokens=8, max_slots=2)
    with pytest.raises(NotImplementedError, match="one-shot"):
        pools.init_paged_pool(sm.Scheduler(n_slots=2, pages=geom))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="resumed prefill"):
        tm.prefill(tp, {"tokens": toks}, 32, prefix_len=4)
    with pytest.raises(NotImplementedError, match="verify"):
        tm.verify_step(tp, toks, {"caches": {}},
                       torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(SystemExit):
        cli.run(["--arch", ARCH, "--stream", "2", "--device", "cpu"])
    assert "one-shot mode" in capsys.readouterr().err
    rec = cli.run(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                   "--prompt-len", "6", "--gen-len", "5"])
    assert rec["tokens"].shape == (2, 5)
