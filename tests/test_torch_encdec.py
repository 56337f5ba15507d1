"""The encoder-decoder model (``seamless-m4t-medium``) against the JAX
package, on the CPU.

The smoke config (2 encoder + 2 decoder layers, 4 heads over 4, head_dim
16) with the reference's weights through the numpy bridge, and the same
source frames (numpy-seeded, rounded to bf16): the bridge carries the
enc-dec tree (``encoder`` / ``decoder`` stacks, ``enc_norm``,
``final_norm``, ``tok``) key for key and shape for shape; ``encode``'s bf16
output within ``ENC_TOL = 2e-2`` of its largest value (max |d| / max |x|:
2-3 bf16 ulp after the final norm, measured 0.97-1.23e-2 over five seeds,
values up to 3.75); the decoder's prefill logits and 12 teacher-forced
decode steps (cross-attention to the encoder at every step) within
``LOGIT_TOL = 1e-2`` (the 2-layer tolerance of ``test_torch_model.py``;
measured here 7.0e-3), the argmax equal wherever the reference's top-2
margin exceeds 2e-2; ``Engine.generate``'s greedy tokens equal but at the
reference's own near-ties (``TIE_TOL = 2e-2``) and within
``checks.LOGIT_TOL`` of a teacher-forced encoder + decoder pass (the
card's rule); ``encdec_loss`` within 1e-3 relative with equal label
counts. The reference's refusals hold: no
pool, no resumed prefill, no speculative verify, no ``--stream``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.models import encdec as jencdec
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, encdec
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.serve import checks
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.pool import PoolManager

torch.set_num_threads(1)
ARCH = "seamless-m4t-medium"
LOGIT_TOL = 1e-2
MARGIN = 2e-2
TIE_TOL = 2e-2
ENC_TOL = 2e-2
ECFG = dict(max_len=40, eos_token=1, sync_interval=4)


@pytest.fixture(scope="module")
def pair():
    jm = j_build_model(j_get_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(ARCH), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _src(cfg, b, s, seed):
    """Source frames, bf16, the same bits for both packages."""
    x = (np.random.RandomState(seed).randn(b, s, cfg.d_model)
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


def test_bridge_carries_the_encdec_tree(pair):
    """The reference's enc-dec params load by a plain tree map, and the
    port's own init makes the same tree (keys and shapes)."""
    _, jp, tm, tp = pair
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jp))[0]
    flat_b = jax.tree_util.tree_flatten_with_path(params_to_numpy(tp))[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.map(lambda a: a.shape, own) == jax.tree.map(
        lambda a: a.shape, jax.tree.map(np.asarray, jp))
    assert set(own) == {"tok", "encoder", "decoder", "enc_norm",
                        "final_norm"}


def test_encode_matches_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    js, ts = _src(cfg, 2, 11, 1)
    want = jencdec.encode(jm.cfg, jp, js, remat=False)
    got = encdec.encode(cfg, tp, ts)
    assert got.shape == (2, 11, cfg.d_model)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= ENC_TOL, err


def test_prefill_and_decode_match_jax(pair):
    """The decoder's prefill over 9 prompt tokens with 13 source frames,
    then 12 teacher-forced decode steps (0-d cache_len), each reading the
    encoder's output through cross-attention."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(2)
    b, s, steps, max_len = 2, 9, 12, 24
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, b)).astype(np.int32)
    js, ts = _src(cfg, b, 13, 3)
    jl_, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt),
                                  "src_embeds": js}, max_len)
    tl_, tstate = tm.prefill(tp, {"tokens": torch.from_numpy(prompt),
                                  "src_embeds": ts}, max_len)
    assert set(tstate) == {"caches", "enc_out"}
    worst = _check_logits(tl_, jl_, "seamless prefill")
    j_decode = jax.jit(jm.decode_step)
    for i in range(steps):
        jl_, jstate = j_decode(jp, jnp.asarray(forced[i])[:, None], jstate,
                               jnp.asarray(s + i, jnp.int32))
        tl_, tstate = tm.decode_step(
            tp, torch.from_numpy(forced[i])[:, None], tstate,
            torch.tensor(s + i, dtype=torch.int32))
        worst = max(worst, _check_logits(tl_, jl_,
                                         f"seamless decode step {i}"))
    print(f"seamless prefill + decode: max |dlogit| {worst:.3e}")


def test_generate_tokens_match_jax(pair):
    """One-shot ``Engine.generate``: equal greedy tokens, but where the
    reference's own teacher-forced top-2 margin at the parting step is
    under TIE_TOL."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(4)
    b, s, n = 3, 7, 16
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    js, ts = _src(cfg, b, 10, 5)
    want, _ = JEngine(jm, jp, JEngineConfig(**ECFG)).generate(
        {"tokens": jnp.asarray(prompt), "src_embeds": js}, n)
    teng = Engine(tm, tp, EngineConfig(**ECFG))
    got, _ = teng.generate({"tokens": torch.from_numpy(prompt),
                            "src_embeds": ts}, n)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (b, n)
    for r in range(b):      # the card's rule: one encoder + decoder pass
        assert checks.teacher_forced_gap(
            cfg, teng.params, prompt[r], got[r],
            src_embeds=ts[r:r + 1]) <= checks.LOGIT_TOL
    for r in range(b):
        t = next((i for i in range(n) if want[r, i] != got[r, i]), None)
        if t is None:
            continue
        seq = np.concatenate([prompt[r], want[r, :t]])[None].astype(np.int32)
        logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq),
                                    "src_embeds": js[r:r + 1]},
                               seq.shape[1])
        row = np.asarray(logits[0, -1, :cfg.vocab_size], np.float64)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] < TIE_TOL, (r, t, top2)
        assert row[got[r, t]] >= top2[1] - TIE_TOL, (r, t)


def test_encdec_loss_matches_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.RandomState(6)
    toks = rng.randint(2, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    js, ts = _src(cfg, 2, 12, 7)
    jtot, jd = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels),
                            "src_embeds": js})
    ttot, td = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels),
                            "src_embeds": ts})
    np.testing.assert_allclose(float(td["loss"]), float(jd["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-3)
    assert float(td["aux"]) == float(jd["aux"]) == 0.0
    assert float(td["tokens"]) == float(jd["tokens"]) == 2 * 15


def test_encdec_serves_one_shot_only(pair, capsys):
    """As in the reference: both pools, resumed prefill and speculative
    verify refuse an enc-dec model, and ``--stream`` is an argument error;
    the one-shot CLI serves it."""
    _, _, tm, tp = pair
    cfg = tm.cfg
    pools = PoolManager(tm, EngineConfig(**ECFG))
    with pytest.raises(NotImplementedError, match="encdec"):
        pools.init_pool(2)
    geom = sm.derive_page_geometry(cfg, 40, page_tokens=8, max_slots=2)
    with pytest.raises(NotImplementedError, match="one-shot"):
        pools.init_paged_pool(sm.Scheduler(n_slots=2, pages=geom))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    _, ts = _src(cfg, 1, 5, 8)
    with pytest.raises(NotImplementedError, match="resumed prefill"):
        tm.prefill(tp, {"tokens": toks, "src_embeds": ts}, 16, prefix_len=4)
    with pytest.raises(NotImplementedError, match="verify"):
        tm.verify_step(tp, toks, {"caches": {}},
                       torch.zeros((1,), dtype=torch.int32))
    for extra in (["--stream", "2"], ["--stream", "2", "--paged"]):
        with pytest.raises(SystemExit):
            cli.run(["--arch", ARCH, "--device", "cpu"] + extra)
        assert "one-shot mode" in capsys.readouterr().err
    rec = cli.run(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                   "--prompt-len", "6", "--gen-len", "5"])
    assert rec["tokens"].shape == (2, 5)
