"""The port's paged serving engine against the JAX package's, on the CPU.

Both engines serve the same prompts on the ``qwen2.5-3b`` smoke config with
the same weights (the reference's ``Model.init`` through the numpy bridge)
over a deliberately tight two-tier pool, so the deterministic scheduler
preempts, spills and restores. Their host-side counters must be equal. Their
token streams must be equal too, except that a request may part ways at a
step where the reference's own teacher-forced top-2 margin is under
``TIE_TOL``: the two frameworks round bf16 at different places (see
``test_torch_model.py``), so a near-tie may break either way. The test
computes that margin; it never skips a divergence.

Within the port the equalities are bit for bit: a paged stream emits what
one-shot ``Engine.generate`` emits for the same prompts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.serve import scheduler as j_sm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as cli
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig

torch.set_num_threads(1)
ARCH = "qwen2.5-3b"
TIE_TOL = 2e-2
ECFG = dict(max_len=32, eos_token=1, sync_interval=4)
COUNTERS = ("preemptions", "spilled_pages", "restores", "chunks",
            "decode_steps", "host_syncs", "spill_high_water")


def _tight_geometry(sched, cfg, max_len=32, page_tokens=8, n_layer0=6,
                    n_layer1=8):
    """``tests/test_paged.py``'s pool: six layer-0 pages of 8 tokens for
    three slots, so a stream of 20-token budgets has to preempt."""
    pb = sched.kv_bytes_per_token(cfg) * page_tokens
    return sched.derive_page_geometry(
        cfg, max_len, page_tokens=page_tokens, max_slots=3,
        layer0_bytes=pb * n_layer0, layer1_bytes=pb * n_layer1)


@pytest.fixture(scope="module")
def engines():
    """(reference model, its params, reference engine, port engine)."""
    jm = j_build_model(j_get_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(ARCH), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jm, jp, JEngine(jm, jp, JEngineConfig(**ECFG)),
            Engine(tm, tp, EngineConfig(**ECFG)))


def _prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=n).astype(np.int32)
            for n in (6, 9, 4, 7)]


def _serve(engine, sched_mod, cfg, prompts, budget=20):
    sch = sched_mod.Scheduler(n_slots=3, pages=_tight_geometry(sched_mod, cfg))
    for p in prompts:
        sch.submit(p, budget)
    return engine.serve(scheduler=sch)


def _first_divergence(want, got):
    return next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                None)


def test_paged_serve_matches_jax(engines):
    """Same stream, same weights, tight pool: equal counters, and token
    streams equal up to the reference's own near-ties."""
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
    assert got.stats["admissions"] == len(prompts)
    for rid, prompt in enumerate(prompts):
        w, g = want.outputs[rid], got.outputs[rid]
        assert len(g) == len(w) == 20
        t = _first_divergence(w, g)
        if t is None:
            continue
        # the reference's teacher-forced logits at the step where the
        # streams part: it must itself be a near-tie there
        seq = np.concatenate([prompt, np.asarray(w[:t], np.int32)])[None]
        logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq)},
                               seq.shape[1])
        row = np.asarray(logits[0, -1, :cfg.vocab_size], np.float64)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] < TIE_TOL, (rid, t, top2)
        assert row[g[t]] >= top2[1] - TIE_TOL, (rid, t)


def test_paged_serve_matches_generate_bit_for_bit(engines):
    """Within the port: paged continuous batching emits exactly what
    one-shot generate emits (port of
    ``tests/test_paged.py::test_paged_matches_one_shot_generate``)."""
    teng = engines[3]
    cfg = teng.model.cfg
    toks = np.random.RandomState(7).randint(2, cfg.vocab_size, size=(3, 8))
    want, _ = teng.generate({"tokens": torch.as_tensor(toks,
                                                       dtype=torch.int32)},
                            n_steps=7)
    assert teng.last_stats["host_syncs"] <= 2
    sch = sm.Scheduler(n_slots=3, pages=_tight_geometry(sm, cfg))
    for i in range(3):
        sch.submit(toks[i].astype(np.int32), 7)
    report = teng.serve(scheduler=sch)
    assert report.stats["host_syncs"] == report.stats["chunks"]
    for i in range(3):
        ref = want[i].tolist()
        got = report.outputs[i]
        assert got == ref[:len(got)]
        assert len(got) == 7 or got[-1] == teng.ecfg.eos_token


def test_paged_serve_with_preemption_matches_no_preemption(engines):
    """Preempt -> spill -> restore resumes bit-exactly: the tight pool and
    a roomy pool emit the same tokens."""
    teng = engines[3]
    cfg = teng.model.cfg
    prompts = _prompts(cfg.vocab_size, seed=5)
    tight = _serve(teng, sm, cfg, prompts)
    roomy_sch = sm.Scheduler(n_slots=3, pages=_tight_geometry(
        sm, cfg, n_layer0=16))
    for p in prompts:
        roomy_sch.submit(p, 20)
    roomy = teng.serve(scheduler=roomy_sch)
    assert tight.stats["preemptions"] >= 1
    assert roomy.stats["preemptions"] == 0
    assert tight.outputs == roomy.outputs


def test_serve_without_pages_is_not_ported(engines):
    teng = engines[3]
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        teng.serve([], scheduler=sm.Scheduler(n_slots=2))


def test_launch_serve_main_on_cpu(capsys):
    """The CLI's paged stream and one-shot modes run end to end on the
    CPU when asked to."""
    assert cli.main(["--stream", "4", "--paged", "--batch", "2",
                     "--prompt-len", "8", "--gen-len", "6",
                     "--sync-interval", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "completed 4/4" in out and "device=cpu" in out
    assert cli.main(["--batch", "2", "--prompt-len", "8", "--gen-len", "4",
                     "--device", "cpu"]) == 0
    assert "gen=4" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--stream", "4", "--device", "cpu"])   # dense stream: A4
