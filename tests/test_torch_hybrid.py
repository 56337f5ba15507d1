"""The hybrid jamba-1.5-large-398b served by the port against the JAX
package's engine, on the CPU.

jamba's smoke config (8 layers: GQA at layer 4, mamba at the other seven,
MoE with 4 experts top-2 at the odd layers) with the reference's weights
(its ``Model.init`` through the numpy bridge) serves the dense slot-slab
stream, the paged stream and a squeezed paged stream that must preempt:
the attention layer's pages spill to layer 1 and the mamba layers'
recurrent rows go to their seats, and both come back. Each runs on the
reference's routes (``test_torch_model.RouteReplay``: the reference's
engine serves first and records every MoE call; the port's engine
replays them layer by layer, and the two engines' MoE calls must line up
one to one, in count and in rows). Then

  * the scheduler's counters equal the reference's (chunks, decode steps,
    preemptions, spilled pages, restores, host syncs, the spill tier's
    high water);
  * the tokens are equal, except where a request parts at a step where
    the reference's own teacher-forced top-2 margin is under ``TIE_TOL =
    2e-2`` (``test_torch_serve_modes.py``'s rule; the margin is computed,
    never assumed).

Within the port, on its own routes, bit for bit: the paged stream emits
the dense stream's tokens, the squeezed stream the roomy one's, and each
stream a prefix of one-shot ``Engine.generate``'s rollout. The launcher
serves jamba one-shot, dense and paged on ``--device cpu``. The modes the
reference refuses a model with recurrent state (prefix sharing, chunked
prefill, speculation, int8 / fp8 pages) and host parking are refused in
``test_torch_serve_modes.py::test_falcon_refuses_what_the_reference_refuses``
with jamba beside falcon.

A ``cuda`` case holds paged decode at jamba's widths (group 8) against
its plain version; flash at 64 query heads over 8, ``mamba_scan`` at Di
16384 and ``grouped_gemm`` at 16 experts are cases of the kernels' own
card tests. They skip without a card.
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
from test_torch_model import RouteReplay

torch.set_num_threads(1)
ARCH = "jamba-1.5-large-398b"
TIE_TOL = 2e-2
ECFG = dict(max_len=32, eos_token=1, sync_interval=4)
PT = 8
COUNTERS = ("chunks", "decode_steps", "preemptions", "spilled_pages",
            "restores", "host_syncs", "spill_high_water")
GEN = 20


@pytest.fixture(scope="module")
def jamba():
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


def _pages(sched_mod, cfg, n_layer0=None, n_layer1=12):
    """Three slots over 8-token pages; ``n_layer0`` pages of layer 0 (the
    attention layer's K/V) squeeze the pool until it preempts."""
    page_bytes = sched_mod.kv_bytes_per_token(cfg) * PT
    return sched_mod.derive_page_geometry(
        cfg, ECFG["max_len"], page_tokens=PT, max_slots=3,
        layer0_bytes=None if n_layer0 is None else n_layer0 * page_bytes,
        layer1_bytes=n_layer1 * page_bytes)


def _serve(engine, sched_mod, cfg, prompts, mode):
    """``mode``: dense (the slot slab), paged (a roomy pool) or squeezed
    (six layer-0 pages for three slots)."""
    pages = {"dense": None, "paged": _pages(sched_mod, cfg),
             "squeezed": _pages(sched_mod, cfg, n_layer0=6)}[mode]
    sch = sched_mod.Scheduler(n_slots=3, pages=pages)
    for p in prompts:
        sch.submit(p, GEN)
    return engine.serve(scheduler=sch)


def _assert_tokens_match(jm, jp, prompt, want, got, what):
    """Equal, or parted where the reference's own teacher-forced top-2
    margin is a near-tie (and the port's token is within it)."""
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if t is None:
        assert len(got) == len(want), what
        return
    print(f"{what}: parted at token {t}")
    seq = np.concatenate([prompt, np.asarray(want[:t], np.int32)])[None]
    logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq)}, seq.shape[1])
    row = np.asarray(logits[0, -1, :jm.cfg.vocab_size], np.float64)
    top2 = np.sort(row)[-2:]
    assert top2[1] - top2[0] < TIE_TOL, (what, t, top2)
    assert row[got[t]] >= top2[1] - TIE_TOL, (what, t)


@pytest.mark.parametrize("mode", ["dense", "paged", "squeezed"])
def test_jamba_stream_matches_jax(jamba, mode, monkeypatch):
    """The same stream, weights and routes through both engines: equal
    counters and equal tokens (the near-tie rule). The squeezed stream
    preempts, spills and restores."""
    jm, jp, jeng, teng = jamba
    cfg = teng.model.cfg
    prompts = _prompts(cfg.vocab_size)
    replay = RouteReplay().install(monkeypatch)
    with jax.transfer_guard_device_to_host("disallow"):
        want = _serve(jeng, j_sm, jm.cfg, prompts, mode)
    got = _serve(teng, sm, cfg, prompts, mode)
    replay.drain(f"jamba {mode} stream")
    print(f"jamba {mode} stream: {len(replay.margins)} tokens the port's "
          f"router would route apart, margins up to "
          f"{max(replay.margins, default=0.0):.2e}")
    for key in COUNTERS:
        assert got.stats.get(key) == want.stats.get(key), key
    assert got.stats["host_syncs"] == got.stats["chunks"]
    assert sum(map(len, got.outputs.values())) > 2 * len(prompts)
    if mode == "squeezed":
        assert got.stats["preemptions"] >= 1
        assert got.stats["spilled_pages"] >= 1
        assert got.stats["restores"] >= 1
    for rid, prompt in enumerate(prompts):
        _assert_tokens_match(jm, jp, prompt, want.outputs[rid],
                             got.outputs[rid], f"{mode} request {rid}")


def test_jamba_streams_are_bit_for_bit_within_the_port(jamba):
    """On the port's own routes: the paged stream emits the dense one's
    tokens, the squeezed stream (which spills pages and recurrent rows)
    the roomy one's, and each the rollout of one-shot generate over the
    same four prompts as one batch. The prompts share a length so that
    generate's batch is the stream's: the MoE router's f32 product on the
    CPU is not row-invariant, and another batch can flip a router near-tie
    (a 4-token prompt generated alone parted from its stream at token 11,
    where the two runs' picks were 0.096 apart in a teacher-forced
    prefill)."""
    teng = jamba[3]
    cfg = teng.model.cfg
    toks = np.random.RandomState(8).randint(2, cfg.vocab_size, size=(4, 8))
    want, _ = teng.generate(
        {"tokens": torch.as_tensor(toks, dtype=torch.int32)}, n_steps=GEN)
    prompts = [t.astype(np.int32) for t in toks]
    reps = {mode: _serve(teng, sm, cfg, prompts, mode)
            for mode in ("dense", "paged", "squeezed")}
    assert reps["squeezed"].stats["preemptions"] >= 1
    assert reps["paged"].stats["preemptions"] == 0
    assert reps["paged"].outputs == reps["dense"].outputs
    assert reps["squeezed"].outputs == reps["paged"].outputs
    for rid in range(4):
        got = reps["dense"].outputs[rid]
        assert got == want[rid].tolist()[:len(got)], rid
        assert len(got) == GEN or got[-1] == teng.ecfg.eos_token


@pytest.mark.parametrize("flags", [[], ["--stream", "4"],
                                   ["--stream", "4", "--paged"]],
                         ids=["one-shot", "dense", "paged"])
def test_launch_serve_jamba_on_cpu(capsys, flags):
    assert cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                     "--gen-len", "6", "--sync-interval", "4",
                     "--device", "cpu"] + flags) == 0
    out = capsys.readouterr().out
    assert "jamba-1.5-large-398b-smoke" in out
    assert ("completed 4/4" in out) if flags else ("gen=6" in out)



# --------------------------------------------------------- on the card

@pytest.mark.cuda
def test_paged_decode_at_jamba_widths_on_card():
    """Paged decode with jamba's 8 KV heads at group 8 (64 query heads),
    4 slots over 16-token pages at frontiers across split edges: within
    2e-2 of the plain version, each slot alone bit for bit its row of the
    batch. (Flash at 64 query heads over 8 and ``mamba_scan`` at Di 16384
    are cases of ``test_torch_kernels_ref.py``'s and
    ``test_torch_ssm.py``'s card tests.) Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.paged_attention import (
        paged_flash_decode, paged_flash_decode_plain)
    from test_torch_kernels_ref import _card_pool
    q, kp, vp, bt, cl = _card_pool(4, 256, [64, 129, 1025, 4095], hq=64,
                                   hkv=8, seed=6)
    got = paged_flash_decode(q, kp, vp, bt, cl)
    torch.testing.assert_close(
        got.float(), paged_flash_decode_plain(q, kp, vp, bt, cl).float(),
        atol=2e-2, rtol=2e-2)
    for i in range(4):
        assert torch.equal(paged_flash_decode(q[i:i + 1], kp, vp,
                                              bt[i:i + 1], cl[i:i + 1]),
                           got[i:i + 1]), i
