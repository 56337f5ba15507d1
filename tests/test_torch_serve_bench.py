"""The port's serving benchmark against the reference's, on the CPU: the
mode comparison and the chunked-prefill stall here, the speculative,
disaggregated, tier-codec and falcon head-to-heads in
``test_torch_serve_bench_modes.py``.

``repro_torch.benchmarks.serve_bench`` and ``benchmarks/serve_bench.py``
run the same head-to-heads at ``REDUCED`` qwen2.5-3b with 4 to 6 requests
(``repeats=1``), the port on ``device="cpu"`` with the reference's weights
(its ``Model.init(PRNGKey(0))`` through ``models/bridge.py``):

  * ``run`` (static, continuous, paged and paged+share; and the paged pool
    squeezed until it spills), ``run_chunked`` (baseline, one-shot and
    chunked admission of a 40-token prompt, chunks of 8, with and without
    prefix sharing), ``run_speculate``, ``run_disagg`` and ``run_quant``
    (int8 with ``park_idle``, and fp8);
  * every record the reference saves (read back from
    ``benchmarks/artifacts/`` right after its call) equals the port's in
    every key that is not a wall-clock time: decode steps, host syncs,
    preemptions, spills, restores, prefix hits, COW copies, prefill chunks,
    pages high water, n_slots, n_pages, the step-clock latency
    percentiles, draft counters and the ratios made of them. Tolerance:
    none, they are counts (and ratios of counts);
  * every ``Engine.serve`` call the two make, in order, emits the same
    tokens, except where a request parts at a step whose teacher-forced
    top-2 margin in the reference is under ``TIE_TOL = 2e-2`` (the
    frameworks round bf16 at different places; see
    ``test_torch_serve_modes.py``). A speculative request that parts
    changes every draft after it, so the speculative head-to-head is then
    run again without the parted requests, where tokens and every
    counter must be equal;
  * the four outputs gates hold exactly on the CPU (the port's own runs,
    first against second, in every head-to-head).

Besides: ``--mesh 2`` raises ``NotImplementedError`` citing ROADMAP A13;
``--emit-bench`` writes ``torch_BENCH_10.json`` under the port's
artifacts, which ``tools/diff_bench.py`` reads, and never touches the
repo root's ``BENCH_*.json``; the reference's documented ``--kv-quant
int8 --park-idle 6`` run is refused (a request is stranded in layer 1);
the teacher-forced check passes a greedy rollout and fails a token
forced to the second-best logit at a gap above 0.05; an entry point
without a card raises.
"""

import contextlib
import glob
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.serve import engine as j_engine
from repro_torch.benchmarks import common as t_common
from repro_torch.benchmarks import serve_bench as bench
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import checks
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import Engine, EngineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE_TOL = 2e-2
torch.set_num_threads(1)


def _reference_bench():
    """The reference's ``benchmarks.serve_bench`` (a top-level package of
    the repository root, beside ``src``)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("benchmarks.serve_bench")


@pytest.fixture(scope="module")
def weights():
    """Per arch: (reference model, its params, the same as torch
    tensors)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = j_build_model(j_get_reduced(arch))
            jp = jm.init(jax.random.PRNGKey(0))
            cache[arch] = (jm, jp, params_from_numpy(
                jax.tree.map(np.asarray, jp), "cpu"))
        return cache[arch]

    return get


def _is_timing(key: str) -> bool:
    return (key.endswith(("_s", "_ms")) or "tok_per_s" in key
            or key.startswith(("speedup", "p99_ratio")))


def _assert_same(want, got, where=""):
    """Every non-timing entry of the reference's record equals the
    port's, recursively."""
    if isinstance(want, dict):
        for key, value in want.items():
            if _is_timing(key):
                continue
            assert key in got, f"{where}.{key} missing from the port's record"
            _assert_same(value, got[key], f"{where}.{key}")
    else:
        assert got == want, f"{where}: port {got!r}, reference {want!r}"


@contextlib.contextmanager
def _serves(monkeypatch, module):
    """Record every ``Engine.serve`` report of ``module``, in order."""
    reports = []
    orig = module.Engine.serve

    def serve(self, *args, **kwargs):
        rep = orig(self, *args, **kwargs)
        reports.append(rep)
        return rep

    monkeypatch.setattr(module.Engine, "serve", serve)
    try:
        yield reports
    finally:
        monkeypatch.setattr(module.Engine, "serve", orig)


def _near_tie(jm, jp, prompt, want, got):
    """None if equal, else the step where they part, asserted to be a
    near-tie of the reference's teacher-forced logits."""
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if t is None:
        assert len(got) == len(want)
        return None
    seq = np.concatenate([np.asarray(prompt, np.int32),
                          np.asarray(want[:t], np.int32)])[None]
    logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq)}, seq.shape[1])
    row = np.asarray(logits[0, -1, :jm.cfg.vocab_size], np.float64)
    top2 = np.sort(row)[-2:]
    assert top2[1] - top2[0] < TIE_TOL, (t, top2)
    assert row[got[t]] >= top2[1] - TIE_TOL, t
    return t


def _artifact_roots(monkeypatch, tmp_path):
    """Both packages' benchmark artifacts under ``tmp_path``, so that test
    files running side by side never read each other's records. Returns
    (the reference's root, the port's)."""
    _reference_bench()
    j_common = importlib.import_module("benchmarks.common")
    roots = str(tmp_path / "reference"), str(tmp_path / "port")
    monkeypatch.setattr(j_common, "ARTIFACT_ROOT", roots[0])
    monkeypatch.setattr(t_common, "ARTIFACT_ROOT", roots[1])
    monkeypatch.setattr(bench, "ARTIFACT_ROOT", roots[1])
    return roots


def _head_to_head(monkeypatch, tmp_path, weights, name, artifact, kwargs,
                  arch="qwen2.5-3b"):
    """The reference's ``name`` and the port's at ``kwargs``: returns (the
    reference's artifact, the port's, the rids that parted at near-ties
    in any serve() call)."""
    jm, jp, tp = weights(arch)
    ref = _reference_bench()
    j_root, t_root = _artifact_roots(monkeypatch, tmp_path)
    with _serves(monkeypatch, j_engine) as j_reps:
        getattr(ref, name)(arch=arch, **kwargs)
        with open(os.path.join(j_root, artifact)) as f:
            want = json.load(f)
    with _serves(monkeypatch, t_engine) as t_reps:
        getattr(bench, name)(arch=arch, device="cpu", params=tp, **kwargs)
        with open(os.path.join(t_root, artifact)) as f:
            got = json.load(f)
    assert len(j_reps) == len(t_reps)
    parted = set()
    for jr, tr in zip(j_reps, t_reps):
        assert sorted(jr.outputs) == sorted(tr.outputs)
        for req in jr.requests:
            if _near_tie(jm, jp, req.prompt, jr.outputs[req.rid],
                         tr.outputs[req.rid]) is not None:
                parted.add(req.rid)
    return want, got, parted


RUN_CASES = {
    "share": dict(n_requests=6, prefix_share=True),
    "squeezed": dict(n_requests=6, paged=True, layer0_bytes=24576,
                     require_spill=True),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_records_equal_the_reference(monkeypatch, tmp_path, weights,
                                        case):
    want, got, _ = _head_to_head(monkeypatch, tmp_path, weights, "run",
                                 "serve_bench.json", RUN_CASES[case])
    _assert_same(want, got)
    if case == "share":
        assert got["share_gate"] == {"rule": "exact", "parted": 0,
                                     "worst_gap": 0.0, "passed": True}
        assert got["prefix_share"]["prefix_hits"] >= 1
    else:
        assert got["paged"]["preemptions"] >= 1
    for mode in ("static", "continuous", "paged"):
        rec = got[mode]
        assert rec["completed"] == 6
        assert rec["host_syncs"] == rec["boundaries"]
        assert rec["intertoken_p50_ms"] > 0 and rec["ttft_wall_p50_ms"] > 0


@pytest.mark.parametrize("prefix_share", [False, True],
                         ids=["plain", "share"])
def test_run_chunked_records_equal_the_reference(monkeypatch, tmp_path,
                                                 weights, prefix_share):
    want, got, _ = _head_to_head(
        monkeypatch, tmp_path, weights, "run_chunked",
        "serve_chunked_bench.json",
        dict(n_requests=5, long_prompt_len=40, chunk_prefill_tokens=8,
             repeats=1, prefix_share=prefix_share))
    _assert_same(want, got)
    assert got["chunk_gate"]["rule"] == "exact" and got["chunk_gate"]["passed"]
    runs = got["runs"]
    assert runs["chunked"]["prefill_chunks"] > runs["unchunked"][
        "prefill_chunks"]
    for rec in runs.values():
        assert rec["host_syncs"] == rec["boundaries"]
    assert set(got["phase_s"]) == {"unchunked", "chunked"}


def test_mesh_beyond_one_device_raises():
    with pytest.raises(NotImplementedError, match="A13"):
        bench.main(["--device", "cpu", "--mesh", "2"])
    with pytest.raises(NotImplementedError, match="A13"):
        bench.main(["--device", "cpu", "--mesh", "1x2"])
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--mesh", "two"])


def test_emit_bench_writes_only_under_the_port_artifacts(monkeypatch,
                                                          tmp_path, capsys):
    def root_files():
        out = {}
        for path in glob.glob(os.path.join(ROOT, "BENCH_*.json")):
            with open(path, "rb") as f:
                out[path] = f.read()
        return out

    assert os.path.dirname(bench.__file__) + "/artifacts" == \
        t_common.ARTIFACT_ROOT == bench.ARTIFACT_ROOT
    before = root_files()
    target = os.path.join(_artifact_roots(monkeypatch, tmp_path)[1],
                          bench.BENCH_FILE)
    assert bench.main(["--device", "cpu", "--requests", "4",
                       "--emit-bench"]) == 0
    assert root_files() == before
    assert f"bench metrics -> {target}" in capsys.readouterr().out
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from tools import diff_bench
    metrics = diff_bench.load_metrics(target)
    assert metrics["continuous.completed"] == 4
    assert "speedup_tok_per_s" in metrics
    with open(target) as f:
        payload = json.load(f)
    assert payload["bench_id"] == 10 and payload["schema"] == 1
    assert payload["meta"]["device"] == "cpu"


def test_the_documented_park_run_is_refused():
    """The reference's documented ``--kv-quant int8 --park-idle 6`` run (32
    requests) parks the fp16 run while two requests are preempted into
    layer 1: the port's next serve() refuses them (ROADMAP §C), where the
    reference restores them from zeros."""
    with pytest.raises(ValueError, match=r"requests \[4, 5\] are still "
                                         r"preempted"):
        bench.main(["--device", "cpu", "--kv-quant", "int8", "--park-idle",
                    "6", "--require-residency-win"])


def test_teacher_forced_check_passes_greedy_and_fails_a_forced_token():
    """A greedy rollout is within 0.05 of its own teacher-forced best
    logits (here 0: the same f32 forward); forcing a token to the
    second-best logit where the top-2 gap exceeds 0.05 fails."""
    cfg = get_reduced("qwen2.5-3b")
    model = build_model(cfg, device="cpu")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 EngineConfig(max_len=48, sync_interval=4))
    prompt = np.random.RandomState(3).randint(2, cfg.vocab_size, size=12)
    toks, _ = eng.generate({"tokens": torch.as_tensor(prompt[None])},
                           n_steps=16)
    toks = toks[0].tolist()
    assert checks.teacher_forced_check(cfg, eng.params, prompt, toks,
                                       "greedy") <= checks.LOGIT_TOL
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))[None]
    from repro_torch.models import layers, transformer
    x, _ = transformer.forward(cfg, eng.params, seq)
    logits = layers.unembed_logits(eng.params["tok"], x[0, len(prompt) - 1:])
    top2 = torch.topk(logits[:, :cfg.vocab_size], 2)
    margins = top2.values[:, 0] - top2.values[:, 1]
    t = int(torch.argmax(margins))
    assert margins[t] > checks.LOGIT_TOL
    forced = list(toks)
    forced[t] = int(top2.indices[t, 1])
    gap = checks.teacher_forced_gap(cfg, eng.params, prompt, forced)
    assert gap == pytest.approx(float(margins[t]))
    with pytest.raises(SystemExit, match="below the teacher-forced"):
        checks.teacher_forced_check(cfg, eng.params, prompt, forced, "forced")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(n_requests=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--requests", "2"])
