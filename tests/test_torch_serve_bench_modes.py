"""The port's speculative, disaggregated and tier-codec head-to-heads
(``run_speculate``, ``run_disagg``, ``run_quant``) and falcon-mamba-7b's
``run`` against the reference's, on the CPU, by the rules of
``test_torch_serve_bench.py`` (its helpers and fixture): every non-timing
entry of the saved records equal, tokens equal but at measured near-ties
(``TIE_TOL = 2e-2``), a parted speculative request held out of a second
run on which the draft counters must be equal too, and the outputs gates
exact on the CPU. falcon-mamba-7b refuses prefix sharing, chunking,
speculation and the codecs with the reference's exceptions.
``repro_torch.benchmarks.spec_gate`` reports the speculative gate under
both verify paths (both the oracle on the CPU: exact).
"""

import pytest

from repro.serve import scheduler as j_sm
from repro_torch.benchmarks import common as t_common
from repro_torch.benchmarks import serve_bench as bench
from repro_torch.benchmarks import spec_gate

from test_torch_serve_bench import (_assert_same, _head_to_head,  # noqa: F401
                                    _reference_bench, weights)


def test_run_speculate_records_equal_the_reference(monkeypatch, tmp_path,
                                                   weights):
    kwargs = dict(n_requests=5)
    want, got, parted = _head_to_head(
        monkeypatch, tmp_path, weights, "run_speculate",
        "serve_speculate.json", kwargs)
    if parted:
        # a parted request's drafts differ from its first parting on: hold
        # every counter on the requests that did not part
        stream = j_sm.repetitive_stream(5, 48, 32, 512, 0)
        keep = [s for rid, s in enumerate(stream) if rid not in parted]
        monkeypatch.setattr(j_sm, "repetitive_stream", lambda *a, **k: keep)
        monkeypatch.setattr(bench, "repetitive_stream", lambda *a, **k: keep)
        want, got, parted = _head_to_head(monkeypatch, tmp_path, weights,
                                          "run_speculate",
                                          "serve_speculate.json", kwargs)
        assert not parted
    _assert_same(want, got)
    assert got["speculate"]["spec_proposed"] > 0
    assert got["speculate_gate"]["passed"]
    assert got["speculate"]["host_syncs"] == got["speculate"]["boundaries"]


def test_run_disagg_records_equal_the_reference(monkeypatch, tmp_path,
                                                weights):
    want, got, _ = _head_to_head(
        monkeypatch, tmp_path, weights, "run_disagg",
        "serve_disagg_bench.json",
        dict(n_requests=6, long_prompt_len=40, chunk_prefill_tokens=8))
    _assert_same(want, got)
    dis = got["disaggregated"]
    assert dis["handovers"] == got["n_requests"]
    assert all(n <= dis["boundaries"]
               for n in dis["host_syncs_by_role"].values())


@pytest.mark.parametrize("kv_quant,park_idle", [("int8", 4), ("fp8", 0)],
                         ids=["int8-park", "fp8"])
def test_run_quant_records_equal_the_reference(monkeypatch, tmp_path,
                                               weights,
                                               kv_quant, park_idle):
    want, got, _ = _head_to_head(
        monkeypatch, tmp_path, weights, "run_quant", "serve_quant_bench.json",
        dict(n_requests=6, kv_quant=kv_quant, park_idle=park_idle))
    _assert_same(want, got)
    assert (got["quant"]["parks"] > 0) == bool(park_idle)
    for key in ("base", "quant"):
        assert got[key]["host_syncs"] == got[key]["boundaries"]


def test_falcon_runs_and_refuses_as_the_reference_does(monkeypatch,
                                                       tmp_path, weights):
    """falcon-mamba-7b (attention-free) serves the mode comparison through
    mamba_scan with the reference's records, and refuses prefix sharing,
    chunking, speculation and the codecs with the reference's
    exceptions."""
    want, got, _ = _head_to_head(
        monkeypatch, tmp_path, weights, "run", "serve_bench.json",
        dict(n_requests=4), arch="falcon-mamba-7b")
    _assert_same(want, got)
    ref = _reference_bench()
    _, _, tp = weights("falcon-mamba-7b")
    arch = "falcon-mamba-7b"
    for name, kwargs in (("run", dict(prefix_share=True)),
                         ("run_chunked", dict(long_prompt_len=16,
                                              chunk_prefill_tokens=8,
                                              repeats=1)),
                         ("run_speculate", {}),
                         ("run_quant", dict(kv_quant="int8"))):
        with pytest.raises(ValueError) as j_err:
            getattr(ref, name)(arch=arch, n_requests=2, **kwargs)
        with pytest.raises(ValueError) as t_err:
            getattr(bench, name)(arch=arch, n_requests=2, device="cpu",
                                 params=tp, **kwargs)
        assert str(t_err.value).split(":")[0] == \
            str(j_err.value).split(":")[0], name


def test_spec_gate_reports_both_verify_paths(monkeypatch, tmp_path):
    """``spec_gate`` runs the speculative head-to-head with the verify
    forward on gather + oracle and on the port's path; on the CPU both are
    the oracle, so both gates are exact and pass."""
    monkeypatch.setattr(t_common, "ARTIFACT_ROOT", str(tmp_path))
    out = spec_gate.run(n_requests=3, device="cpu")
    for label in ("gather + oracle", "port"):
        assert f"== verify attention: {label} ==" in out
    assert out.count("'rule': 'exact', 'parted': 0, 'worst_gap': 0.0, "
                     "'passed': True") == 2
