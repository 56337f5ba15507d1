"""The port's serving demo (``repro_torch.examples.serve_demo``, the
counterpart of ``examples/serve_demo.py``) runs end to end on the CPU.

No tolerance: it checks what the demo reports. One-shot decode of every
family it spans (dense GQA, MLA + MoE, pure SSM, enc-dec) gives tokens of
the expected shape inside the vocabulary; the continuous, paged and
prefix-shared streams drain every request with one host sync a chunk; the
paged pool holds more slots than the dense one in the same layer-0
bytes; prefix sharing hits and leaves the outputs equal; without a card
and without ``--device cpu`` the demo raises.
"""

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.examples import serve_demo

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def report():
    return serve_demo.run(["--device", "cpu"])


def test_one_shot_spans_the_families(report, capsys):
    archs = [r["arch"] for r in report["one_shot"]]
    assert archs == list(serve_demo.ONE_SHOT_ARCHS)
    assert {get_reduced(a).family for a in archs} == {"dense", "moe", "ssm",
                                                      "encdec"}
    for r in report["one_shot"]:
        toks = r["tokens"]
        assert toks.shape == (2, 8)
        assert 0 <= int(toks.min()) and int(toks.max()) < get_reduced(
            r["arch"]).vocab_size
        assert r["state_mib"] > 0


def test_streams_drain_with_one_sync_a_chunk(report):
    for name in ("continuous", "paged", "prefix_share"):
        s = report[name]
        assert s["drained"] == 12, name
        assert s["host_syncs"] == s["chunks"], name
    assert report["paged"]["n_slots"] > 3
    share = report["prefix_share"]
    assert share["prefix_hits"] > 0 and share["outputs_equal"]
    assert share["mapped_high_water"] > share["pages_high_water"]


def test_demo_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_demo.run([])
