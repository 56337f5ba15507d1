"""The port's CLI contract and its benchmark runner, on the CPU.

``repro_torch.benchmarks.check_cli.main()`` runs in-process and returns 0:
every script of ``repro_torch.benchmarks`` accepts ``--target``, the
serving benchmark has every flag of the reference's contract plus
``--device`` and ``--full``, and the stream launcher has the serving knobs
the reference's check asks of ``repro.launch.serve``. The runner
``repro_torch.benchmarks.run`` runs its sections (the kernel and serving
benches stubbed here: they have tests of their own), says that the two
roofline sections wait for ROADMAP A14 without counting them as failures,
and exits 1 when a section fails. The stream launcher refuses a mesh of
more than one device, citing ROADMAP A13.
"""

import pytest

from repro_torch.benchmarks import check_cli, kernel_bench, run, serve_bench
from repro_torch.launch import serve as cli


def test_check_cli_passes(capsys):
    assert check_cli.main() == 0
    out = capsys.readouterr().out
    assert "[ok  ] serve_bench.py" in out
    assert "[ok  ] launch/serve.py" in out
    assert "FAIL" not in out


def test_check_cli_names_a_missing_flag(monkeypatch, capsys):
    monkeypatch.setitem(check_cli.EXTRA_FLAGS, "serve_bench.py",
                        ("--no-such-flag",))
    assert check_cli.main() == 1
    assert "--help does not mention --no-such-flag" in capsys.readouterr().out


def test_run_reports_every_section(monkeypatch, capsys):
    monkeypatch.setattr(kernel_bench, "run", lambda *a, **k: "kernel rows")
    monkeypatch.setattr(serve_bench, "run", lambda *a, **k: "serve rows")
    assert run.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for title in ("Table I", "Table II", "Fig. 6", "Figs. 7-9",
                  "kernel rows", "serve rows"):
        assert title in out
    assert "ROADMAP A14" in out and "SECTION FAILED" not in out


def test_run_exits_1_when_a_section_fails(monkeypatch, capsys):
    monkeypatch.setattr(kernel_bench, "run", lambda *a, **k: "kernel rows")

    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(serve_bench, "run", broken)
    assert run.main(["--device", "cpu"]) == 1
    assert "SECTION FAILED: RuntimeError: boom" in capsys.readouterr().out


def test_the_stream_launcher_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="A13"):
        cli.main(["--device", "cpu", "--stream", "2", "--mesh", "2"])
