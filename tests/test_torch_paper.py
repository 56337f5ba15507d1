"""The port's paper artifacts against the JAX package, on the CPU.

The calibrated models are copies, so their numbers must be equal exactly
(no tolerance): ``perf_model``, ``energy``, ``area_model``,
``mempool_tile_size`` and ``configs.mempool_mm``. The port's table and
figure scripts must print what the reference's print, and the port's
``mempool_matmul`` launcher must print the reference example's section 1
unchanged. Every port bench CLI lists ``--target``; the kernel bench's row
builder runs at small shapes on the CPU (plain versions, max |d| = 0
exactly, since both sides are the same plain function), and a row whose
kernel disagrees with its plain version past the bench's limit (matmul f32
2e-4 of max|plain|, attention bf16 atol = rtol = 2e-2) raises.
"""

import contextlib
import dataclasses
import importlib
import io
import os
import runpy
import sys

import pytest
import torch

from repro.configs import mempool_mm as j_mm
from repro.core import area_model as j_area
from repro.core import energy as j_energy
from repro.core import perf_model as j_perf
from repro.core import tiling as j_tiling
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.benchmarks import kernel_bench
from repro_torch.configs import mempool_mm
from repro_torch.core import area_model, energy, perf_model, tiling
from repro_torch.launch import mempool_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 2 ** 20
PAPER_SCRIPTS = ("table1_tile", "table2_group", "fig6_bandwidth",
                 "fig789_energy")
torch.set_num_threads(1)


def _reference_bench(name):
    """The reference's ``benchmarks.<name>`` (a top-level package of the
    repository root, beside ``src``)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(f"benchmarks.{name}")


# --------------------------------------------------------- models, exact

@pytest.mark.parametrize("mib", [1, 2, 4, 8])
@pytest.mark.parametrize("word_bytes", [2, 4])
def test_mempool_tile_size_equals_reference(mib, word_bytes):
    assert tiling.mempool_tile_size(mib * MiB, word_bytes) == \
        j_tiling.mempool_tile_size(mib * MiB, word_bytes)


@pytest.mark.parametrize("mib", [1, 2, 4, 8])
def test_perf_model_equals_reference(mib):
    for bw in perf_model.PAPER_BANDWIDTHS:
        got = perf_model.matmul_cycles(spm_bytes=mib * MiB,
                                       bw_bytes_per_cycle=bw)
        want = j_perf.matmul_cycles(spm_bytes=mib * MiB,
                                    bw_bytes_per_cycle=bw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.total == want.total
        assert perf_model.speedup_vs_baseline(mib * MiB, bw) == \
            j_perf.speedup_vs_baseline(mib * MiB, bw)
    assert perf_model.fig6_table() == j_perf.fig6_table()
    assert (perf_model.PAPER_M, perf_model.CYC_PER_MAC,
            perf_model.STATIC_OVERHEAD) == (j_perf.PAPER_M, j_perf.CYC_PER_MAC,
                                            j_perf.STATIC_OVERHEAD)


@pytest.mark.parametrize("flow", ["2D", "3D"])
@pytest.mark.parametrize("mib", [1, 2, 4, 8])
def test_energy_derive_equals_reference(flow, mib):
    for bw in (4, 16, 64):
        got = energy.derive(flow, mib, bw_bytes_per_cycle=bw)
        want = j_energy.derive(flow, mib, bw_bytes_per_cycle=bw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_energy_tables_equal_reference():
    got, want = energy.derive_all(), j_energy.derive_all()
    assert got.keys() == want.keys()
    for name in got:
        assert dataclasses.astuple(got[name]) == \
            dataclasses.astuple(want[name])
    assert energy.pdp_table() == j_energy.pdp_table()


def test_area_model_equals_reference():
    assert area_model.table1() == j_area.table1()
    assert area_model.PAPER_TABLE1 == j_area.PAPER_TABLE1
    assert (area_model.SRAM_PERIPHERY_AREA, area_model.SRAM_AREA_PER_BYTE,
            area_model.ICACHE_AREA) == (j_area.SRAM_PERIPHERY_AREA,
                                        j_area.SRAM_AREA_PER_BYTE,
                                        j_area.ICACHE_AREA)
    for flow in ("2D", "3D"):
        for mib in (1, 2, 4, 8):
            assert dataclasses.astuple(area_model.partition_tile(
                flow, mib * MiB)) == dataclasses.astuple(
                    j_area.partition_tile(flow, mib * MiB))


def test_mempool_mm_config_equals_reference():
    assert dataclasses.astuple(mempool_mm.CONFIG) == \
        dataclasses.astuple(j_mm.CONFIG)


def test_core_exports_the_paper_models():
    from repro_torch import core
    for name in ("matmul_cycles", "fig6_table", "speedup_vs_baseline",
                 "derive", "derive_all", "pdp_table", "partition_tile",
                 "table1"):
        assert callable(getattr(core, name))


# ------------------------------------------------------------ the CLIs

@pytest.mark.parametrize("name", PAPER_SCRIPTS)
def test_paper_script_prints_what_the_reference_prints(name):
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    assert port.run() == _reference_bench(name).run()


def _section(text, number):
    start = text.index(f"\n{number}. ")
    end = text.index(f"\n{number + 1}. ") if f"\n{number + 1}. " in text \
        else len(text)
    return text[start:end]


def test_mempool_matmul_section1_equals_reference(monkeypatch, capsys):
    """The reference example with its Pallas call swapped for its jnp
    oracle (same numbers, no interpret-mode minutes), beside the port's
    launcher on the CPU."""
    ns = runpy.run_path(os.path.join(ROOT, "examples", "mempool_matmul.py"),
                        run_name="reference_example")
    monkeypatch.setattr(j_ops, "matmul", lambda a, b, plan, impl:
                        j_ref.matmul_ref(a, b))
    assert ns["main"]() == 0
    reference = capsys.readouterr().out
    rec = mempool_matmul.run(["--device", "cpu"])
    port = capsys.readouterr().out
    assert _section(port, 1) == _section(reference, 1)
    assert len(rec["sweep"]) == 8
    for row in rec["sweep"]:
        assert row["m"] == mempool_matmul.M_CPU
        assert row["max_abs_err"] == 0.0 and row["ms"] is None
    assert "not timed" in _section(port, 2)
    assert "tpu-v5e (vmem" in port and "h100 (smem" in port


def test_mempool_matmul_needs_the_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mempool_matmul.run([])


@pytest.mark.parametrize("module", [
    *(f"repro_torch.benchmarks.{n}" for n in PAPER_SCRIPTS),
    "repro_torch.benchmarks.kernel_bench",
    "repro_torch.launch.mempool_matmul"])
def test_cli_help_lists_target(module):
    main = importlib.import_module(module).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "--target" in buf.getvalue()


def test_kernel_bench_rows_on_cpu_at_small_shapes():
    shapes = dict(matmul=[(96, 64, 200)], attention=[(1, 2, 64, 128)],
                  scan=[(1, 16, 32, 4)])
    text = kernel_bench.run("h100", "cpu", shapes)
    lines = text.splitlines()
    assert "h100" in lines[0] and "not timed" in lines[0]
    assert len(lines) == 3 + 3
    assert "matmul3d" in lines[3] and "flash_attention" in lines[4]
    assert kernel_bench.SCAN_LABEL in lines[5]
    row = kernel_bench.matmul_row(kernel_bench.get_target("h100"), 96, 64,
                                  200, torch.device("cpu"))
    assert row["max_abs_err"] == 0.0 and row["ms"] is None
    assert row["plan"] == [96, 32, 192]
    assert row["roofline_ms"] > 0


@pytest.mark.parametrize("kind,scale,raises", [
    ("matmul", 1e-2, True), ("matmul", 1e-5, False),
    ("attention", 1e-1, True), ("attention", 1e-2, False),
    ("scan", 1e-3, True), ("scan", 1e-5, False)])
def test_kernel_bench_rows_hold_the_kernel_to_its_limit(monkeypatch, kind,
                                                        scale, raises):
    """A stand-in kernel off by ``scale`` (of max|plain| for matmul, in
    absolute terms for attention and the scan) in one element fails its
    row past the limit and passes within it."""
    def off(fn):
        def wrong(*args, **kw):
            out = fn(*args, **kw).clone()
            out.view(-1)[7] += scale * (out.abs().max() if kind == "matmul"
                                        else 1.0)
            return out
        return wrong

    name = {"matmul": "matmul", "attention": "attention",
            "scan": "selective_scan"}[kind]
    monkeypatch.setattr(kernel_bench.ops, name,
                        off(getattr(kernel_bench.ops, name)))
    target, cpu = kernel_bench.get_target("h100"), torch.device("cpu")
    build = {
        "matmul": lambda: kernel_bench.matmul_row(target, 96, 64, 200, cpu),
        "attention": lambda: kernel_bench.attention_row(target, 1, 2, 64,
                                                        128, cpu),
        "scan": lambda: kernel_bench.scan_row(target, 1, 16, 32, 4, cpu),
    }[kind]
    if raises:
        with pytest.raises(RuntimeError, match="beyond"):
            build()
    else:
        assert build()["max_abs_err"] > 0


def test_kernel_bench_refuses_tpu_targets():
    with pytest.raises(ValueError, match="needs a GPU target"):
        kernel_bench.run("tpu-v5e", "cpu", dict(matmul=[], attention=[],
                                                scan=[]))
