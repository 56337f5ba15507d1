"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

``repro_torch`` must import on a machine without JAX (the GPU machine has
none), so every module is imported in a subprocess where ``import jax``
fails, and every source file is scanned for imports of ``jax`` or
``repro``. Nor may it lean on the reference's serialization packages
(``msgpack``, ``zstandard``, ``ml_dtypes``), which the GPU machine lacks
too: every source file and ``chip_smoke.py`` are scanned for them, and a
park blob round-trips in a subprocess where they fail to import. Entry points run on the card unless the caller asks for the
CPU (the launcher, the serving benchmark and the benchmark runner among
them): without a card they raise, and so does a kernel wrapper handed a
tensor that is neither on the CPU nor on a CUDA card.
"""

import ast
import ctypes
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import build
from repro_torch.core.tiling import ScanChunkPlan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.launch import serve as cli
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FILES = sorted(PORT.rglob("*.py"))


def _module(path: pathlib.Path) -> str:
    parts = path.relative_to(SRC).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = [_module(p) for p in FILES]


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'jaxlib', 'repro.'))]\n"
        "assert bad == ['jax'], bad\n"
        "assert sys.modules['jax'] is None\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_the_serving_modes_are_among_the_checked_modules():
    """The speculative proposer and fold are copies of a JAX-importing
    reference module: they must be the port's own, and checked above."""
    assert "repro_torch.serve.speculate" in MODULES
    from repro_torch.serve import speculate
    assert speculate.propose_ngram.__module__ == "repro_torch.serve.speculate"
    assert speculate.fold_acceptance.__module__ == \
        "repro_torch.serve.speculate"


@pytest.mark.parametrize("path", FILES, ids=MODULES)
def test_no_module_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


#: the reference's park / checkpoint packages, absent on the GPU machine
CODEC_PACKAGES = ("msgpack", "zstandard", "ml_dtypes")


@pytest.mark.parametrize("path", FILES + [ROOT / "chip_smoke.py"],
                         ids=MODULES + ["chip_smoke"])
def test_no_module_imports_the_reference_codec_packages(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in CODEC_PACKAGES + ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_park_round_trips_with_the_codec_packages_blocked():
    """A bf16, fp8, int8 and f32 park blob packs and unpacks bit for bit
    where ``msgpack``, ``zstandard``, ``ml_dtypes`` and ``jax`` cannot be
    imported."""
    code = (
        "import sys\n"
        f"for name in {CODEC_PACKAGES + ('jax',)!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from repro_torch.serve import park\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = torch.randn(3, 5, 7, generator=g)\n"
        "arrays = {'pages/a/k': x.to(torch.bfloat16),\n"
        "          'pages/a/v': x.to(torch.float8_e4m3fn),\n"
        "          'pages/a/k_scale': x[0, 0],\n"
        "          'rows/c': (x * 9).to(torch.int8)}\n"
        "meta, back = park.unpack_parked(park.pack_parked({'t': [1]}, "
        "arrays))\n"
        "assert meta == {'t': [1]} and set(back) == set(arrays)\n"
        "for k, t in arrays.items():\n"
        "    b = back[k]\n"
        "    assert b.dtype == t.dtype and b.shape == t.shape, k\n"
        "    assert torch.equal(b.view(torch.uint8), t.view(torch.uint8)), k\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{CODEC_PACKAGES!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card and no explicit CPU: the model, the engine's model and the
    CLI raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--prompt-len", "4", "--gen-len", "2"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_the_sharding_modules_are_among_the_checked_modules():
    """``distributed/``, ``launch/mesh.py`` and the training examples are
    the port's own (the reference's import JAX) and checked above; the
    rank side of the distributed tests, which spawned ranks import, takes
    nothing but ``repro_torch`` and plain libraries either."""
    for name in ("distributed", "distributed.sharding",
                 "distributed.collectives", "launch.mesh",
                 "examples.quickstart", "examples.elastic_restart"):
        assert f"repro_torch.{name}" in MODULES
    tree = ast.parse((ROOT / "tests" / "torch_dist_ranks.py").read_text())
    tops = {(a.name if isinstance(node, ast.Import) else node.module)
            .split(".")[0] for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in getattr(node, "names", [])}
    assert tops <= {"os", "numpy", "torch", "repro_torch"}, tops


def test_the_tensor_parallel_modules_are_among_the_checked_modules():
    """Sharded serving's ``distributed/tensor_parallel.py`` is checked
    above, and the rank side of its tests, which spawned ranks import,
    takes nothing but ``repro_torch`` and plain libraries."""
    assert "repro_torch.distributed.tensor_parallel" in MODULES
    tree = ast.parse((ROOT / "tests" / "torch_tp_ranks.py").read_text())
    tops = {(a.name if isinstance(node, ast.Import) else node.module)
            .split(".")[0] for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in getattr(node, "names", [])}
    assert tops <= {"os", "numpy", "torch", "repro_torch"}, tops


def test_the_expert_parallel_rank_side_takes_no_jax():
    """The rank side of the expert-parallel serving tests, which spawned
    ranks import, takes nothing but ``repro_torch``, plain libraries and
    the tensor-parallel tests' rank side (checked above)."""
    tree = ast.parse((ROOT / "tests" / "torch_ep_ranks.py").read_text())
    tops = {(a.name if isinstance(node, ast.Import) else node.module)
            .split(".")[0] for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in getattr(node, "names", [])}
    assert tops <= {"dataclasses", "os", "numpy", "torch", "repro_torch",
                    "torch_tp_ranks"}, tops


def test_the_mla_rank_side_takes_no_jax():
    """The rank side of the sharded MLA serving tests, which spawned ranks
    import, takes nothing but ``repro_torch``, plain libraries and the
    tensor-parallel tests' rank side (checked above)."""
    tree = ast.parse((ROOT / "tests" / "torch_mla_ranks.py").read_text())
    tops = {(a.name if isinstance(node, ast.Import) else node.module)
            .split(".")[0] for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in getattr(node, "names", [])}
    assert tops <= {"os", "pickle", "time", "numpy", "torch", "repro_torch",
                    "torch_tp_ranks"}, tops


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """The training CLI at any mesh and both training examples raise
    without a card unless given ``--device cpu``."""
    from repro_torch.examples import elastic_restart, quickstart
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train.main, quickstart.main, elastic_restart.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mesh", "1x2"])


def test_the_benchmark_scripts_are_among_the_checked_modules():
    for name in ("serve_bench", "check_cli", "run"):
        assert f"repro_torch.benchmarks.{name}" in MODULES


def test_benchmark_entry_points_raise_without_a_card(monkeypatch, tmp_path,
                                                    capsys):
    """Without a card the serving benchmark and the benchmark runner
    raise unless given ``--device cpu``."""
    from repro_torch.benchmarks import common, run, serve_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "ARTIFACT_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--requests", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([])
    assert serve_bench.main(["--device", "cpu", "--requests", "2"]) == 0
    assert "(tpu-v5e, cpu)" in capsys.readouterr().out


def test_wrappers_refuse_other_devices():
    """A wrapper computes its plain version only for a CPU tensor; any
    other device is refused before a build is attempted."""
    q = torch.empty((1, 4, 3, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 2, 16, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, kv, kv)
    pages = torch.empty((5, 2, 16, 128), dtype=torch.bfloat16, device="meta")
    bt = torch.empty((1, 2), dtype=torch.int32, device="meta")
    cl = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_flash_decode(q[:, :, :1], pages, pages, bt, cl)
    x = torch.empty((1, 8, 32), device="meta")
    a = torch.empty((32, 16), device="meta")
    bc = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mamba_scan(x, x, a, bc, bc, a[:, 0], plan=ScanChunkPlan(8))


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "const void*": ctypes.c_void_p,
            "void*": ctypes.c_void_p, "const char*": ctypes.c_char_p}


@pytest.mark.parametrize("lib", build.SOURCES)
def test_ctypes_signatures_match_the_cuda_sources(lib):
    """Without a compiler here, hold the ctypes declarations against the
    ``extern "C"`` functions of each source: same names, same return
    type, same parameter types in order."""
    text = (build.CSRC / f"{lib}.cu").read_text()
    extern = text[text.index('extern "C" {'):]
    found = {}
    for ret, name, params in re.findall(
            r"^(int|const char\*) (\w+)\(([^)]*)\)", extern, re.M):
        types = []
        for p in filter(None, (p.strip() for p in params.split(","))):
            ctype = " ".join(p.split()[:-1]).replace(" *", "*")
            types.append(_C_TYPES[ctype])
        found[name] = (_C_TYPES[ret], types)
    declared = {name: (restype, list(argtypes))
                for name, (restype, argtypes)
                in build.SIGNATURES[lib].items()}
    assert declared == found


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernels build from source with nvcc; without one the build
    raises (there is no fallback and no prebuilt library)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("paged_attention")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_build_key_follows_included_headers(monkeypatch, tmp_path):
    """A library is keyed on its source, every csrc header it includes
    (transitively) and the flags: editing a shared header changes the key
    of each source that includes it, and a source that includes no header
    keys on its bytes and the flags alone, as before headers existed."""
    import hashlib
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("constexpr int X = 1;\n")
    (csrc / "uses.cu").write_text('#include <cuda.h>\n#include "shared.cuh"\n')
    (csrc / "plain.cu").write_text("#include <cuda_runtime.h>\nint f();\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    assert [p.name for p in build._sources("uses")] == [
        "uses.cu", "shared.cuh", "inner.cuh"]
    uses, plain = build._target("uses"), build._target("plain")
    digest = hashlib.sha256((csrc / "plain.cu").read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    assert plain.name == f"libplain-{digest.hexdigest()[:16]}.so"
    (csrc / "inner.cuh").write_text("constexpr int X = 2;\n")
    assert build._target("uses") != uses
    assert build._target("plain") == plain
    assert build._target("uses").parent == tmp_path / "_build"
