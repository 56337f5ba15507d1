"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

``repro_torch`` must import on a machine without JAX (the GPU machine has
none), so every module is imported in a subprocess where ``import jax``
fails, and every source file is scanned for imports of ``jax`` or
``repro``. Entry points run on the card unless the caller asks for the
CPU: without a card they raise, and so does a kernel wrapper handed a
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
