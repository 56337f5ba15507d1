"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so one file takes seconds, not
minutes), for ``sm_90a``. Libraries are cached under ``_build/`` beside
this module by a hash of their source and flags, so a checkout builds each
kernel once. Nothing here runs at import: :func:`library` builds on first
use, and :func:`build_all` starts every nvcc at once and waits for all.

A failed build raises with nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: the C interface of every library: function -> (restype, argtypes).
#: Pointers and the stream are c_void_p, so none is cut to 32 bits.
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "flash_attention": {
        "flash_attention_bf16": (_I, [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F]
                                 + [_I] * 4 + [_P]),
        "flash_attention_head_dim": (_I, []),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "paged_attention": {
        "paged_decode_bf16": (_I, [_P] * 6 + [_I] * 5 + [_L] * 2 + [_F]
                              + [_I] * 2 + [_P]),
        "paged_attention_head_dim": (_I, []),
        "paged_attention_max_group": (_I, []),
        "paged_attention_max_page_tokens": (_I, []),
        "paged_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "matmul3d": {
        "matmul3d_f32": (_I, [_P] * 3 + [_I] * 8 + [_P]),
        "matmul3d_bf16": (_I, [_P] * 3 + [_I] * 8 + [_P]),
        "matmul3d_error_string": (ctypes.c_char_p, [_I]),
    },
    "mamba_scan": {
        "mamba_scan": (_I, [_P] * 9 + [_I] * 6 + [_P]),
        "mamba_scan_error_string": (ctypes.c_char_p, [_I]),
    },
}
SOURCES = tuple(SIGNATURES)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's kernels build from source")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of ``name``; empty when the library came from the cache."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn_name, (restype, argtypes) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build every missing library in parallel (one nvcc per source) and
    load all of them. Raises with nvcc's stderr if any build fails."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs: List = []
        for name in SOURCES:
            out = _target(name)
            if name in _LIBS or out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((name, out, tmp, proc))
        failures = []
        for name, out, tmp, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {name}.cu "
                                f"(rc {proc.returncode}):\n{stderr}{stdout}")
                continue
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
        for name in SOURCES:
            if name not in _LIBS:
                _LIBS[name] = _load(name)
        return dict(_LIBS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(name: str, rc: int) -> None:
    """Raise if the launcher of library ``name`` returned a CUDA error (its
    ``cudaGetLastError`` after the launch), with CUDA's message."""
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
