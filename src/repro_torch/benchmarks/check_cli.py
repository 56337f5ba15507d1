"""CLI contract check: every runnable script of ``repro_torch.benchmarks``
accepts ``--target``, the port's serving benchmark exposes every flag of
the reference's (``benchmarks/check_cli.py``'s ``EXTRA_FLAGS``) plus
``--device`` and ``--full``, and the port's stream launcher
``repro_torch.launch.serve`` exposes the serving knobs the reference's
check asks of ``repro.launch.serve``. Runs each script's ``--help``
in-process and greps the usage text.

    PYTHONPATH=src python -m repro_torch.benchmarks.check_cli
"""

from __future__ import annotations

import contextlib
import glob
import io
import os
import runpy
import sys

#: library modules, not CLI entry points
NON_CLI = {"common.py", "check_cli.py", "__init__.py"}

#: per-script extra required flags, beyond the universal --target: the
#: reference's contract, plus the port's device and width flags
EXTRA_FLAGS = {
    "serve_bench.py": ("--paged", "--page-tokens", "--layer0-bytes",
                       "--layer1-bytes", "--require-spill", "--prefix-share",
                       "--system-len", "--require-share-win",
                       "--chunked-prefill", "--chunk-prefill-tokens",
                       "--long-prompt-len", "--sync-interval",
                       "--require-flat-p99", "--flat-p99-tol", "--repeats",
                       "--speculate", "--speculate-tokens",
                       "--require-speculate-win", "--mesh", "--mesh-axes",
                       "--require-scaling", "--disaggregate",
                       "--require-disagg-win", "--disagg-win-min",
                       "--kv-quant", "--park-idle",
                       "--require-residency-win", "--emit-bench",
                       "--device", "--full"),
}

#: non-benchmark CLI entry points checked for specific flags only (no
#: --target requirement): (path relative to src/repro_torch, flags)
EXTRA_CLIS = (
    (os.path.join("launch", "serve.py"),
     ("--chunk-prefill-tokens", "--paged", "--prefix-share",
      "--speculate-tokens", "--mesh", "--mesh-axes", "--disaggregate",
      "--kv-quant", "--park-idle")),
)


def check(path: str, flags=("--target",)) -> str:
    """Returns '' if ok, else a failure reason."""
    argv, sys.argv = sys.argv, [path, "--help"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            runpy.run_path(path, run_name="__main__")
        return "no argparse --help (script ran to completion)"
    except SystemExit as e:
        if e.code not in (0, None):
            return f"--help exited {e.code}: {buf.getvalue()[-200:]}"
    except Exception as e:   # noqa: BLE001 — report, don't crash the sweep
        return f"{type(e).__name__}: {e}"
    finally:
        sys.argv = argv
    missing = [flag for flag in flags if flag not in buf.getvalue()]
    if missing:
        return f"--help does not mention {', '.join(missing)}"
    return ""


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    failures = []

    def run_check(path, label, flags):
        reason = check(path, flags)
        status = "FAIL" if reason else "ok"
        print(f"[{status:4s}] {label}" + (f" — {reason}" if reason else ""))
        if reason:
            failures.append(label)

    for path in sorted(glob.glob(os.path.join(root, "*.py"))):
        name = os.path.basename(path)
        if name in NON_CLI:
            continue
        run_check(path, name,
                  ("--target",) + EXTRA_FLAGS.get(name, ()))
    package = os.path.dirname(root)
    for rel, flags in EXTRA_CLIS:
        run_check(os.path.join(package, rel), rel, flags)
    if failures:
        print(f"\n{len(failures)} CLI(s) missing contracted flags: "
              f"{', '.join(failures)}")
        return 1
    print("\nall CLIs expose their contracted flags")
    return 0


if __name__ == "__main__":
    sys.exit(main())
