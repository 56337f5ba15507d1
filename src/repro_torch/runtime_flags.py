"""Process-level lowering flags (read dynamically, set by the dry-run).

REPRO_COST_MODE=1 switches the model to a *cost-accurate* lowering: every
`lax.scan` is fully unrolled (XLA's HloCostAnalysis counts while bodies once,
not x trip-count) and blockwise attention uses capped trip counts. Used for
the roofline's FLOPs/bytes/collective measurements; the default (rolled)
lowering is used for memory analysis, where while-body buffers are counted
correctly and HLO size stays flat in depth.
"""

from __future__ import annotations

import os


def cost_mode() -> bool:
    return os.environ.get("REPRO_COST_MODE") == "1"


def scan_unroll(length: int) -> int:
    return length if cost_mode() else 1


def cost_attn_block() -> int:
    return int(os.environ.get("REPRO_COST_ATTN_BLOCK", "8192"))


def target_name() -> str | None:
    """Hardware-target override for repro_torch.core.target.get_target()."""
    return os.environ.get("REPRO_TARGET") or None
