"""The paper's §VI-A cycle-count model (memory phase / compute phase).

The kernel multiplies two M x M matrices (M = 326400, the lcm of the four tile
sizes) that live in off-chip memory. Output tiles of size t x t are produced
one at a time; for each of the M/t K-steps the cores (1) run a *memory phase*
loading the next A and B tiles and synchronizing, then (2) a *compute phase*
on the loaded tiles. Each input element is hence loaded exactly M/t times.

Cycle model per K-step:
    memory  = 2 * t^2 * word_bytes / bw          (bw in bytes/cycle)
    compute = t^3 * cyc_per_mac                  (cluster-wide)
    static  = s                                  (loop setup + synchronization)
plus a store phase of t^2 * word_bytes / bw per finished output tile.

Two calibration constants — CYC_PER_MAC (the cluster's effective MAC
throughput, i.e. Snitch cores co-issuing loads with MACs) and STATIC_OVERHEAD
(cycles per phase pair) — are fitted to the three speedups the paper reports
in Fig. 6 (43 % @ 4 B/cyc, 16 % @ 16 B/cyc, 8 % @ 64 B/cyc for 8 MiB vs 1 MiB).
The fit lands at ~0.0112 cycles/MAC (~89.5 MACs/cycle cluster-wide, ~0.35 per
core — consistent with Snitch's load/MAC co-issue) and ~5000 cycles of static
overhead per phase pair. `tests/test_torch_paper.py` holds it equal to the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

from repro_torch.core import tiling
from repro_torch.core.hw_profiles import MiB

#: Matrix dimension used throughout the paper (lcm of 256, 384, 544, 800).
PAPER_M = 326400

#: Off-chip bandwidths analyzed in the paper (bytes/cycle). 16 B/cyc = 1 DDR ch.
PAPER_BANDWIDTHS = (4, 8, 16, 32, 64)
DDR_CHANNEL_BW = 16

#: Calibrated constants (see module docstring).
CYC_PER_MAC = 0.01115
STATIC_OVERHEAD = 9850.0


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    memory_cycles: float
    compute_cycles: float
    static_cycles: float
    store_cycles: float

    @property
    def total(self) -> float:
        return (self.memory_cycles + self.compute_cycles +
                self.static_cycles + self.store_cycles)


def matmul_cycles(m: int = PAPER_M, *, spm_bytes: int = 1 * MiB,
                  bw_bytes_per_cycle: float = DDR_CHANNEL_BW,
                  word_bytes: int = 4,
                  cyc_per_mac: float = CYC_PER_MAC,
                  static_overhead: float = STATIC_OVERHEAD,
                  tile: int | None = None) -> PhaseBreakdown:
    """Cycle count of the paper's tiled matmul for a given SPM capacity."""
    t = tile if tile is not None else tiling.mempool_tile_size(spm_bytes, word_bytes)
    k_steps = m // t
    n_out_tiles = k_steps * k_steps
    mem = n_out_tiles * k_steps * (2 * t * t * word_bytes / bw_bytes_per_cycle)
    comp = n_out_tiles * k_steps * (t ** 3) * cyc_per_mac
    stat = n_out_tiles * k_steps * static_overhead
    store = n_out_tiles * (t * t * word_bytes / bw_bytes_per_cycle)
    return PhaseBreakdown(mem, comp, stat, store)


def speedup_vs_baseline(spm_bytes: int, bw: float, *,
                        base_spm: int = 1 * MiB,
                        base_bw: float | None = None,
                        m: int = PAPER_M) -> float:
    """Fig. 6 ordinate: cycle-count speedup vs the 1 MiB configuration."""
    base_bw = bw if base_bw is None else base_bw
    base = matmul_cycles(m, spm_bytes=base_spm, bw_bytes_per_cycle=base_bw).total
    cur = matmul_cycles(m, spm_bytes=spm_bytes, bw_bytes_per_cycle=bw).total
    return base / cur


def fig6_table(capacities_mib: Sequence[int] = (1, 2, 4, 8),
               bandwidths: Iterable[float] = PAPER_BANDWIDTHS,
               m: int = PAPER_M) -> Dict[float, Dict[int, float]]:
    """Speedups relative to (1 MiB, 4 B/cycle) — the paper's Fig. 6 layout."""
    out: Dict[float, Dict[int, float]] = {}
    base = matmul_cycles(m, spm_bytes=1 * MiB, bw_bytes_per_cycle=4).total
    for bw in bandwidths:
        row = {}
        for cap in capacities_mib:
            cur = matmul_cycles(m, spm_bytes=cap * MiB, bw_bytes_per_cycle=bw).total
            row[cap] = base / cur
        out[bw] = row
    return out
