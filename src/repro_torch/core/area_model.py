"""Tile partitioning / die-utilization model (paper §IV, Table I).

The paper partitions each MemPool tile into a logic die (4 Snitch cores +
interconnect, 60 kGE/core) and a memory die (16 SPM banks + 2 KiB I$). We
rebuild that decision procedure:

  * SRAM area model ``bank_area(bytes) = a + b * bytes`` (periphery + bitcell
    array), calibrated by least squares against the *memory-die* utilization
    column of Table I (the only primitive area data the paper publishes).
  * Logic-die cell area ``L`` calibrated from the 3D-1MiB row (90 % util on a
    0.667-normalized footprint).
  * Partitioning rule: put every SPM bank + the I$ on the memory die; if the
    memory die would then be larger than the logic die at the flow's maximum
    utilization, migrate banks (I$ first) to the logic die until the dies
    balance — reproducing the paper's 15/16-bank arrangement for 8 MiB.

Predicted footprints and utilizations match Table I within ~6 % (validated in
``tests/test_paper_models.py``; reported side-by-side in
``repro_torch.benchmarks.table1_tile``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.hw_profiles import KiB, MiB

# --- Calibration inputs (Table I, 3D rows; areas in units of the ------------
# --- 2D-1MiB tile footprint). ------------------------------------------------

#: Logic-die cell area: 90% utilization on a 0.667 footprint.
LOGIC_CELL_AREA = 0.90 * 0.667

#: Memory-die cell areas implied by Table I (util * footprint).
_MEM_CELL_AREA = {
    16 * KiB: 0.51 * 0.667,    # 1 MiB cluster -> 16 KiB / tile  (+ I$)
    32 * KiB: 0.65 * 0.667,    # 2 MiB                            (+ I$)
    64 * KiB: 0.89 * 0.767,    # 4 MiB                            (+ I$)
    128 * KiB: 0.933 * 15 / 15,  # 8 MiB: 15/16 banks, no I$ -> see below
}

BANKS_PER_TILE = 16
ICACHE_BYTES = 2 * KiB
TARGET_UTIL = 0.90            # the flow's standard-cell density target
MIXED_MEM_UTIL = 0.89         # SPM macros + I$ on one die (paper Fig. 3b)
PURE_MEM_UTIL = 1.00          # pure SPM-macro array (paper Fig. 3c, 5x3)

# Least-squares calibration of [A = 16 a (total periphery), b, icache_area]:
#   A + b*c + i = mem_cell_area(c)      for c in {16,32,64} KiB (I$ on mem die)
#   A + b*c * (15/16) + 0 = 0.933       for c = 128 KiB (15 banks, I$ on logic)
_rows = []
_rhs = []
for _c in (16 * KiB, 32 * KiB, 64 * KiB):
    _rows.append([1.0, float(_c), 1.0])
    _rhs.append(_MEM_CELL_AREA[_c])
_rows.append([15.0 / 16.0, 128 * KiB * 15.0 / 16.0, 0.0])
_rhs.append(0.933)
_sol, *_ = np.linalg.lstsq(np.asarray(_rows), np.asarray(_rhs), rcond=None)
SRAM_PERIPHERY_AREA, SRAM_AREA_PER_BYTE, ICACHE_AREA = (float(x) for x in _sol)


def sram_area(spm_bytes_per_tile: int, n_banks: int = BANKS_PER_TILE) -> float:
    """Area of ``n_banks`` banks holding ``spm_bytes_per_tile`` in total."""
    frac = n_banks / BANKS_PER_TILE
    return SRAM_PERIPHERY_AREA * frac + SRAM_AREA_PER_BYTE * spm_bytes_per_tile * frac


@dataclasses.dataclass(frozen=True)
class TilePartition:
    """A logic/memory-die assignment for one MemPool tile."""

    flow: str
    spm_bytes_per_tile: int
    banks_on_mem_die: int
    icache_on_mem_die: bool
    footprint: float              # normalized to the 2D-1MiB tile
    logic_util: float
    mem_util: float | None        # None for 2D flows

    @property
    def spm_cluster_mib(self) -> float:
        return self.spm_bytes_per_tile * 64 / MiB


def partition_tile(flow: str, spm_cluster_bytes: int) -> TilePartition:
    """The paper's partitioning procedure for one tile."""
    c = spm_cluster_bytes // 64   # per-tile SPM
    total_sram = sram_area(c) + ICACHE_AREA

    if flow == "2D":
        cell = LOGIC_CELL_AREA + total_sram
        fp = cell / TARGET_UTIL
        return TilePartition(flow, c, 0, False, fp, TARGET_UTIL, None)

    # 3D: exhaustive min-footprint search over bank/I$ assignments.  A mixed
    # memory die (SPM macros + I$) packs to at most MIXED_MEM_UTIL; a pure
    # SPM-macro array (the paper's 5x3 arrangement) packs to ~100 %.
    best = None
    for icache_mem in (True, False):
        for banks_mem in range(BANKS_PER_TILE, 0, -1):
            # SPM banks migrate only together with the I$: the logic die has a
            # single SRAM region (paper's 8 MiB floorplan: "one SPM bank and
            # all the tile's instruction cache banks").
            if banks_mem < BANKS_PER_TILE and icache_mem:
                continue
            mem_cell = sram_area(c, banks_mem) + (ICACHE_AREA if icache_mem else 0.0)
            logic_cell = (LOGIC_CELL_AREA +
                          sram_area(c, BANKS_PER_TILE - banks_mem) +
                          (0.0 if icache_mem else ICACHE_AREA))
            mem_cap = MIXED_MEM_UTIL if icache_mem else PURE_MEM_UTIL
            fp = max(logic_cell / TARGET_UTIL, mem_cell / mem_cap)
            cand = TilePartition(flow, c, banks_mem, icache_mem, fp,
                                 logic_cell / fp, mem_cell / fp)
            # strict improvement required, so the default partition wins ties
            if best is None or fp < best.footprint - 1e-9:
                best = cand
    assert best is not None
    return best


def table1(capacities_mib=(1, 2, 4, 8)) -> List[Dict]:
    """Model predictions laid out like the paper's Table I."""
    base = partition_tile("2D", 1 * MiB).footprint
    rows = []
    for flow in ("2D", "3D"):
        for mib in capacities_mib:
            p = partition_tile(flow, mib * MiB)
            rows.append(dict(
                flow=flow, spm_mib=mib,
                footprint=p.footprint / base,
                logic_util=p.logic_util,
                mem_util=p.mem_util,
                banks_on_mem_die=p.banks_on_mem_die,
                icache_on_mem_die=p.icache_on_mem_die,
            ))
    return rows


#: Paper's Table I, for validation (footprint normalized to 2D-1MiB).
PAPER_TABLE1 = {
    ("2D", 1): dict(footprint=1.000, logic_util=0.90, mem_util=None),
    ("2D", 2): dict(footprint=1.104, logic_util=0.90, mem_util=None),
    ("2D", 4): dict(footprint=1.420, logic_util=0.84, mem_util=None),
    ("2D", 8): dict(footprint=1.817, logic_util=0.86, mem_util=None),
    ("3D", 1): dict(footprint=0.667, logic_util=0.90, mem_util=0.51),
    ("3D", 2): dict(footprint=0.667, logic_util=0.90, mem_util=0.65),
    ("3D", 4): dict(footprint=0.767, logic_util=0.85, mem_util=0.89),
    ("3D", 8): dict(footprint=0.933, logic_util=0.84, mem_util=1.00),
}
