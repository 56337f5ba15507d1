"""Performance / energy-efficiency / PDP / EDP model (paper §V-B and §VI-B).

Everything here is *derived* from the primitive Table II rows stored in
:mod:`repro_torch.core.hw_profiles` plus the cycle model of
:mod:`repro_torch.core.perf_model` — reproducing the paper's derived rows and
Figures 7, 8 and 9:

    PDP        = power / frequency                           (Table II row)
    runtime    = cycles / frequency
    performance= 1 / runtime                                 (Fig. 7)
    energy     = power * runtime
    efficiency = performance / power = frequency/(cycles*P)  (Fig. 8)
    EDP        = energy * runtime                            (Fig. 9)

All values are normalized to MemPool-2D(1 MiB) at 16 B/cycle, exactly like the
paper's figures.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import perf_model
from repro_torch.core.hw_profiles import (MEMPOOL_PROFILES, MiB, MemPoolProfile,
                                    SPM_CAPACITIES_MIB, mempool_profile)


@dataclasses.dataclass(frozen=True)
class DerivedMetrics:
    name: str
    flow: str
    spm_mib: int
    pdp: float            # power-delay product (clock delay), Table II
    cycles: float         # kernel cycles (perf model)
    performance: float    # Fig. 7 (normalized)
    energy: float
    efficiency: float     # Fig. 8 (normalized)
    edp: float            # Fig. 9 (normalized)


def derive(flow: str, mib: int, *, bw_bytes_per_cycle: float = 16,
           base_flow: str = "2D", base_mib: int = 1) -> DerivedMetrics:
    prof = mempool_profile(flow, mib)
    base = mempool_profile(base_flow, base_mib)

    cycles = perf_model.matmul_cycles(
        spm_bytes=mib * MiB, bw_bytes_per_cycle=bw_bytes_per_cycle).total
    cycles_base = perf_model.matmul_cycles(
        spm_bytes=base_mib * MiB, bw_bytes_per_cycle=bw_bytes_per_cycle).total

    # Normalized quantities (baseline == 1.0 by construction).
    runtime = (cycles / prof.freq_norm) / (cycles_base / base.freq_norm)
    performance = 1.0 / runtime
    power = prof.power_norm / base.power_norm
    energy = power * runtime
    efficiency = performance / power
    edp = energy * runtime
    pdp = prof.power_norm / prof.freq_norm
    return DerivedMetrics(name=prof.name, flow=flow, spm_mib=mib, pdp=pdp,
                          cycles=cycles, performance=performance,
                          energy=energy, efficiency=efficiency, edp=edp)


def derive_all(bw_bytes_per_cycle: float = 16) -> Dict[str, DerivedMetrics]:
    out = {}
    for flow in ("2D", "3D"):
        for mib in SPM_CAPACITIES_MIB:
            m = derive(flow, mib, bw_bytes_per_cycle=bw_bytes_per_cycle)
            out[m.name] = m
    return out


def pdp_table() -> Dict[str, float]:
    """Table II's PDP row, normalized to the 2D-1MiB baseline."""
    base = mempool_profile("2D", 1)
    base_pdp = base.power_norm / base.freq_norm
    return {name: (p.power_norm / p.freq_norm) / base_pdp
            for name, p in MEMPOOL_PROFILES.items()}
