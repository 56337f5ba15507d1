"""Hardware profiles: the paper's eight MemPool configurations plus TPU and
GPU targets.

The MemPool profiles are calibrated with the *primitive* rows of Table II of the
paper (effective frequency, total power, footprint, combined die area, wire
length, buffers, F2F bumps), all normalized to the MemPool-2D(1 MiB) baseline.
Derived metrics (PDP, performance, energy efficiency, EDP) are NOT stored: they
are computed by the reference's ``repro.core.energy`` and validated against the paper's
derived rows in the benchmarks — that round trip is the reproduction.

TPU profiles carry the constants used for the roofline analysis
(:mod:`benchmarks.roofline`): peak bf16 FLOP/s, HBM bandwidth, ICI link
bandwidth, and the VMEM capacity that plays the role of MemPool's L1 SPM.

GPU profiles carry the same roofline fields under the same names
(``peak_flops_bf16``, ``hbm_bw``, ``hbm_bytes``) plus the shared memory one
thread block may claim, which plays the role of MemPool's L1 SPM on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB


@dataclasses.dataclass(frozen=True)
class MemPoolProfile:
    """One row of the paper's Table II (primitive metrics only)."""

    name: str
    flow: str                 # "2D" | "3D"
    spm_bytes: int            # shared-L1 scratchpad capacity of the cluster
    freq_norm: float          # effective frequency, normalized to 2D-1MiB
    power_norm: float         # total power, normalized to 2D-1MiB
    footprint_norm: float     # group footprint
    die_area_norm: float      # combined die area (cost proxy)
    wire_length_norm: float
    n_buffers: float
    n_f2f_bumps: float | None  # None for 2D flows
    tns_norm: float           # total negative slack (normalized)
    n_failing_paths: int

    # Architectural constants shared by every MemPool instance (paper §II).
    n_cores: int = 256
    n_tiles: int = 64
    n_groups: int = 4
    banks_per_tile: int = 16
    word_bytes: int = 4
    # Interconnect latency hierarchy (cycles): tile-local / group / cluster.
    latency_local: int = 1
    latency_group: int = 3
    latency_cluster: int = 5

    @property
    def spm_per_tile(self) -> int:
        return self.spm_bytes // self.n_tiles

    @property
    def key(self) -> Tuple[str, int]:
        return (self.flow, self.spm_bytes)


def _mp(flow: str, mib: int, freq: float, power: float, fp: float, area: float,
        wl: float, nbuf: float, bumps: float | None, tns: float,
        nfail: int) -> MemPoolProfile:
    return MemPoolProfile(
        name=f"MemPool-{flow}_{mib}MiB", flow=flow, spm_bytes=mib * MiB,
        freq_norm=freq, power_norm=power, footprint_norm=fp,
        die_area_norm=area, wire_length_norm=wl, n_buffers=nbuf,
        n_f2f_bumps=bumps, tns_norm=tns, n_failing_paths=nfail)


#: Table II of the paper, primitive rows, normalized to MemPool-2D(1 MiB).
MEMPOOL_PROFILES: Dict[str, MemPoolProfile] = {p.name: p for p in [
    _mp("2D", 1, 1.000, 1.000, 1.000, 1.000, 1.000, 182.9e3, None, -1.000, 1140),
    _mp("2D", 2, 0.930, 1.045, 1.074, 1.074, 1.036, 190.3e3, None, -2.080, 1636),
    _mp("2D", 4, 0.875, 1.129, 1.299, 1.299, 1.131, 212.5e3, None, -5.887, 4396),
    _mp("2D", 8, 0.885, 1.299, 1.572, 1.572, 1.294, 217.6e3, None, -5.212, 4352),
    _mp("3D", 1, 1.040, 0.913, 0.665, 1.330, 0.803, 151.5e3, 78.3e3, -0.184, 1046),
    _mp("3D", 2, 0.979, 0.958, 0.665, 1.330, 0.803, 151.2e3, 78.9e3, -0.458, 1332),
    _mp("3D", 4, 0.955, 1.041, 0.737, 1.474, 0.844, 166.5e3, 84.4e3, -0.604, 1747),
    _mp("3D", 8, 0.930, 1.173, 0.857, 1.714, 0.888, 156.1e3, 86.2e3, -0.962, 2403),
]}

SPM_CAPACITIES_MIB = (1, 2, 4, 8)


def mempool_profile(flow: str, mib: int) -> MemPoolProfile:
    return MEMPOOL_PROFILES[f"MemPool-{flow}_{mib}MiB"]


@dataclasses.dataclass(frozen=True)
class TpuProfile:
    """Roofline constants for a TPU target (per chip unless noted)."""

    name: str
    peak_flops_bf16: float     # FLOP/s
    hbm_bw: float              # bytes/s
    hbm_bytes: int             # capacity, bytes
    ici_link_bw: float         # bytes/s per link, per direction
    ici_links: int             # torus links per chip
    vmem_bytes: int            # the "shared-L1 SPM" of the TPU world
    mxu_dim: int = 128         # systolic array edge -> matmul tiling alignment
    sublanes: int = 8          # VREG sublane count -> second-minor alignment
    dci_bw: float = 25.0e9     # inter-pod (data-center) bytes/s per chip, est.

    @property
    def ici_bw_total(self) -> float:
        return self.ici_link_bw * self.ici_links


#: TPU v5e — the dry-run / roofline target (values from public spec sheets).
TPU_V5E = TpuProfile(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * GiB,
    ici_link_bw=50e9,
    ici_links=4,
    vmem_bytes=128 * MiB,
)

#: TPU v5p, kept for profile-sweep experiments (beyond-paper exploration).
TPU_V5P = TpuProfile(
    name="tpu-v5p",
    peak_flops_bf16=459e12,
    hbm_bw=2765e9,
    hbm_bytes=95 * GiB,
    ici_link_bw=100e9,
    ici_links=6,
    vmem_bytes=128 * MiB,
)

TPU_PROFILES = {p.name: p for p in (TPU_V5E, TPU_V5P)}


def get_tpu_profile(name: str = "tpu-v5e") -> TpuProfile:
    return TPU_PROFILES[name]


@dataclasses.dataclass(frozen=True)
class GpuProfile:
    """Roofline constants for one GPU (dense rates, no sparsity)."""

    name: str
    peak_flops_bf16: float     # FLOP/s, tensor cores
    peak_flops_f32: float      # FLOP/s, outside the tensor cores
    hbm_bw: float              # bytes/s
    hbm_bytes: int             # capacity, bytes
    smem_per_block: int        # shared memory one thread block may claim
    n_sms: int                 # streaming multiprocessors
    l2_bytes: int
    special_ops: float         # results/s of the special function units
                               # (exp2, log2, rcp, rsqrt, sin, cos)


#: NVIDIA H100 SXM (data sheet and Hopper white paper): the port's card.
#: ``smem_per_block`` is the 227 KB of the SM's 256 KB that one block can
#: opt into as dynamic shared memory. ``special_ops``: 16 results a clock
#: on each SM for compute capability 9.0 (CUDA C++ Programming Guide,
#: throughput of native arithmetic instructions) at the 1980 MHz boost
#: clock.
H100_SXM = GpuProfile(
    name="h100",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10 ** 9,
    smem_per_block=232448,
    n_sms=132,
    l2_bytes=50 * MiB,
    special_ops=132 * 16 * 1.98e9,
)

GPU_PROFILES = {p.name: p for p in (H100_SXM,)}
