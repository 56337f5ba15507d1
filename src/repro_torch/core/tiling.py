"""Capacity-aware tile planning — the paper's core algorithmic idea.

MemPool-3D's §VI picks the GEMM tile edge ``t`` as the largest tile whose
working set *fully utilizes* the shared-L1 SPM; each input element is then
loaded exactly ``M/t`` times from off-chip, so capacity buys reuse. This module
reproduces that selection exactly (:func:`mempool_tile_size` yields the paper's
t = 256/384/544/800 for 1/2/4/8 MiB) and generalizes it to TPU kernels: the
same "fill the scratchpad" rule sizes Pallas ``BlockSpec`` blocks for matmul,
blockwise attention, and SSM scan chunks, under MXU/VREG alignment instead of
bank-interleaving constraints.

Every planner below checks candidate working sets against a
:class:`repro_torch.core.target.CapacityPartition` — the budget contract of the
current :class:`~repro_torch.core.target.HardwareTarget`'s scratchpad level
(DESIGN.md §CapacityPartition). Callers normally go through the cached entry
points in :mod:`repro_torch.core.planner`; the ``profile=`` escape hatch partitions
an explicit :class:`TpuProfile` or :class:`GpuProfile` for sweeps and tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

from repro_torch.core.hw_profiles import GpuProfile, TpuProfile
from repro_torch.core.target import (CapacityPartition, MEMPOOL_DB_MARGIN,
                                     MEMPOOL_TILE_ALIGN, get_target,
                                     gpu_target)

Profile = Union[TpuProfile, GpuProfile]

# ---------------------------------------------------------------------------
# The paper's tile-size rule (MemPool, §VI-A).
#
# Working set per tile step: the A, B and C tiles resident (3 t^2 words) plus
# a quarter-tile margin for the double-buffered fill of the next input tile
# and DMA metadata — 3.25 t^2 words total, i.e. 2 streamed tiles with the
# 0.125 double-buffer margin plus 1 resident accumulator tile. The largest t
# that is a multiple of 32 (MemPool: 4 banks/core * 8 rows interleave) and
# fits the SPM reproduces the paper's published tile sizes for every capacity:
#     1 MiB -> 256,  2 MiB -> 384,  4 MiB -> 544,  8 MiB -> 800.
# ---------------------------------------------------------------------------

#: effective resident-tile factor: 2 * (1 + db_margin) + 1 accumulator = 3.25
MEMPOOL_RESIDENT_TILES = 2.0 * (1.0 + MEMPOOL_DB_MARGIN) + 1.0


def mempool_partition(spm_bytes: int, word_bytes: int = 4) -> CapacityPartition:
    """The MemPool cluster-SPM partition: single-buffered streams with the
    paper's quarter-tile refill margin."""
    return CapacityPartition(capacity_bytes=spm_bytes, fraction=1.0,
                             n_buffers=1, db_margin=MEMPOOL_DB_MARGIN,
                             align=MEMPOOL_TILE_ALIGN, word_bytes=word_bytes)


def mempool_tile_size(spm_bytes: int, word_bytes: int = 4, *,
                      partition: Optional[CapacityPartition] = None) -> int:
    """Largest aligned tile edge t whose working set fits the partition.

    Streamed set: the A and B tiles (2 t^2 words, double-buffer margin
    applied by the partition); resident: the C accumulator tile (t^2 words).
    """
    part = partition or mempool_partition(spm_bytes, word_bytes)
    align = part.align
    factor = 2.0 * part.streamed_multiplier + 1.0
    t_max = math.sqrt(part.budget_bytes / (factor * word_bytes))
    t = int(t_max // align) * align
    if t <= 0:
        raise ValueError(
            f"SPM of {part.budget_bytes} B cannot hold a {align}-aligned tile")
    return t


def loads_per_element(m: int, t: int) -> float:
    """The paper's reuse law: each input element is loaded exactly M/t times."""
    return m / t


def offchip_traffic_bytes(m: int, t: int, word_bytes: int = 4) -> int:
    """Total off-chip traffic for an MxM * MxM GEMM with t-tiling.

    Inputs: 2 * M^2 elements, each loaded M/t times.  Output: M^2 stored once.
    """
    return (2 * m * m * (m // t) + m * m) * word_bytes


# ---------------------------------------------------------------------------
# TPU generalization: Pallas block plans.
# ---------------------------------------------------------------------------


def _round_down(x: int, align: int) -> int:
    return max(align, (x // align) * align)


def _fit_pow2_below(x: int, cap: int) -> int:
    """Largest power of two <= min(x, cap)."""
    v = 1
    while v * 2 <= min(x, cap):
        v *= 2
    return v


def _resolve_partition(partition: Optional[CapacityPartition],
                       profile: Optional[Profile],
                       fraction: float, n_buffers: int) -> CapacityPartition:
    """Partition precedence: explicit partition > explicit profile > current
    target's scratchpad."""
    if partition is not None:
        return partition
    if isinstance(profile, GpuProfile):
        return gpu_target(profile).partition(fraction=fraction,
                                             n_buffers=n_buffers)
    if profile is not None:
        return CapacityPartition(capacity_bytes=profile.vmem_bytes,
                                 fraction=fraction, n_buffers=n_buffers,
                                 align=profile.mxu_dim)
    return get_target().partition(fraction=fraction, n_buffers=n_buffers)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """Block sizes for a (M,K) @ (K,N) matmul kernel.

    vmem model (the TPU analogue of the paper's 3.25-tile working set):
      n_buffers copies of the A and B blocks (double buffering of the HBM->VMEM
      DMA pipeline) + one f32 accumulator block resident across the K loop.
    """

    bm: int
    bk: int
    bn: int
    n_buffers: int = 2

    def streamed_bytes(self, in_bytes: int = 2) -> int:
        """One set of the streamed operand blocks (A + B)."""
        return (self.bm * self.bk + self.bk * self.bn) * in_bytes

    def resident_bytes(self, acc_bytes: int = 4) -> int:
        return self.bm * self.bn * acc_bytes

    def vmem_bytes(self, in_bytes: int = 2, acc_bytes: int = 4) -> int:
        return (self.n_buffers * self.streamed_bytes(in_bytes)
                + self.resident_bytes(acc_bytes))

    def grid(self, m: int, k: int, n: int) -> Tuple[int, int, int]:
        return (pl_cdiv(m, self.bm), pl_cdiv(n, self.bn), pl_cdiv(k, self.bk))

    def hbm_traffic_bytes(self, m: int, k: int, n: int, in_bytes: int = 2,
                          out_bytes: int = 2) -> int:
        """Generalized reuse law: A read n/bn times, B read m/bm times."""
        reads = (m * k * pl_cdiv(n, self.bn) + k * n * pl_cdiv(m, self.bm))
        return reads * in_bytes + m * n * out_bytes

    def arithmetic_intensity(self, m: int, k: int, n: int,
                             in_bytes: int = 2) -> float:
        return (2.0 * m * k * n) / self.hbm_traffic_bytes(m, k, n, in_bytes)


def pl_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_matmul(m: int, k: int, n: int, *,
                partition: Optional[CapacityPartition] = None,
                profile: Optional[Profile] = None,
                in_bytes: Optional[int] = None,
                acc_bytes: int = 4,
                n_buffers: int = 2,
                vmem_fraction: float = 0.75) -> MatmulPlan:
    """Capacity-aware (bm, bk, bn) selection — the paper's t-rule on TPU.

    Strategy (mirrors the paper's square-tile argument): HBM traffic is
    ~ M*K*N*(1/bm + 1/bn), so grow bm ~= bn as large as the partition budget
    allows; bk only has to be deep enough to keep the MXU busy and amortize
    the accumulator writeback, so give it what is left.  All dims are aligned
    to the partition granularity (MXU 128); blocks never exceed the problem
    dims (rounded up to alignment so small problems still lower).
    """
    part = _resolve_partition(partition, profile, vmem_fraction, n_buffers)
    in_bytes = part.word_bytes if in_bytes is None else in_bytes
    a = part.align

    def fits(bm: int, bk: int, bn: int) -> bool:
        cand = MatmulPlan(bm, bk, bn, part.n_buffers)
        return part.fits(cand.streamed_bytes(in_bytes),
                         cand.resident_bytes(acc_bytes))

    # Upper bounds: nothing bigger than the (aligned) problem dims.
    m_cap = _round_down(max(m, a), a)
    n_cap = _round_down(max(n, a), a)
    k_cap = _round_down(max(k, a), a)

    # Square growth of the output block (the paper's t x t), then deepen bk.
    bm = bn = a
    while True:
        nbm, nbn = min(bm * 2, m_cap), min(bn * 2, n_cap)
        if (nbm, nbn) == (bm, bn) or not fits(nbm, a, nbn):
            # try growing just one side (rectangular problems)
            if nbm != bm and fits(nbm, a, bn):
                bm = nbm
                continue
            if nbn != bn and fits(bm, a, nbn):
                bn = nbn
                continue
            break
        bm, bn = nbm, nbn
    bk = a
    while bk * 2 <= k_cap and fits(bm, bk * 2, bn):
        bk *= 2
    return MatmulPlan(bm=bm, bk=bk, bn=bn, n_buffers=part.n_buffers)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Block sizes for blockwise (flash) attention."""

    block_q: int
    block_kv: int
    n_buffers: int = 2

    def streamed_bytes(self, head_dim: int, in_bytes: int = 2) -> int:
        """One set of the streamed K and V blocks."""
        return 2 * self.block_kv * head_dim * in_bytes

    def resident_bytes(self, head_dim: int, in_bytes: int = 2,
                       acc_bytes: int = 4) -> int:
        q = self.block_q * head_dim * in_bytes
        acc = self.block_q * head_dim * acc_bytes
        scores = self.block_q * self.block_kv * acc_bytes
        stats = 2 * self.block_q * acc_bytes
        return q + acc + scores + stats

    def vmem_bytes(self, head_dim: int, in_bytes: int = 2,
                   acc_bytes: int = 4) -> int:
        return (self.n_buffers * self.streamed_bytes(head_dim, in_bytes)
                + self.resident_bytes(head_dim, in_bytes, acc_bytes))


def plan_attention(seq_q: int, seq_kv: int, head_dim: int, *,
                   partition: Optional[CapacityPartition] = None,
                   profile: Optional[Profile] = None,
                   in_bytes: Optional[int] = None,
                   n_buffers: int = 2,
                   vmem_fraction: float = 0.5,
                   max_block: int = 2048) -> AttentionPlan:
    part = _resolve_partition(partition, profile, vmem_fraction, n_buffers)
    in_bytes = part.word_bytes if in_bytes is None else in_bytes
    a = part.align

    def fits(bq: int, bkv: int) -> bool:
        cand = AttentionPlan(bq, bkv, part.n_buffers)
        return part.fits(cand.streamed_bytes(head_dim, in_bytes),
                         cand.resident_bytes(head_dim, in_bytes))

    bq = _fit_pow2_below(max(seq_q, a), max_block)
    bq = max(a, min(bq, _round_down(max(seq_q, a), a)))
    bkv = a
    while bkv * 2 <= min(seq_kv, max_block) and fits(bq, bkv * 2):
        bkv *= 2
    # shrink bq if even the minimal bkv does not fit
    while bq > a and not fits(bq, bkv):
        bq //= 2
    return AttentionPlan(block_q=bq, block_kv=bkv, n_buffers=part.n_buffers)


@dataclasses.dataclass(frozen=True)
class ScanChunkPlan:
    """Chunk length for the chunked selective scan (SSM) kernel.

    The paper's idea applied to state-space models: the chunk of inputs,
    gates and the (d_inner x d_state) running state must fit VMEM; a longer
    chunk amortizes the sequential inter-chunk dependency (the "static
    overhead" of the paper's phase model).
    """

    chunk: int
    n_buffers: int = 1

    def streamed_bytes(self, d_inner: int, d_state: int,
                       in_bytes: int = 2) -> int:
        seqs = 4 * self.chunk * d_inner * in_bytes      # x, dt, gate, out
        b_c = 2 * self.chunk * d_state * in_bytes       # B_t, C_t
        return seqs + b_c

    def resident_bytes(self, d_inner: int, d_state: int,
                       acc_bytes: int = 4) -> int:
        return d_inner * d_state * acc_bytes            # running state

    def vmem_bytes(self, d_inner: int, d_state: int, in_bytes: int = 2,
                   acc_bytes: int = 4) -> int:
        return (self.n_buffers * self.streamed_bytes(d_inner, d_state, in_bytes)
                + self.resident_bytes(d_inner, d_state, acc_bytes))


def plan_scan_chunk(seq: int, d_inner: int, d_state: int, *,
                    partition: Optional[CapacityPartition] = None,
                    profile: Optional[Profile] = None,
                    in_bytes: Optional[int] = None,
                    n_buffers: int = 1,
                    vmem_fraction: float = 0.5,
                    min_chunk: int = 8,
                    max_chunk: int = 4096) -> ScanChunkPlan:
    part = _resolve_partition(partition, profile, vmem_fraction, n_buffers)
    in_bytes = part.word_bytes if in_bytes is None else in_bytes

    def fits(chunk: int) -> bool:
        cand = ScanChunkPlan(chunk, part.n_buffers)
        return part.fits(cand.streamed_bytes(d_inner, d_state, in_bytes),
                         cand.resident_bytes(d_inner, d_state))

    chunk = min_chunk
    while chunk * 2 <= min(seq, max_chunk) and fits(chunk * 2):
        chunk *= 2
    return ScanChunkPlan(chunk=chunk, n_buffers=part.n_buffers)
