"""Mem3DPlanner — the paper's co-exploration loop as a framework service.

MemPool-3D's thesis is that scratchpad capacity, tiling and the interconnect
hierarchy must be chosen *together*. On TPU this becomes: given a workload
(an architecture x input shape), a mesh, and a hardware target, jointly pick

  * Pallas block plans for every hot op (matmul / attention / scan chunk) so
    each working set fills the target's scratchpad partition
    (:mod:`repro_torch.core.tiling`),
  * where each traffic class lives in the interconnect hierarchy (HBM-local /
    intra-pod ICI / inter-pod DCI — MemPool's tile / group / cluster levels),

and report the resulting three-term roofline. The dry-run feeds *measured*
HLO FLOPs/bytes/collective-bytes back into :class:`RooflineReport`, closing
the same loop the paper closes with RTL cycle counts.

Plans are memoized in an LRU cache keyed on (target, shapes, dtypes) — the
kernel entry points in :mod:`repro_torch.kernels.ops` call the ``*_kernel_plan``
helpers below on every invocation, so planning and the block pad/clamp
derivation run once per distinct problem, not once per call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

from repro_torch.core import tiling
from repro_torch.core.hw_profiles import TpuProfile
from repro_torch.core.target import HardwareTarget, get_target


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """Three-term roofline for one (arch x shape x mesh) cell.

    ``profile`` carries the TPU roofline constants; when ``None`` it resolves
    to the current target's profile at property-access time.
    """

    name: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float        # summed operand bytes of ICI collectives
    model_flops: float             # 6*N*D (dense) or 6*N_active*D (MoE)
    profile: Optional[TpuProfile] = None
    pod_collective_bytes: float = 0.0   # traffic crossing the pod boundary

    @property
    def _prof(self) -> TpuProfile:
        if self.profile is not None:
            return self.profile
        prof = get_target().profile
        assert isinstance(prof, TpuProfile), \
            "RooflineReport needs a TPU target (roofline constants)"
        return prof

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.n_chips * self._prof.peak_flops_bf16)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.n_chips * self._prof.hbm_bw)

    @property
    def collective_s(self) -> float:
        ici = self.collective_bytes / (self.n_chips * self._prof.ici_link_bw)
        dci = self.pod_collective_bytes / (self.n_chips * self._prof.dci_bw)
        return ici + dci

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound: the roofline step time is max(terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — catches remat / redundancy waste."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the *useful* model FLOPs achieve at bound speed."""
        peak = self.n_chips * self._prof.peak_flops_bf16
        return (self.model_flops / self.step_time_s) / peak if self.step_time_s else 0.0

    def to_dict(self) -> Dict:
        return dict(name=self.name, n_chips=self.n_chips,
                    hlo_flops=self.hlo_flops, hlo_bytes=self.hlo_bytes,
                    collective_bytes=self.collective_bytes,
                    pod_collective_bytes=self.pod_collective_bytes,
                    model_flops=self.model_flops,
                    compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, bound=self.bound,
                    useful_flops_ratio=self.useful_flops_ratio,
                    roofline_fraction=self.roofline_fraction)


# ---------------------------------------------------------------------------
# Shared pad/clamp logic: one place that adapts a capacity plan to a concrete
# problem (kernel grids need block edges that tile the padded problem).
# ---------------------------------------------------------------------------


def shrink_to_divisor(block: int, size: int) -> int:
    """Largest halving of ``block`` (clamped to ``size``) that divides ``size``."""
    b = max(min(block, size), 1)
    while size % b:
        b //= 2
    return max(b, 1)


def clamp_matmul_plan(plan: tiling.MatmulPlan, m: int, k: int,
                      n: int) -> tiling.MatmulPlan:
    """Blocks never exceed the problem dims (inputs are padded to block
    multiples by the caller)."""
    return tiling.MatmulPlan(min(plan.bm, m), min(plan.bk, k),
                             min(plan.bn, n), plan.n_buffers)


def clamp_attention_plan(plan: tiling.AttentionPlan, seq_q: int,
                         seq_kv: int) -> tiling.AttentionPlan:
    return tiling.AttentionPlan(
        shrink_to_divisor(plan.block_q, max(seq_q, 1)),
        shrink_to_divisor(plan.block_kv, max(seq_kv, 1)),
        plan.n_buffers)


def clamp_scan_plan(plan: tiling.ScanChunkPlan,
                    seq: int) -> tiling.ScanChunkPlan:
    return tiling.ScanChunkPlan(shrink_to_divisor(plan.chunk, max(seq, 1)),
                                plan.n_buffers)


# ---------------------------------------------------------------------------
# The LRU plan cache. Targets and plans are frozen dataclasses, so the
# (target, shapes, dtypes) key hashes directly and hits return the SAME plan
# object — jit caches keyed on the plan see one entry per distinct problem.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _matmul_plan(target: HardwareTarget, m: int, k: int, n: int,
                 in_bytes: int, acc_bytes: int) -> tiling.MatmulPlan:
    plan = tiling.plan_matmul(m, k, n, partition=target.partition(
        fraction=0.75, n_buffers=2), in_bytes=in_bytes, acc_bytes=acc_bytes)
    return clamp_matmul_plan(plan, m, k, n)


@functools.lru_cache(maxsize=1024)
def _attention_plan(target: HardwareTarget, seq_q: int, seq_kv: int,
                    head_dim: int, in_bytes: int) -> tiling.AttentionPlan:
    return tiling.plan_attention(seq_q, seq_kv, head_dim,
                                 partition=target.partition(
                                     fraction=0.5, n_buffers=2),
                                 in_bytes=in_bytes)


@functools.lru_cache(maxsize=1024)
def _scan_plan(target: HardwareTarget, seq: int, d_inner: int,
               d_state: int) -> tiling.ScanChunkPlan:
    return tiling.plan_scan_chunk(seq, d_inner, d_state,
                                  partition=target.partition(
                                      fraction=0.5, n_buffers=1))


def matmul_kernel_plan(m: int, k: int, n: int, *,
                       in_bytes: Optional[int] = None,
                       acc_bytes: int = 4,
                       target: Optional[HardwareTarget] = None
                       ) -> tiling.MatmulPlan:
    """Cached, problem-clamped matmul plan for the current (or given) target."""
    target = target or get_target()
    in_bytes = target.word_bytes if in_bytes is None else in_bytes
    return _matmul_plan(target, m, k, n, in_bytes, acc_bytes)


def attention_plan(seq_q: int, seq_kv: int, head_dim: int, *,
                   in_bytes: Optional[int] = None,
                   target: Optional[HardwareTarget] = None
                   ) -> tiling.AttentionPlan:
    """Cached attention plan (capacity-sized, NOT clamped to divisors)."""
    target = target or get_target()
    in_bytes = target.word_bytes if in_bytes is None else in_bytes
    return _attention_plan(target, seq_q, seq_kv, head_dim, in_bytes)


def attention_kernel_plan(seq_q: int, seq_kv: int, head_dim: int, *,
                          in_bytes: Optional[int] = None,
                          target: Optional[HardwareTarget] = None
                          ) -> tiling.AttentionPlan:
    return clamp_attention_plan(
        attention_plan(seq_q, seq_kv, head_dim, in_bytes=in_bytes,
                       target=target), seq_q, seq_kv)


def scan_kernel_plan(seq: int, d_inner: int, d_state: int, *,
                     target: Optional[HardwareTarget] = None
                     ) -> tiling.ScanChunkPlan:
    return clamp_scan_plan(_scan_plan(target or get_target(), seq, d_inner,
                                      d_state), seq)


def plan_cache_info() -> Dict[str, Tuple]:
    return {"matmul": _matmul_plan.cache_info(),
            "attention": _attention_plan.cache_info(),
            "scan": _scan_plan.cache_info()}


def plan_cache_clear() -> None:
    _matmul_plan.cache_clear()
    _attention_plan.cache_clear()
    _scan_plan.cache_clear()


# ---------------------------------------------------------------------------
# KernelPlans / Mem3DPlanner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelPlans:
    """Capacity-aware block plans for a model's hot ops.

    These are *capacity* plans for the shape cell they were planned at; the
    kernel entry points (:mod:`repro_torch.kernels.ops`) clamp them to the concrete
    call shapes via the ``clamp_*_plan`` helpers, so threading one KernelPlans
    through layers with differing sequence lengths is safe.
    """

    matmul: tiling.MatmulPlan
    attention: Optional[tiling.AttentionPlan]
    scan_chunk: Optional[tiling.ScanChunkPlan]
    target_name: str = ""


class Mem3DPlanner:
    """Joint capacity/tiling/hierarchy planner, parametric in the target."""

    def __init__(self, target: Optional[HardwareTarget] = None):
        self._target = target

    @property
    def target(self) -> HardwareTarget:
        return self._target or get_target()

    @property
    def profile(self):
        return self.target.profile

    def plan_for(self, *, d_model: int, d_ff: int, seq_q: int, seq_kv: int,
                 head_dim: int, tokens_per_device: int,
                 ssm_d_inner: int = 0, ssm_d_state: int = 0) -> KernelPlans:
        target = self.target
        mm = matmul_kernel_plan(tokens_per_device, d_model, d_ff,
                                target=target)
        attn = None
        if head_dim:
            attn = attention_plan(seq_q, seq_kv, head_dim, target=target)
        scan = None
        if ssm_d_inner:
            scan = _scan_plan(target, seq_q, ssm_d_inner, ssm_d_state)
        return KernelPlans(matmul=mm, attention=attn, scan_chunk=scan,
                           target_name=target.name)
