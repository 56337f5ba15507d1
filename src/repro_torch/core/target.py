"""HardwareTarget — one memory-hierarchy abstraction over MemPool, TPU, GPU.

The paper's thesis is that scratchpad capacity, tiling and interconnect
hierarchy must be chosen *together*. That co-design needs a single seam that
answers, for ANY backend: how much fast memory is there, who shares it, what
feeds it, and how is its capacity split among resident operands? This module
is that seam (see DESIGN.md §HardwareTarget):

  * :class:`MemoryHierarchy` — named levels with capacity / bandwidth /
    latency. MemPool's tile/group/cluster SPM view maps onto the TPU's
    VMEM / HBM / ICI / DCI ladder and onto the GPU's shared memory / L2 /
    HBM; all are instances of the same type.
  * :class:`CapacityPartition` — the planner's contract with a scratchpad
    level: a budget (capacity x fraction) split between *streamed* operands
    (multiplied by ``n_buffers`` for the DMA double-buffer pipeline, with a
    floor margin for partially-buffered flows — MemPool's quarter-tile
    slack) and *resident* state (accumulators, running SSM state).
  * :class:`TieredPartition` — a CapacityPartition stacked across two memory
    layers (the paper's logic-die / memory-die split): layer-0 and layer-1
    byte budgets under the same ``required_bytes`` contract. The serving
    pool partitions its paged KV cache with it (hot tier / spill tier).
  * a process-wide registry: :func:`get_target` / :func:`set_target` with an
    environment override (``REPRO_TARGET``, read via
    :mod:`repro_torch.runtime_flags`) so launchers and benchmarks select targets
    by name instead of importing profile constants.

Every profile in :mod:`repro_torch.core.hw_profiles` is registered at import time;
``TPU_V5E`` remains the process default so existing plans are unchanged
unless a target is selected.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

from repro_torch import runtime_flags
from repro_torch.core.hw_profiles import (GPU_PROFILES, MEMPOOL_PROFILES,
                                          TPU_PROFILES, TPU_V5E, GpuProfile,
                                          MemPoolProfile, TpuProfile)

Profile = Union[TpuProfile, MemPoolProfile, GpuProfile]


# ---------------------------------------------------------------------------
# Memory hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of a target's memory/interconnect hierarchy.

    ``capacity_bytes`` is ``None`` for pure transport levels (ICI/DCI links,
    MemPool's off-chip port). ``latency`` is in ``latency_unit`` — cycles for
    MemPool (the paper reports cycle counts), seconds for TPU estimates.
    """

    name: str
    capacity_bytes: Optional[int]
    bandwidth: Optional[float]          # bytes/s (TPU) or bytes/cycle (MemPool)
    latency: float
    latency_unit: str = "s"             # "s" | "cycles"
    shared_by: int = 1                  # compute units sharing this level


@dataclasses.dataclass(frozen=True)
class MemoryHierarchy:
    """Ordered levels, nearest (fastest) first."""

    levels: Tuple[MemoryLevel, ...]

    def level(self, name: str) -> MemoryLevel:
        for lv in self.levels:
            if lv.name == name:
                return lv
        raise KeyError(f"no memory level {name!r}; have "
                       f"{[lv.name for lv in self.levels]}")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(lv.name for lv in self.levels)


# ---------------------------------------------------------------------------
# Capacity partitioning — the budget contract every tile plan is checked
# against (repro_torch.core.tiling).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapacityPartition:
    """Split of a scratchpad budget among streamed and resident operands.

    ``required = ceil(mult * streamed) + resident`` with
    ``mult = max(n_buffers, 1 + db_margin)``: full double-buffering keeps
    ``n_buffers`` copies of every streamed operand; a partially-buffered flow
    (MemPool's DMA refill) instead reserves ``db_margin`` of one streamed set
    — the paper's quarter-tile slack (2 tiles x 0.125 = 0.25 t^2 words).
    """

    capacity_bytes: int
    fraction: float = 1.0          # share of the level the planner may claim
    n_buffers: int = 2             # copies of each streamed operand
    db_margin: float = 0.0         # floor on streaming slack (see above)
    align: int = 128               # block-edge granularity (MXU / bank rows)
    word_bytes: int = 2            # native streamed-element width (bf16 / f32)

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        if self.n_buffers < 1:
            raise ValueError(f"n_buffers must be >= 1, got {self.n_buffers}")

    @property
    def budget_bytes(self) -> int:
        return int(self.capacity_bytes * self.fraction)

    @property
    def streamed_multiplier(self) -> float:
        return max(float(self.n_buffers), 1.0 + self.db_margin)

    def required_bytes(self, streamed_bytes: int, resident_bytes: int = 0) -> int:
        """Scratchpad footprint of a candidate working set."""
        return (int(math.ceil(self.streamed_multiplier * streamed_bytes))
                + resident_bytes)

    def fits(self, streamed_bytes: int, resident_bytes: int = 0) -> bool:
        return self.required_bytes(streamed_bytes, resident_bytes) <= self.budget_bytes

    def with_buffers(self, n_buffers: int) -> "CapacityPartition":
        return dataclasses.replace(self, n_buffers=n_buffers)

    def scaled(self, shards: int) -> "CapacityPartition":
        """The aggregate partition a ``shards``-way mesh exposes: each shard
        contributes its own copy of this level, so the pool the planner
        prices against grows linearly — the paper's more-dies-more-capacity
        argument applied across chips instead of across bonded layers.
        ``shards=1`` is the identity (single-device budgets unchanged)."""
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards == 1:
            return self
        return dataclasses.replace(
            self, capacity_bytes=self.capacity_bytes * shards)

    def stacked(self, layer1_fraction: float) -> "TieredPartition":
        """Stack a second memory layer on this partition (the paper's 3D
        move): layer 0 keeps this budget, layer 1 adds
        ``layer1_fraction x capacity`` of the same level — a second die
        bonded on top, holding capacity the 2D floorplan could not."""
        if layer1_fraction < 0.0:
            raise ValueError(
                f"layer1_fraction must be >= 0, got {layer1_fraction}")
        layer1 = dataclasses.replace(
            self, capacity_bytes=int(self.capacity_bytes * layer1_fraction))
        return TieredPartition(layer0=self, layer1=layer1)


@dataclasses.dataclass(frozen=True)
class TieredPartition:
    """A :class:`CapacityPartition` split across two stacked memory layers.

    MemPool-3D's headline move is partitioning one logical memory across two
    bonded dies: layer 0 (the logic die's fast share) and layer 1 (the
    stacked memory die). The serving pool reuses the shape: layer 0 is the
    hot tier resident sequences decode against; layer 1 is the spill tier
    preempted sequences park in — same budget formula, one more layer.
    """

    layer0: CapacityPartition
    layer1: CapacityPartition

    @property
    def tiers(self) -> Tuple[CapacityPartition, ...]:
        return (self.layer0, self.layer1)

    @property
    def budget_bytes(self) -> int:
        """Combined two-layer budget (the 3D capacity win)."""
        return self.layer0.budget_bytes + self.layer1.budget_bytes

    def tier_budgets(self) -> Tuple[int, int]:
        return (self.layer0.budget_bytes, self.layer1.budget_bytes)

    def scaled(self, shards: int) -> "TieredPartition":
        """Scale both stacked layers by the mesh shard count (see
        :meth:`CapacityPartition.scaled`)."""
        if shards == 1:
            return self
        return TieredPartition(layer0=self.layer0.scaled(shards),
                               layer1=self.layer1.scaled(shards))

    def units_per_tier(self, unit_bytes, resident_bytes: int = 0
                       ) -> Tuple[int, int]:
        """How many ``unit_bytes``-sized blocks each layer sustains, pricing
        one unit with the SAME ``required_bytes`` contract the tile planner
        uses. ``resident_bytes`` is charged against layer 0 only (resident
        state never spills a layer down by itself).

        ``unit_bytes`` is one int when both layers store a unit identically,
        or a per-tier ``(layer0_bytes, layer1_bytes)`` pair when the tiers
        encode differently — tier-aware KV compression prices a page per
        CODEC, so a quantized tier fits more pages in the same budget
        (DESIGN.md §Tiered KV compression)."""
        per_tier = (unit_bytes if isinstance(unit_bytes, (tuple, list))
                    else (unit_bytes, unit_bytes))
        out = []
        for i, tier in enumerate(self.tiers):
            budget = tier.budget_bytes - (resident_bytes if i == 0 else 0)
            per = tier.required_bytes(per_tier[i])
            out.append(max(0, budget // max(per, 1)))
        return (out[0], out[1])


# ---------------------------------------------------------------------------
# HardwareTarget
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    """A backend the planner can size plans for.

    ``scratchpad_level`` names the hierarchy level whose capacity the tile
    planner partitions: VMEM on TPU, the full shared-L1 cluster SPM on
    MemPool (the paper's t-rule fills the whole pool), one block's shared
    memory on a GPU.
    """

    name: str
    kind: str                          # "tpu" | "mempool" | "gpu"
    hierarchy: MemoryHierarchy
    profile: Profile
    scratchpad_level: str
    tile_align: int                    # block-edge alignment for plans
    word_bytes: int                    # native word the capacity rule counts
    db_margin: float = 0.0             # default double-buffer floor margin

    @property
    def scratchpad_bytes(self) -> int:
        cap = self.hierarchy.level(self.scratchpad_level).capacity_bytes
        assert cap is not None, self.scratchpad_level
        return cap

    def partition(self, *, fraction: float = 1.0, n_buffers: int = 2,
                  db_margin: Optional[float] = None) -> CapacityPartition:
        """A :class:`CapacityPartition` of this target's scratchpad."""
        return CapacityPartition(
            capacity_bytes=self.scratchpad_bytes, fraction=fraction,
            n_buffers=n_buffers,
            db_margin=self.db_margin if db_margin is None else db_margin,
            align=self.tile_align, word_bytes=self.word_bytes)


def tpu_target(profile: TpuProfile) -> HardwareTarget:
    """VMEM / HBM / ICI / DCI — the TPU instance of the hierarchy.

    Latencies are public-order-of-magnitude estimates; planning uses only
    capacities and bandwidths.
    """
    hierarchy = MemoryHierarchy(levels=(
        MemoryLevel("vmem", profile.vmem_bytes, None, 30e-9, "s", 1),
        MemoryLevel("hbm", profile.hbm_bytes, profile.hbm_bw, 500e-9, "s", 1),
        MemoryLevel("ici", None, profile.ici_bw_total, 1e-6, "s",
                    shared_by=256),
        MemoryLevel("dci", None, profile.dci_bw, 10e-6, "s", shared_by=512),
    ))
    return HardwareTarget(
        name=profile.name, kind="tpu", hierarchy=hierarchy, profile=profile,
        scratchpad_level="vmem", tile_align=profile.mxu_dim, word_bytes=2)


#: MemPool bank-interleaving alignment: 4 banks/core x 8 interleave rows.
MEMPOOL_TILE_ALIGN = 32
#: The paper's quarter-tile double-buffer slack: 2 streamed tiles x 0.125
#: = 0.25 t^2 words on top of the 3 resident tiles (working set 3.25 t^2).
MEMPOOL_DB_MARGIN = 0.125


def mempool_target(profile: MemPoolProfile) -> HardwareTarget:
    """tile / group / cluster / off-chip — the MemPool instance."""
    hierarchy = MemoryHierarchy(levels=(
        MemoryLevel("tile", profile.spm_per_tile, None,
                    profile.latency_local, "cycles",
                    shared_by=profile.n_cores // profile.n_tiles),
        MemoryLevel("group", profile.spm_bytes // profile.n_groups, None,
                    profile.latency_group, "cycles",
                    shared_by=profile.n_cores // profile.n_groups),
        MemoryLevel("cluster", profile.spm_bytes, None,
                    profile.latency_cluster, "cycles",
                    shared_by=profile.n_cores),
        MemoryLevel("offchip", None, None, 100.0, "cycles",
                    shared_by=profile.n_cores),
    ))
    return HardwareTarget(
        name=profile.name.lower(), kind="mempool", hierarchy=hierarchy,
        profile=profile, scratchpad_level="cluster",
        tile_align=MEMPOOL_TILE_ALIGN, word_bytes=profile.word_bytes,
        db_margin=MEMPOOL_DB_MARGIN)


#: GPU block-edge alignment. 32 is the coarsest edge at which the plans for
#: scratchpad fractions 0.125 / 0.25 / 0.5 / 0.75 of an H100 block's shared
#: memory are four distinct tiles that all fit, for bf16 and for f32 (at 64
#: the 0.125 plan no longer fits). It is also a warp's width.
GPU_TILE_ALIGN = 32


def gpu_target(profile: GpuProfile) -> HardwareTarget:
    """smem / L2 / HBM — the GPU instance. The scratchpad is the shared
    memory one thread block may claim; L2 is shared by every SM.

    Latencies are public-order-of-magnitude estimates; planning uses only
    capacities and bandwidths.
    """
    hierarchy = MemoryHierarchy(levels=(
        MemoryLevel("smem", profile.smem_per_block, None, 30e-9, "s", 1),
        MemoryLevel("l2", profile.l2_bytes, None, 200e-9, "s",
                    shared_by=profile.n_sms),
        MemoryLevel("hbm", profile.hbm_bytes, profile.hbm_bw, 500e-9, "s",
                    shared_by=profile.n_sms),
    ))
    return HardwareTarget(
        name=profile.name, kind="gpu", hierarchy=hierarchy, profile=profile,
        scratchpad_level="smem", tile_align=GPU_TILE_ALIGN, word_bytes=2)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_REGISTRY: Dict[str, HardwareTarget] = {}
_CURRENT: Optional[HardwareTarget] = None


def _norm(name: str) -> str:
    return name.lower().replace("_", "-")


def register_target(target: HardwareTarget) -> HardwareTarget:
    with _LOCK:
        _REGISTRY[_norm(target.name)] = target
    return target


def available_targets(kind: Optional[str] = None) -> Tuple[str, ...]:
    with _LOCK:
        return tuple(sorted(n for n, t in _REGISTRY.items()
                            if kind is None or t.kind == kind))


def get_target(name: Optional[str] = None) -> HardwareTarget:
    """Resolve a target: explicit name > set_target() > $REPRO_TARGET > default."""
    if name is not None:
        return _lookup(name)
    if _CURRENT is not None:
        return _CURRENT
    env = runtime_flags.target_name()
    if env:
        return _lookup(env)
    return _lookup(TPU_V5E.name)


def _lookup(name: str) -> HardwareTarget:
    try:
        with _LOCK:
            return _REGISTRY[_norm(name)]
    except KeyError:
        raise KeyError(f"unknown hardware target {name!r}; available: "
                       f"{', '.join(available_targets())}") from None


def set_target(target: Union[HardwareTarget, str, None]) -> Optional[HardwareTarget]:
    """Set the process-wide current target (by name or instance).

    ``None`` clears the override (falls back to env/default). Returns the
    previously set target (``None`` if the default was in effect).
    """
    global _CURRENT
    if isinstance(target, str):
        target = _lookup(target)
    with _LOCK:
        prev, _CURRENT = _CURRENT, target
    return prev


@contextlib.contextmanager
def use_target(target: Union[HardwareTarget, str]) -> Iterator[HardwareTarget]:
    prev = set_target(target)
    try:
        yield get_target()
    finally:
        set_target(prev)


for _p in TPU_PROFILES.values():
    register_target(tpu_target(_p))
for _p in MEMPOOL_PROFILES.values():
    register_target(mempool_target(_p))
for _p in GPU_PROFILES.values():
    register_target(gpu_target(_p))
del _p
