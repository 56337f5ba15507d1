"""Continuous-batching scheduler: request queue, slot table, page allocator.

The serving engine treats the KV cache as a *pool of slots* — one resident
sequence per slot, all slots decoded in a single batched step. This module
owns everything about slots and pages that is NOT device math:

  * :class:`Request` — one user request and its lifecycle
    (``queued -> prefilling -> decoding -> drained``, with a
    ``preempted`` detour in paged mode).
  * :class:`SlotTable` — which request occupies which KV slot, with per-slot
    allocation counters (slot *reuse* is the whole point: a drained slot is
    immediately refilled from the queue without touching in-flight rows).
  * :class:`PagePool` / :class:`PageGeometry` — the paged two-tier KV pool:
    KV storage is a flat pool of fixed-size pages; each slot maps logical
    page indices to physical pages through a block table. Admission is by
    *pages*, not slots (pages for ``prompt + chunk`` only, grown at each
    boundary), so short requests stop paying worst-case ``max_len``
    reservations. When layer 0 (the hot tier) is exhausted, the youngest
    resident sequence is preempted: its pages spill verbatim to layer 1
    (the stacked spill tier) and are dereferenced; a later restore copies
    them back and decoding resumes bit-exactly.
  * :class:`PrefixIndex` — content index over resident full pages for
    ref-counted prefix sharing: admissions whose prompt prefix is already
    cached map the shared pages read-only and prefill only the suffix,
    with the frontier page copied-on-write so decode never mutates another
    request's history (DESIGN.md §Prefix sharing & copy-on-write).
  * :class:`Scheduler` — admission policy. ``fcfs`` admits in arrival order
    (the fairness default); ``shortest`` admits the shortest queued prompt
    first (throughput-greedy, can starve long prompts — benchmarks only).

Slot and page budgets = the paper's capacity partition, applied to serving.
The dense slot count is derived from the active :class:`~repro_torch.core.target.
HardwareTarget` through the SAME :class:`~repro_torch.core.target.
CapacityPartition` budget formula the tile planner uses for kernel blocks.
The paged pool stacks that partition across two memory layers
(:class:`~repro_torch.core.target.TieredPartition` — MemPool-3D's logic-die /
memory-die split): layer 0 prices the hot page pool, layer 1 the spill
pool. MemPool's lesson — one logical pool, explicitly partitioned — decides
how many sequences may be resident, and the 3D lesson — stack a second
layer instead of stretching the first — decides where preempted sequences
park.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.target import (CapacityPartition, HardwareTarget,
                               TieredPartition, get_target)
from repro_torch.models.config import ModelConfig

#: Request lifecycle states (DESIGN.md §Serving — slot lifecycle).
QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
DRAINED = "drained"
REJECTED = "rejected"      # invalid for the pool (e.g. prompt > max_len)
PREEMPTED = "preempted"    # spilled to layer 1, waiting to be restored
PARKED = "parked"          # serialized to the layer-2 host tier; a resumed
                           # submission re-enters admission with its KV intact

#: Engine role names (DESIGN.md §Disaggregated serving). Routing a slot to
#: a role is a *scheduling* decision, so the canonical definitions live
#: here; ``serve/pool.py`` and the engine re-export them. The prefill role
#: runs admissions and prompt chunks; the decode role runs the batched
#: decode/verify forwards; a combined engine is both at once.
PREFILL_ROLE = "prefill"
DECODE_ROLE = "decode"


@dataclasses.dataclass
class Request:
    """One generation request moving through the slot lifecycle."""

    rid: int
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int
    status: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    # lifecycle clocks, in decode steps of the serve loop (latency accounting)
    submit_step: int = 0
    admit_step: int = -1
    first_step: int = -1                # first output token produced
    # host clock (time.perf_counter) at the drain that delivered the first
    # output token: the benchmark's wall-clock TTFT
    first_wall: float = -1.0
    finish_step: int = -1
    # chunked prefill (DESIGN.md §Chunked prefill): how many prompt tokens
    # (including any shared prefix) have KV cached so far. -1 = unchunked
    # admission, which prefills the whole prompt in one boundary. The cursor
    # survives preemption: a restored request resumes its next chunk here.
    prefill_pos: int = -1
    # paged mode: physical pages mapped to this request (layer 0 / layer 1)
    pages: List[int] = dataclasses.field(default_factory=list)
    spill_pages: List[int] = dataclasses.field(default_factory=list)
    spill_seat: int = -1                # layer-1 seat for resident SSM state
    preemptions: int = 0
    # prefix sharing (DESIGN.md §Prefix sharing & copy-on-write): tokens of
    # the prompt served from already-resident shared pages, how many leading
    # entries of ``pages`` are shared (refcounted, read-only) mappings, and
    # the source page a partially-matched frontier page is COW-copied from.
    prefix_len: int = 0
    n_shared: int = 0
    cow_src: int = -1
    # disaggregated serving (DESIGN.md §Disaggregated serving): which engine
    # role this request's pool work is routed to. "" in combined mode; set
    # to PREFILL_ROLE at admission and flipped to DECODE_ROLE by the
    # HandoverStep at the final prefill chunk. Survives preemption — a
    # mid-decode spill restores straight into the decode role.
    owner: str = ""

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])

    @property
    def cache_len(self) -> int:
        """Host-side mirror of the device ``cache_len``: the filled KV
        prefix. The last emitted token's K/V is written by the NEXT decode
        step, so the frontier is one behind the emitted count. Mid-chunked-
        prefill (no tokens yet, cursor short of the prompt) the frontier is
        the cursor itself."""
        if not self.tokens and 0 <= self.prefill_pos < self.prompt_len:
            return self.prefill_pos
        return self.prompt_len + max(len(self.tokens) - 1, 0)


# ---------------------------------------------------------------------------
# Slot budget — CapacityPartition applied to the KV pool
# ---------------------------------------------------------------------------


def kv_bytes_per_token(cfg: ModelConfig, cache_dtype_bytes: int = 2) -> int:
    """KV-pool bytes one resident sequence streams per cached token.

    Attention layers scale with sequence length (this function); recurrent
    SSM state does not and is priced separately by
    :func:`resident_bytes_per_slot`.
    """
    total = 0
    for group in cfg.layer_groups():
        for kind in group.pattern:
            if kind.attn == "mamba":
                continue
            if kind.attn == "mla":
                per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            else:
                per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
            total += group.n_repeat * per_tok * cache_dtype_bytes
    return total


def kv_scale_bytes_per_page(cfg: ModelConfig) -> int:
    """Per-page overhead of a *scaled* codec (DESIGN.md §Tiered KV
    compression): one f32 scale per page per KV leaf — two leaves per
    attention layer (k/v, or the MLA ckv/krope pair), stored alongside the
    block table and priced into the page so quantized geometry never
    overcommits the byte budget."""
    total = 0
    for group in cfg.layer_groups():
        for kind in group.pattern:
            if kind.attn == "mamba":
                continue
            total += group.n_repeat * 2 * 4
    return total


def kv_shards(cfg: ModelConfig, model_shards: int = 1) -> int:
    """How many ways the KV pool actually shards over the `model` axis.

    Head-axis page placement (DESIGN.md §Sharded serving) only scales pool
    capacity when EVERY seq-scaling cache in the model carries a head axis
    the mesh divides: GQA caches shard ``n_kv_heads`` ways at best; the MLA
    latent and recurrent SSM state have no head axis and replicate. Mirrors
    the divisibility gate in the reference's ``repro.models.attention``
    (heads_divide) — a
    pool priced ``m``-ways-bigger than the arrays actually shard would
    OOM layer 0, so this is deliberately all-or-nothing.
    """
    if model_shards <= 1:
        return 1
    saw_attention = False
    for group in cfg.layer_groups():
        for kind in group.pattern:
            if kind.attn == "mamba":
                continue                      # per-slot state, replicated
            if kind.attn == "mla":
                return 1                      # latent pages replicate
            if cfg.n_kv_heads % model_shards != 0:
                return 1
            saw_attention = True
    return model_shards if saw_attention else 1


def resident_bytes_per_slot(cfg: ModelConfig, state_dtype_bytes: int = 4) -> int:
    """Sequence-length-independent per-slot state (conv + SSM recurrences)."""
    total = 0
    for group in cfg.layer_groups():
        for kind in group.pattern:
            if kind.attn != "mamba":
                continue
            conv = (cfg.ssm_conv - 1) * cfg.ssm_d_inner
            ssm = cfg.ssm_d_inner * cfg.ssm_d_state
            total += group.n_repeat * (conv + ssm) * state_dtype_bytes
    return total


def pool_partition(target: Optional[HardwareTarget] = None, *,
                   fraction: float = 0.8) -> CapacityPartition:
    """A :class:`CapacityPartition` of the target's KV-pool memory level.

    The pool level is the level that *feeds* the scratchpad: HBM on TPU
    targets, the whole shared-L1 cluster SPM on MemPool (where the paper's
    pool IS the scratchpad). ``n_buffers=1``: KV rows are resident for a
    sequence's lifetime, not double-buffered tiles — but the budget formula
    (``required = ceil(mult * streamed) + resident <= capacity * fraction``)
    is the same contract the tile planner enforces.
    """
    target = target or get_target()
    names = target.hierarchy.names
    level = target.hierarchy.level(
        "hbm" if "hbm" in names else target.scratchpad_level)
    assert level.capacity_bytes is not None, level.name
    return CapacityPartition(
        capacity_bytes=level.capacity_bytes, fraction=fraction, n_buffers=1,
        db_margin=0.0, align=target.tile_align, word_bytes=target.word_bytes)


def derive_n_slots(cfg: ModelConfig, max_len: int, *,
                   target: Optional[HardwareTarget] = None,
                   fraction: float = 0.8, max_slots: int = 64,
                   cache_dtype_bytes: int = 2,
                   pages: Optional["PageGeometry"] = None,
                   model_shards: int = 1, data_shards: int = 1) -> int:
    """How many KV slots the pool sustains.

    Dense (``pages=None``): every slot reserves a full ``max_len`` KV slab,
    so slots = budget // slab. Paged: a slot only needs one mapped page to
    be resident, so the same byte budget carries ``n_data_pages`` slots in
    the best case — the two-tier pool's capacity win. Admission by pages
    keeps actual residency honest.

    Mesh shards scale the budget, not the per-slot price: a ``model_shards``
    mesh holds ``kv_shards`` pool slices (head-axis placement), a
    ``data_shards`` mesh splits the batch axis, so the aggregate is
    ``device_count * per_device`` slots (the MaxText decode-microbenchmark
    shape) — with ``max_slots`` scaled the same way so a single shard's cap
    stays what it was. Both default to 1 = single-device budgets unchanged.
    """
    scale = kv_shards(cfg, model_shards) * max(1, data_shards)
    cap = max_slots * scale
    if pages is not None:
        return int(max(1, min(pages.n_data_pages, cap)))
    part = pool_partition(target, fraction=fraction).scaled(scale)
    per_slot = part.required_bytes(
        kv_bytes_per_token(cfg, cache_dtype_bytes) * max_len,
        resident_bytes_per_slot(cfg))
    n = part.budget_bytes // max(per_slot, 1)
    return int(max(1, min(n, cap)))


def derive_prefill_chunk(cfg: ModelConfig, *,
                         target: Optional[HardwareTarget] = None,
                         fraction: float = 0.25, max_chunk: int = 512,
                         cache_dtype_bytes: int = 2) -> int:
    """Per-boundary prefill-token budget (DESIGN.md §Chunked prefill).

    Priced through the SAME :class:`CapacityPartition` formula that prices
    tiles, slots, and pages — here over the compute tier (the scratchpad
    level): one prefill token streams its KV write row plus one activation
    row, double-buffered like a kernel tile (``n_buffers=2``: the next
    chunk stages while the current one computes). The budget is the
    largest power of two whose streamed bytes fit ``fraction`` of the
    level, so derived chunk lengths land exactly on the engine's bucketed
    jit variants (O(log) compiled shapes).

    The level is the target's ``stream_level`` where it names one (L2 on
    a GPU: a chunk's rows pass between kernels through L2, not through
    one block's shared memory), else the scratchpad; only the level
    differs from the reference's formula.
    """
    target = target or get_target()
    level = target.hierarchy.level(
        target.stream_level or target.scratchpad_level)
    assert level.capacity_bytes is not None, level.name
    part = CapacityPartition(
        capacity_bytes=level.capacity_bytes, fraction=fraction, n_buffers=2,
        db_margin=0.0, align=target.tile_align, word_bytes=target.word_bytes)
    per_tok = (kv_bytes_per_token(cfg, cache_dtype_bytes)
               + target.word_bytes * cfg.d_model)
    n = 1
    while n * 2 <= max_chunk and part.fits(per_tok * n * 2):
        n *= 2
    return n


def derive_speculate_tokens(cfg: ModelConfig, *,
                            target: Optional[HardwareTarget] = None,
                            fraction: float = 0.0625, max_tokens: int = 8,
                            cache_dtype_bytes: int = 2) -> int:
    """Per-boundary draft budget k (DESIGN.md §Speculative decoding).

    The verify forward is a width-(k+1) decode chunk, so k is priced
    exactly like :func:`derive_prefill_chunk` — each speculated position
    streams a KV write row plus an activation row through the compute
    tier, double-buffered — just against a much smaller ``fraction`` of
    the scratchpad level: the verify chunk rides alongside decode's
    full-pool KV sweep instead of owning the boundary the way a prefill
    chunk does. The budget is the largest power of two that fits, so
    verify-chunk widths (k+1) land on a handful of compiled shapes; k=0
    on a target too small to fit even one draft token disables
    speculation rather than thrashing the scratchpad. The level is
    chosen as in :func:`derive_prefill_chunk`.
    """
    target = target or get_target()
    level = target.hierarchy.level(
        target.stream_level or target.scratchpad_level)
    assert level.capacity_bytes is not None, level.name
    part = CapacityPartition(
        capacity_bytes=level.capacity_bytes, fraction=fraction, n_buffers=2,
        db_margin=0.0, align=target.tile_align, word_bytes=target.word_bytes)
    per_tok = (kv_bytes_per_token(cfg, cache_dtype_bytes)
               + target.word_bytes * cfg.d_model)
    if not part.fits(per_tok):
        return 0
    n = 1
    while n * 2 <= max_tokens and part.fits(per_tok * n * 2):
        n *= 2
    return n


# ---------------------------------------------------------------------------
# Paged two-tier pool — PageGeometry, tiers, and the page allocator
# ---------------------------------------------------------------------------


def pool_tiers(target: Optional[HardwareTarget] = None, *,
               fraction: float = 0.8,
               layer1_fraction: Optional[float] = None) -> TieredPartition:
    """The KV pool partition, stacked across two memory layers.

    Layer 0 is :func:`pool_partition`'s budget (the hot tier resident
    sequences decode against); layer 1 is the stacked spill tier. The
    default split mirrors the paper's die split: a MemPool-3D target gets a
    full second layer (``layer1_fraction=1.0`` — the bonded memory die
    doubles capacity at iso-footprint); 2D and TPU targets get a half-layer
    spill budget (cold capacity behind the same port).
    """
    target = target or get_target()
    if layer1_fraction is None:
        flow = getattr(target.profile, "flow", None)
        layer1_fraction = 1.0 if flow == "3D" else 0.5
    return pool_partition(target, fraction=fraction).stacked(layer1_fraction)


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Shape of the paged two-tier KV pool.

    Physical page 0 of EACH tier is the reserved *null page*: block-table
    entries of free or out-of-range positions point at it, so stray writes
    (a drained slot's frozen decode, scatter tails past a prompt) land in
    memory no live sequence ever reads. Allocators hand out pages
    ``1..n_pages-1``.
    """

    page_tokens: int            # tokens per page
    n_pages: int                # layer-0 physical pages, incl. null page 0
    n_spill_pages: int          # layer-1 physical pages, incl. null page 0
    max_pages_per_slot: int     # block-table width: ceil(max_len/page_tokens)
    page_bytes: int             # KV bytes of one layer-0 page, at its codec
    # tier codecs (DESIGN.md §Tiered KV compression): how each tier encodes
    # page bytes. "fp16" is the identity (bit-exact, the default); quantized
    # codecs shrink page_bytes so the same budget holds more pages. The
    # spill tier may encode differently (spill_page_bytes prices it).
    layer0_codec: str = "fp16"
    layer1_codec: str = "fp16"
    spill_page_bytes: Optional[int] = None   # None -> same as page_bytes

    @property
    def depth(self) -> int:
        """Per-slot logical KV depth (>= max_len, page-aligned)."""
        return self.max_pages_per_slot * self.page_tokens

    @property
    def n_data_pages(self) -> int:
        return self.n_pages - 1

    @property
    def n_spill_data_pages(self) -> int:
        return self.n_spill_pages - 1

    @property
    def layer0_bytes(self) -> int:
        return self.n_data_pages * self.page_bytes

    @property
    def layer1_bytes(self) -> int:
        per = (self.spill_page_bytes if self.spill_page_bytes is not None
               else self.page_bytes)
        return self.n_spill_data_pages * per

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to map ``n_tokens`` of KV (at least one)."""
        return max(1, -(-int(n_tokens) // self.page_tokens))


def derive_page_geometry(cfg: ModelConfig, max_len: int, *,
                         target: Optional[HardwareTarget] = None,
                         fraction: float = 0.8,
                         layer1_fraction: Optional[float] = None,
                         page_tokens: int = 16, max_slots: int = 64,
                         cache_dtype_bytes: int = 2,
                         layer0_bytes: Optional[int] = None,
                         layer1_bytes: Optional[int] = None,
                         model_shards: int = 1,
                         kv_quant: Optional[str] = None) -> PageGeometry:
    """Page count, page size, and spill budget from the two-tier partition.

    ``layer0_bytes``/``layer1_bytes`` override the derived tier budgets —
    benchmarks use them to compare dense and paged pools inside the SAME
    layer-0 byte budget, and to force the spill tier into play on small
    smoke runs. Page counts are capped at ``max_slots`` full-depth
    sequences so host-scale targets do not allocate absurd pools.

    ``model_shards > 1`` prices pages against the mesh's aggregate pool:
    head-axis placement (when :func:`kv_shards` says the caches actually
    shard) means each shard physically holds ``1/kv_shards`` of every
    page's bytes, so the same per-shard layer-0 budget carries
    ``kv_shards``x the pages — the paper's die-level capacity split across
    chips. Byte overrides are per-shard budgets and scale the same way;
    the per-slot cap scales so one shard's worst case is unchanged.

    ``kv_quant`` picks the tier codecs (DESIGN.md §Tiered KV compression):
    each tier's page is priced at ITS codec's bytes-per-value (plus the
    per-page scale overhead for scaled codecs), so a quantized layer 0
    yields ~2x the pages in the same byte budget — the residency win the
    paper's capacity-per-byte argument predicts.
    """
    from repro_torch.serve.pool import CODECS, quant_policy   # pool imports us
    l0_name, l1_name = quant_policy(kv_quant)
    l0, l1 = CODECS[l0_name], CODECS[l1_name]
    if (l0.name != "fp16" or l1.name != "fp16") and any(
            kind.attn == "mamba"
            for group in cfg.layer_groups() for kind in group.pattern):
        raise ValueError(
            "quantized KV pages require attention-only models: recurrent "
            "SSM state integrates every step and has no bounded per-page "
            "error story (docs/SERVING.md)")
    pt = int(max(1, min(page_tokens, max_len)))
    p_max = -(-int(max_len) // pt)

    def tier_page_bytes(codec) -> int:
        bpv = codec.bytes_per_value if kv_quant else cache_dtype_bytes
        per = kv_bytes_per_token(cfg, bpv) * pt
        if codec.scaled:
            per += kv_scale_bytes_per_page(cfg)
        return per

    page_bytes = tier_page_bytes(l0)
    spill_page_bytes = tier_page_bytes(l1)
    shards = kv_shards(cfg, model_shards)
    tiers = pool_tiers(target, fraction=fraction,
                       layer1_fraction=layer1_fraction).scaled(shards)
    resident = resident_bytes_per_slot(cfg) * max_slots
    n0, n1 = tiers.units_per_tier((page_bytes, spill_page_bytes), resident)
    if layer0_bytes is not None:
        n0 = (layer0_bytes * shards) // max(page_bytes, 1)
    if layer1_bytes is not None:
        n1 = (layer1_bytes * shards) // max(spill_page_bytes, 1)
    cap = max_slots * p_max * shards
    n0, n1 = min(int(n0), cap), min(int(n1), cap)
    if n0 < p_max:
        raise ValueError(
            f"layer-0 budget holds {n0} pages but one full-depth sequence "
            f"needs {p_max} (max_len={max_len}, page_tokens={pt}); raise the "
            f"budget or shrink max_len")
    return PageGeometry(page_tokens=pt, n_pages=n0 + 1,
                        n_spill_pages=max(n1, 0) + 1,
                        max_pages_per_slot=p_max, page_bytes=page_bytes,
                        layer0_codec=l0.name, layer1_codec=l1.name,
                        spill_page_bytes=spill_page_bytes)


class PagePool:
    """Ref-counted free-list allocator over a tier's pages (1..n_pages-1).

    Page 0 is the reserved null page and is never handed out. Allocation is
    all-or-nothing and hands out pages at refcount 1; :meth:`share` adds a
    reader to an already-mapped page (prefix sharing — DESIGN.md §Prefix
    sharing & copy-on-write); :meth:`free` drops one reference per page and
    only returns a page to the free list (LIFO, so reuse stays hot) when its
    refcount hits zero — a shared page stays resident for its other readers.
    Double-free (freeing an unmapped page) and foreign pages raise.

    ``in_use`` counts *physical* pages off the free list; ``mapped`` counts
    *logical* mappings (the sum of refcounts == block-table entries across
    all readers). ``mapped / in_use`` is the sharing factor.
    """

    def __init__(self, n_pages: int, name: str = "layer0"):
        if n_pages < 1:
            raise ValueError(f"need at least the null page, got {n_pages}")
        self.n_pages = n_pages
        self.name = name
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs = [0] * n_pages
        self.high_water = 0
        self.mapped = 0
        self.mapped_high_water = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages or None (all-or-nothing; never partial)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for p in out:
            self._refs[p] = 1
        self.mapped += n
        self.high_water = max(self.high_water, self.in_use)
        self.mapped_high_water = max(self.mapped_high_water, self.mapped)
        return out

    def share(self, pages: Sequence[int]) -> None:
        """Add one reader to each (already-mapped) page."""
        for p in pages:
            if not 1 <= p < self.n_pages:
                raise ValueError(f"page {p} outside {self.name} pool "
                                 f"(1..{self.n_pages - 1})")
            if self._refs[p] < 1:
                raise RuntimeError(
                    f"sharing unmapped {self.name} page {p} (refcount 0)")
            self._refs[p] += 1
        self.mapped += len(pages)
        self.mapped_high_water = max(self.mapped_high_water, self.mapped)

    def free(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages actually released
        to the free list (refcount reached zero) so callers can drop any
        content-index entries for them."""
        released: List[int] = []
        for p in pages:
            if not 1 <= p < self.n_pages:
                raise ValueError(f"page {p} outside {self.name} pool "
                                 f"(1..{self.n_pages - 1})")
            if p in self._free_set or self._refs[p] < 1:
                raise RuntimeError(f"double free of {self.name} page {p}")
            self._refs[p] -= 1
            self.mapped -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                self._free_set.add(p)
                released.append(p)
        return released


class PrefixIndex:
    """Content index over resident full KV pages: chained token-id hash per
    full page -> the physical layer-0 page caching exactly that prefix.

    The key of logical page ``i`` hashes page ``i``'s token ids together
    with page ``i-1``'s key, so a hit at page ``i`` implies the WHOLE
    prefix up to ``(i+1) * page_tokens`` tokens matches — matching is a walk
    from page 0 that stops at the first miss. Only *full* pages are ever
    indexed (a partial tail page will receive decode writes and is never
    shareable), and an entry lives exactly as long as its page is mapped:
    the scheduler calls :meth:`forget` with whatever :meth:`PagePool.free`
    released. See DESIGN.md §Prefix sharing & copy-on-write.
    """

    _SEED = b"kv-prefix-index-v1"

    def __init__(self, page_tokens: int):
        self.page_tokens = int(page_tokens)
        self._by_key: Dict[bytes, int] = {}
        self._by_page: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def keys_for(self, prompt: Sequence[int]) -> List[bytes]:
        """One chained key per full page of ``prompt``."""
        toks = np.asarray(prompt, np.int32)
        out: List[bytes] = []
        prev = self._SEED
        for i in range(toks.shape[0] // self.page_tokens):
            page = toks[i * self.page_tokens:(i + 1) * self.page_tokens]
            prev = hashlib.blake2b(prev + page.tobytes(),
                                   digest_size=16).digest()
            out.append(prev)
        return out

    def match(self, prompt: Sequence[int]) -> List[int]:
        """Physical pages of the longest indexed full-page prefix."""
        pages: List[int] = []
        for key in self.keys_for(prompt):
            page = self._by_key.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def register(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Index a freshly admitted request's full prompt pages.

        ``pages[i]`` is the physical page at logical index ``i``. Keys that
        are already indexed keep their canonical page (the new request maps
        that very page when it was a hit, or holds a duplicate it prefilled
        itself when admitted in the same boundary as the canonical).
        Returns the number of newly indexed pages.
        """
        n = 0
        for key, page in zip(self.keys_for(prompt), pages):
            if key in self._by_key or page in self._by_page:
                continue
            self._by_key[key] = page
            self._by_page[page] = key
            n += 1
        return n

    def forget(self, pages: Sequence[int]) -> None:
        """Drop entries for pages released back to the free list."""
        for p in pages:
            key = self._by_page.pop(p, None)
            if key is not None:
                self._by_key.pop(key, None)


@dataclasses.dataclass
class PrefillStep:
    """One chunk of a request's prompt to prefill this boundary
    (DESIGN.md §Chunked prefill): tokens ``[start, start + n_tokens)`` of
    ``req.prompt``, written into the request's own pages (dense mode: its
    slot slab). ``final`` marks the chunk that reaches the end of the
    prompt — it emits the request's first output token and arms the slot
    for decode, exactly like an unchunked admission."""

    slot: int
    req: Request
    start: int
    n_tokens: int
    final: bool


@dataclasses.dataclass
class HandoverStep:
    """One page handover (DESIGN.md §Disaggregated serving): at a request's
    final prefill chunk its slot — and every page mapped to it — moves from
    the prefill role to the decode role. Zero KV copies: the pages already
    live in the shared layer-0 arrays both roles compute against, so the
    engine executes this as one ownership-table flip
    (:meth:`repro_torch.serve.pool.PoolManager.transfer_ownership`) and the
    decode role's next block-table upload carries the row."""

    slot: int
    req: Request
    pages: List[int]


@dataclasses.dataclass
class SpillAction:
    """One preemption: copy ``src_pages`` (layer 0) to ``dst_pages``
    (layer 1) and, for models with resident SSM state, slot row -> seat."""

    slot: int
    req: Request
    src_pages: List[int]
    dst_pages: List[int]
    seat: int


@dataclasses.dataclass
class RestoreAction:
    """The inverse copy: layer-1 ``src_pages`` back into the request's
    freshly allocated layer-0 pages (``req.pages`` prefix), seat -> slot."""

    slot: int
    req: Request
    src_pages: List[int]
    seat: int


@dataclasses.dataclass
class ResumeStep:
    """One layer-2 resume (DESIGN.md §Tiered KV compression & host
    parking): a parked session re-admitted with its KV intact. The engine
    scatters the parked page contents (held host-side since
    ``Engine.park_request``) into the PRIVATE tail of ``req.pages`` —
    logical pages ``req.n_shared..`` — and re-arms the slot vectors; the
    leading ``n_shared`` pages were re-matched through the prefix index
    and map read-only, exactly like a shared admission."""

    slot: int
    req: Request


@dataclasses.dataclass
class PagePlan:
    """Everything one drain boundary decided; the engine executes the device
    copies in EXACTLY this order (spills read layer 0 before any restore or
    admission writes it; restores read layer 1 before later spills could
    reuse freed spill pages — the allocator's alloc-before-free discipline
    inside :meth:`Scheduler.plan_boundary` guarantees id-disjointness)."""

    spills: List[SpillAction] = dataclasses.field(default_factory=list)
    restores: List[RestoreAction] = dataclasses.field(default_factory=list)
    admits: List[Tuple[int, Request]] = dataclasses.field(default_factory=list)
    rejects: List[Request] = dataclasses.field(default_factory=list)
    # chunked prefill only: executed AFTER spills/restores/admit bookkeeping,
    # in list order (residents resume oldest-first before fresh admissions,
    # so a canonical prefix finishes before a same-boundary matcher reads it)
    prefill_steps: List[PrefillStep] = dataclasses.field(default_factory=list)
    # disaggregated serving only: ownership flips for requests whose prompt
    # completes THIS boundary — executed after their final prefill chunk,
    # before the decode role's block-table upload
    handovers: List[HandoverStep] = dataclasses.field(default_factory=list)
    # layer-2 host tier only: parked sessions re-admitted this boundary —
    # executed after restores (their scatters write freshly allocated pages)
    # and before admits (a same-boundary admission may prefix-match pages a
    # resume just repopulated)
    resumes: List[ResumeStep] = dataclasses.field(default_factory=list)


def percentile(xs: Sequence[float], q: float) -> float:
    """Percentile with an empty-list guard — shared by the stream driver
    and serve_bench so their latency columns agree on the edge cases."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else 0.0


def synthetic_stream(n_requests: int, prompt_len: int, gen_len: int,
                     vocab: int, seed: int = 0) -> List[Dict[str, Any]]:
    """The canonical mixed-length synthetic workload: prompt lengths in
    [prompt_len/2, prompt_len], budgets in [gen_len/2, gen_len]. Shared by
    the stream driver and the serving benchmark so the serve_bench.json
    datapoint measures exactly what ``--stream`` drives."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_requests):
        plen = int(rng.randint(max(1, prompt_len // 2), prompt_len + 1))
        glen = int(rng.randint(max(1, gen_len // 2), gen_len + 1))
        out.append({"prompt": rng.randint(2, vocab,
                                          size=plen).astype(np.int32),
                    "max_new_tokens": glen})
    return out


def shared_prefix_stream(n_requests: int, system_len: int, suffix_len: int,
                         gen_len: int, vocab: int,
                         seed: int = 0) -> List[Dict[str, Any]]:
    """The shared-system-prompt workload: every request is one common
    ``system_len``-token prefix followed by a unique tail of up to
    ``suffix_len`` tokens — the traffic shape prefix sharing is built for
    (shared system prompts, few-shot templates). Shared by the stream
    driver and ``serve_bench --prefix-share`` so the benchmark's
    residency/TTFT datapoints measure exactly what ``--stream`` drives."""
    rng = np.random.RandomState(seed)
    system = rng.randint(2, vocab, size=int(system_len)).astype(np.int32)
    out = []
    for _ in range(n_requests):
        slen = int(rng.randint(max(1, suffix_len // 2), suffix_len + 1))
        glen = int(rng.randint(max(1, gen_len // 2), gen_len + 1))
        tail = rng.randint(2, vocab, size=slen).astype(np.int32)
        out.append({"prompt": np.concatenate([system, tail]),
                    "max_new_tokens": glen})
    return out


def repetitive_stream(n_requests: int, prompt_len: int, gen_len: int,
                      vocab: int, seed: int = 0,
                      motif_len: int = 8) -> List[Dict[str, Any]]:
    """The self-similar workload speculative decoding is built for: each
    prompt tiles a per-request random ``motif_len``-token motif out to its
    length, so the n-gram proposer's prompt lookup keeps finding the
    trailing pattern earlier in the context (templated agent turns, code,
    looping greedy continuations). Shared by the stream driver and
    ``serve_bench --speculate`` so the benchmark's acceptance-rate and
    decode-throughput datapoints measure exactly what ``--stream``
    drives."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_requests):
        plen = int(rng.randint(max(motif_len, prompt_len // 2),
                               prompt_len + 1))
        glen = int(rng.randint(max(1, gen_len // 2), gen_len + 1))
        motif = rng.randint(2, vocab, size=motif_len).astype(np.int32)
        prompt = np.tile(motif, -(-plen // motif_len))[:plen]
        out.append({"prompt": prompt, "max_new_tokens": glen})
    return out


# ---------------------------------------------------------------------------
# Slot table
# ---------------------------------------------------------------------------


class SlotTable:
    """Occupancy of the pooled KV cache: slot index -> resident request id."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._occupant: List[Optional[int]] = [None] * n_slots
        #: how many times each slot has been (re)allocated — reuse evidence
        self.allocations = [0] * n_slots

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._occupant) if r is None]

    def occupant(self, slot: int) -> Optional[int]:
        return self._occupant[slot]

    def allocate(self, rid: int) -> int:
        for i, r in enumerate(self._occupant):
            if r is None:
                self._occupant[i] = rid
                self.allocations[i] += 1
                return i
        raise RuntimeError("no free slot (admission must check free_slots)")

    def release(self, slot: int) -> int:
        rid = self._occupant[slot]
        if rid is None:
            raise RuntimeError(f"slot {slot} already free")
        self._occupant[slot] = None
        return rid

    @property
    def n_occupied(self) -> int:
        return sum(r is not None for r in self._occupant)


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


class Scheduler:
    """Admission control between the request queue and the slot table.

    With ``pages`` set, the scheduler also owns the paged two-tier pool's
    host state: the layer-0 and layer-1 :class:`PagePool` free lists, the
    per-request page mappings, and the preempt-and-spill policy
    (:meth:`plan_boundary`). The engine mirrors the mappings into the
    device block-table array and executes the planned copies.

    With ``prefix_share`` additionally set, admission consults a
    :class:`PrefixIndex` of resident full pages: a queued prompt whose
    longest full-page prefix is already cached maps those pages read-only
    (refcounted) and reserves fresh pages only for the unmatched tail —
    the engine then prefills only the suffix (DESIGN.md §Prefix sharing &
    copy-on-write).
    """

    POLICIES = ("fcfs", "shortest")

    def __init__(self, n_slots: int, policy: str = "fcfs",
                 pages: Optional[PageGeometry] = None,
                 prefix_share: bool = False,
                 chunk_prefill_tokens: Optional[int] = None,
                 disaggregate: bool = False):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {self.POLICIES}")
        if prefix_share and pages is None:
            raise ValueError("prefix_share requires the paged pool (pages=)")
        if disaggregate and pages is None:
            raise ValueError(
                "disaggregate requires the paged pool (pages=): page "
                "handover moves block-table rows between roles")
        if chunk_prefill_tokens is not None and chunk_prefill_tokens < 1:
            raise ValueError(f"chunk_prefill_tokens must be >= 1, got "
                             f"{chunk_prefill_tokens}")
        self.n_slots = n_slots
        #: per-boundary prefill-token budget; None -> whole-prompt admission
        self.chunk_prefill_tokens = chunk_prefill_tokens
        self.prefill_chunks = 0
        #: prefill tokens each boundary actually planned (admission stall
        #: evidence: unchunked mode books a whole prompt in one entry)
        self.boundary_prefill_tokens: List[int] = []
        self.policy = policy
        self.table = SlotTable(n_slots)
        self.queue: Deque[Request] = collections.deque()
        self.active: Dict[int, Request] = {}      # slot -> request
        self.drained: List[Request] = []
        self._next_rid = 0
        self.admit_order: List[int] = []          # rids in admission order
        self._active_order: List[int] = []        # slots, oldest admit first
        # ---- paged two-tier pool (None -> dense slot-slab mode)
        self.pages = pages
        self.page_pool: Optional[PagePool] = None
        self.spill_pool: Optional[PagePool] = None
        self.seat_pool: Optional[PagePool] = None
        self.preemptions = 0
        self.spilled_pages = 0
        self.restores = 0
        # ---- layer-2 host tier (DESIGN.md §Tiered KV compression & host
        # parking): idle sessions serialized off-device and re-admitted
        self.parks = 0
        self.park_resumes = 0
        #: most sequences concurrently resident in layer 0 at any boundary —
        #: the numerator of the residents-per-byte gate
        self.resident_high_water = 0
        # ---- disaggregated roles (DESIGN.md §Disaggregated serving)
        self.disaggregate = disaggregate
        self.handovers = 0
        self.handover_pages = 0
        # ---- prefix sharing (None -> every admission prefills in full)
        self.prefix_index: Optional[PrefixIndex] = None
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.shared_prefix_tokens = 0   # prompt tokens served from the index
        self.cow_copies = 0
        if prefix_share:
            self.prefix_index = PrefixIndex(pages.page_tokens)
        if pages is not None:
            self.page_pool = PagePool(pages.n_pages, "layer0")
            self.spill_pool = PagePool(pages.n_spill_pages, "layer1")
            # one layer-1 seat per spill page: each spilled request holds at
            # least one page, so seats can never run out before pages do
            self.seat_pool = PagePool(pages.n_spill_pages, "seats")

    @classmethod
    def for_model(cls, cfg: ModelConfig, max_len: int, *,
                  target: Optional[HardwareTarget] = None,
                  policy: str = "fcfs", fraction: float = 0.8,
                  max_slots: int = 64, paged: bool = False,
                  page_tokens: int = 16,
                  layer1_fraction: Optional[float] = None,
                  layer0_bytes: Optional[int] = None,
                  layer1_bytes: Optional[int] = None,
                  prefix_share: bool = False,
                  chunk_prefill_tokens: Optional[int] = None,
                  disaggregate: bool = False,
                  model_shards: int = 1,
                  data_shards: int = 1) -> "Scheduler":
        """Size the slot table (and, when ``paged``, the two-tier page
        pools) from the target's CapacityPartition budget.

        ``chunk_prefill_tokens=0`` derives the per-boundary prefill budget
        from the same target via :func:`derive_prefill_chunk`; a positive
        value pins it; None keeps whole-prompt admission.
        ``model_shards``/``data_shards`` are the mesh axis sizes the engine
        serves under: the budgets scale to the aggregate pool
        (:func:`kv_shards`, :func:`derive_n_slots`) but the scheduler stays
        otherwise mesh-oblivious — block tables, free lists and the prefix
        index are global logical state, identical on every shard."""
        pages = None
        if paged:
            pages = derive_page_geometry(
                cfg, max_len, target=target, fraction=fraction,
                layer1_fraction=layer1_fraction, page_tokens=page_tokens,
                max_slots=max_slots, layer0_bytes=layer0_bytes,
                layer1_bytes=layer1_bytes, model_shards=model_shards)
        if chunk_prefill_tokens == 0:
            chunk_prefill_tokens = derive_prefill_chunk(cfg, target=target)
        return cls(derive_n_slots(cfg, max_len, target=target,
                                  fraction=fraction, max_slots=max_slots,
                                  pages=pages, model_shards=model_shards,
                                  data_shards=data_shards),
                   policy=policy, pages=pages, prefix_share=prefix_share,
                   chunk_prefill_tokens=chunk_prefill_tokens,
                   disaggregate=disaggregate)

    def enable_disaggregation(self) -> None:
        """Switch on role routing after construction (the engine calls this
        when ``EngineConfig(disaggregate=True)`` meets a scheduler built
        without the flag). Must happen before the first boundary is
        planned — a mid-stream flip would leave earlier admissions
        unrouted."""
        if self.pages is None:
            raise ValueError(
                "disaggregate requires the paged pool (pages=): page "
                "handover moves block-table rows between roles")
        if self.admit_order:
            raise RuntimeError(
                "enable_disaggregation() must precede the first admission; "
                "requests already admitted have no role routing")
        self.disaggregate = True

    # ------------------------------------------------------------- queue
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               submit_step: int = 0) -> Request:
        return self.submit_request(Request(
            rid=0, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=int(max_new_tokens), submit_step=submit_step))

    def submit_request(self, req: Request) -> Request:
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (a request always emits its "
                f"prefill token), got {req.max_new_tokens}")
        req.rid = self._next_rid
        self._next_rid += 1
        req.status = QUEUED
        self.queue.append(req)
        return req

    def submit_parked(self, prompt: Sequence[int], max_new_tokens: int,
                      tokens: Sequence[int], *,
                      submit_step: int = 0) -> Request:
        """Enqueue a session resumed from the layer-2 host tier
        (DESIGN.md §Tiered KV compression & host parking).

        ``tokens`` are the outputs already emitted before the park, so the
        request's host-side ``cache_len`` mirror lands exactly where the
        parked pool bytes left it. The request enters admission with status
        ``PARKED`` and takes the resume branch of :meth:`plan_boundary`:
        pages are re-allocated (full prompt pages re-matched through the
        prefix index when sharing is on) and the engine scatters the parked
        page contents back — a resume, never a re-prefill."""
        if self.pages is None:
            raise ValueError("park/resume requires the paged pool (pages=)")
        if not tokens:
            raise ValueError("a parked session has emitted at least its "
                             "first token; got an empty token list")
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      tokens=list(int(t) for t in tokens),
                      submit_step=submit_step)
        self._next_rid += 1
        req.status = PARKED
        self.queue.append(req)
        return req

    # --------------------------------------------------------- admission
    def _pop_next(self) -> Request:
        if self.policy == "shortest":
            idx = min(range(len(self.queue)),
                      key=lambda i: self.queue[i].prompt_len)
            req = self.queue[idx]
            del self.queue[idx]
            return req
        return self.queue.popleft()               # fcfs

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue; returns (slot, request) pairs.

        Called at batch-drain boundaries only — admission never interrupts
        the in-flight decode chunk, it refills slots between chunks
        (DESIGN.md §Serving). Dense slot-slab mode only; paged admission —
        by pages, with optional prefix sharing — goes through
        :meth:`plan_boundary` (DESIGN.md §Paged two-tier pool).
        """
        placed: List[Tuple[int, Request]] = []
        while self.queue and self.table.n_occupied < self.n_slots:
            req = self._pop_next()
            slot = self.table.allocate(req.rid)
            req.status = PREFILLING
            self.active[slot] = req
            self.admit_order.append(req.rid)
            self._active_order.append(slot)
            placed.append((slot, req))
        if self.chunk_prefill_tokens is None:
            self.boundary_prefill_tokens.append(
                sum(r.prompt_len for _, r in placed))
        return placed

    def plan_prefill(self) -> List[PrefillStep]:
        """Dense-mode chunked prefill: spend the per-boundary token budget
        on in-prefill residents, oldest admission first (paged mode plans
        its steps inside :meth:`plan_boundary` instead). Call after
        :meth:`admit` each boundary; a freshly admitted request enters
        in-prefill (``prefill_pos=0``) and takes its first chunk from
        whatever budget remains."""
        budget = self.chunk_prefill_tokens
        assert budget is not None, "plan_prefill needs chunk_prefill_tokens"
        steps: List[PrefillStep] = []
        left = budget
        for slot in list(self._active_order):
            if left <= 0:
                break
            req = self.active[slot]
            if req.prefill_pos < 0 and req.status == PREFILLING:
                req.prefill_pos = 0               # fresh dense admission
            if not 0 <= req.prefill_pos < req.prompt_len:
                continue
            n = min(left, req.prompt_len - req.prefill_pos)
            final = req.prefill_pos + n == req.prompt_len
            steps.append(PrefillStep(slot=slot, req=req,
                                     start=req.prefill_pos, n_tokens=n,
                                     final=final))
            req.prefill_pos += n
            left -= n
            self.prefill_chunks += 1
        self.boundary_prefill_tokens.append(budget - left)
        return steps

    def complete(self, slot: int, status: str = DRAINED) -> Request:
        """Mark the slot's request drained (or rejected) and free the slot
        for reuse. In paged mode this drops one reference on each of the
        request's pages: a private page returns to the free list, a shared
        page stays resident for its other readers, and pages that actually
        released fall out of the prefix index."""
        req = self.active.pop(slot)
        self.table.release(slot)
        self._active_order.remove(slot)
        if self.page_pool is not None and req.pages:
            released = self.page_pool.free(req.pages)
            if self.prefix_index is not None:
                self.prefix_index.forget(released)
            req.pages = []
        req.status = status
        self.drained.append(req)
        return req

    def park(self, slot: int) -> Request:
        """Evict ``slot`` to the layer-2 host tier (DESIGN.md §Tiered KV
        compression & host parking). The caller (the engine) has already
        gathered the session's page bytes into a host-side blob; this
        releases every device resource the slot held. Pages drop one
        reference exactly like :meth:`complete` — a shared page stays
        resident for its other readers, so parking never yanks history out
        from under a live matcher. The returned request is neither drained
        nor queued: it re-enters admission via :meth:`submit_parked` when
        its blob comes back."""
        req = self.active.pop(slot)
        self.table.release(slot)
        self._active_order.remove(slot)
        if self.page_pool is not None and req.pages:
            released = self.page_pool.free(req.pages)
            if self.prefix_index is not None:
                self.prefix_index.forget(released)
            req.pages = []
        req.prefix_len, req.n_shared, req.cow_src = 0, 0, -1
        req.status = PARKED
        self.parks += 1
        return req

    def requeue(self, slot: int) -> Request:
        """Return a mid-prefill resident to the queue from scratch.

        The park path needs a decoded token to resume from, so a request
        caught mid-prefill when the engine idles out cannot park — it
        releases its pages and restarts its prefill on re-admission (it
        has emitted nothing, so nothing is lost but the partial prompt
        work). Queued at the FRONT: it was admitted once already."""
        req = self.active.pop(slot)
        self.table.release(slot)
        self._active_order.remove(slot)
        if self.page_pool is not None and req.pages:
            released = self.page_pool.free(req.pages)
            if self.prefix_index is not None:
                self.prefix_index.forget(released)
            req.pages = []
        req.prefill_pos = -1
        req.prefix_len, req.n_shared, req.cow_src = 0, 0, -1
        req.status = QUEUED
        self.queue.appendleft(req)
        return req

    # --------------------------------------------------- paged admission
    def _admissible_index(self) -> int:
        """Queue index the policy would admit next. Preempted requests are
        restored first (they hold layer-1 resources), in queue order."""
        for i, req in enumerate(self.queue):
            if req.status == PREEMPTED:
                return i
        if self.policy == "shortest":
            return min(range(len(self.queue)),
                       key=lambda i: self.queue[i].prompt_len)
        return 0

    def _preempt(self, slot: int) -> SpillAction:
        """Spill ``slot`` to layer 1. Allocates the layer-1 resources FIRST
        so a spill-tier-exhausted failure leaves the scheduler untouched."""
        req = self.active[slot]
        dst = self.spill_pool.alloc(len(req.pages))
        seat = self.seat_pool.alloc(1)
        if dst is None or seat is None:
            if dst is not None:
                self.spill_pool.free(dst)
            if seat is not None:
                self.seat_pool.free(seat)
            raise RuntimeError(
                f"layer-1 spill tier exhausted ({self.spill_pool.in_use}/"
                f"{self.pages.n_spill_data_pages} pages in use) — raise "
                f"layer1_fraction / layer1_bytes")
        self.active.pop(slot)
        self.table.release(slot)
        self._active_order.remove(slot)
        src = req.pages
        # dereference: private pages release (and leave the prefix index);
        # a shared page stays resident for its other readers — the layer-1
        # copy below still reads it, since nobody writes shared pages
        released = self.page_pool.free(src)
        if self.prefix_index is not None:
            self.prefix_index.forget(released)
        req.pages = []
        req.spill_pages = dst
        req.spill_seat = seat[0]
        req.status = PREEMPTED
        req.preemptions += 1
        self.preemptions += 1
        self.spilled_pages += len(src)
        self.queue.appendleft(req)        # restored before fresh admissions
        return SpillAction(slot=slot, req=req, src_pages=src, dst_pages=dst,
                           seat=req.spill_seat)

    def plan_boundary(self, *, chunk_tokens: int, max_len: int) -> PagePlan:
        """Paged-mode drain-boundary plan: grow, preempt, restore, admit.

        1. **Growth** (oldest resident first): every active slot gets pages
           covering its next ``chunk_tokens`` of decode. If layer 0 is
           exhausted, the YOUNGEST resident is preempted and its pages
           spill to layer 1 — repeatedly, until the grow fits. When the
           grower is itself the youngest, IT spills rather than evicting
           an older sequence (oldest-first growth always wins), and its
           restore reallocates the full need — so an older resident is
           never sacrificed for a younger one, and every boundary makes
           progress on the oldest resident.
        2. **Restores + admissions** (policy order, preempted first): a
           restore reallocates layer-0 pages and schedules the copy back; a
           fresh admission reserves pages for ``prompt + chunk`` only — the
           whole point of paging: no worst-case ``max_len`` slab. With
           prefix sharing, the admission first matches the longest indexed
           full-page prefix (:meth:`_match_prefix`) and allocates fresh
           pages only for the unmatched tail. Admission stops at the first
           request that does not fit (no queue-jumping beyond the policy's
           pick). Admission never preempts; only growth of already-resident
           sequences does.

        With ``chunk_prefill_tokens`` set (DESIGN.md §Chunked prefill), a
        phase runs between growth and restores/admissions: the per-boundary
        prefill-token budget is spent on in-prefill residents oldest-first
        (:meth:`_plan_prefill_chunk` — page growth with the same
        youngest-first preemption), and fresh admissions reserve pages for
        their FIRST chunk only, taking it from whatever budget remains.
        Prefix-index registration is deferred to the final chunk.

        Ordering contract with the engine (DESIGN.md §Paged two-tier pool):
        spills are planned before restores/admissions so their device
        copies read layer-0 pages before anything reuses them; restored
        spill pages are freed only after this boundary's spills allocated
        theirs, keeping read and write page ids disjoint. Prefill chunks
        execute after all copies, in plan order.
        """
        assert self.pages is not None, "plan_boundary is paged-mode only"
        geom = self.pages
        plan = PagePlan()
        budget = self.chunk_prefill_tokens
        left = budget if budget is not None else 0
        for slot in list(self._active_order):
            if slot not in self.active:
                continue                 # preempted earlier this boundary
            req = self.active[slot]
            if 0 <= req.prefill_pos < req.prompt_len:
                continue                 # mid-prefill: grown by its chunk
            target_tokens = min(req.cache_len + chunk_tokens, max_len)
            while True:
                need = geom.pages_for(target_tokens) - len(req.pages)
                if need <= 0:
                    break
                got = self.page_pool.alloc(need)
                if got is not None:
                    req.pages.extend(got)
                    break
                if self._active_order[-1] != slot:
                    # victim: the most recently (re)admitted resident —
                    # always strictly younger than the grower here
                    plan.spills.append(self._preempt(self._active_order[-1]))
                    continue
                # the grower IS the youngest: spill it instead of evicting
                # an older sequence; its restore reallocates the full need
                plan.spills.append(self._preempt(slot))
                break
        # ---- resume in-prefill residents (oldest first) under the budget;
        # planned BEFORE restores/admissions so any preemption their page
        # growth forces still precedes every layer-1 free of this boundary
        # (the id-disjointness contract), and so a canonical prefix always
        # finishes before a same-boundary matcher's suffix chunk reads it.
        if budget is not None:
            for slot in list(self._active_order):
                if left <= 0:
                    break
                if slot not in self.active:
                    continue
                req = self.active[slot]
                if not 0 <= req.prefill_pos < req.prompt_len:
                    continue
                left = self._plan_prefill_chunk(plan, slot, req, left,
                                                chunk_tokens, max_len)
        while self.queue and self.table.free_slots():
            idx = self._admissible_index()
            req = self.queue[idx]
            if req.status == PREEMPTED:
                need = max(geom.pages_for(
                    min(req.cache_len + chunk_tokens, max_len)),
                    len(req.spill_pages))
                got = self.page_pool.alloc(need)
                if got is None:
                    break
                del self.queue[idx]
                slot = self.table.allocate(req.rid)
                src, seat = req.spill_pages, req.spill_seat
                req.pages, req.spill_pages, req.spill_seat = got, [], -1
                # a request preempted mid-chunked-prefill resumes its
                # cursor at the NEXT boundary (this one's chunk budget was
                # committed before the restore was planned)
                req.status = (PREFILLING
                              if 0 <= req.prefill_pos < req.prompt_len
                              else DECODING)
                self.active[slot] = req
                self.admit_order.append(req.rid)
                self._active_order.append(slot)
                self.restores += 1
                plan.restores.append(RestoreAction(slot=slot, req=req,
                                                   src_pages=src, seat=seat))
                # freed only now — after this boundary's spills allocated
                # theirs, so restore-read and spill-write ids are disjoint
                self.spill_pool.free(src)
                self.seat_pool.free([seat])
                continue
            if req.status == PARKED:
                # layer-2 resume (DESIGN.md §Tiered KV compression & host
                # parking): the session's bytes live in a host blob, so
                # admission only re-maps layer-0 page ids — the engine
                # scatters the parked contents back; never a re-prefill.
                # Prefix re-match covers FULL prompt pages only: a resumed
                # session's write frontier is past its prompt, so matched
                # pages are history it merely reads, but a mid-page match
                # would need the COW copy the resume scatter path
                # deliberately avoids.
                shared = []
                if self.prefix_index is not None:
                    matched = self.prefix_index.match(req.prompt)
                    full = min(len(matched),
                               (req.prompt_len - 1) // geom.page_tokens)
                    shared = matched[:full]
                need = max(geom.pages_for(
                    min(req.cache_len + chunk_tokens, max_len)),
                    geom.pages_for(req.cache_len))
                got = self.page_pool.alloc(need - len(shared))
                if got is None:
                    break
                if shared:
                    self.page_pool.share(shared)
                del self.queue[idx]
                slot = self.table.allocate(req.rid)
                req.pages = shared + got
                req.prefix_len = len(shared) * geom.page_tokens
                req.n_shared, req.cow_src = len(shared), -1
                if self.prefix_index is not None:
                    if req.prefix_len:
                        self.prefix_hits += 1
                        self.shared_prefix_tokens += req.prefix_len
                    else:
                        self.prefix_misses += 1
                    # register at plan time: the engine executes resumes
                    # before this boundary's admissions prefill anything,
                    # so a same-boundary matcher reads settled bytes
                    self.prefix_index.register(req.prompt, req.pages)
                req.status = DECODING
                if self.disaggregate:
                    req.owner = DECODE_ROLE
                self.active[slot] = req
                self.admit_order.append(req.rid)
                self._active_order.append(slot)
                self.park_resumes += 1
                plan.resumes.append(ResumeStep(slot=slot, req=req))
                continue
            if req.prompt_len > max_len:
                del self.queue[idx]
                req.status = REJECTED
                self.drained.append(req)
                plan.rejects.append(req)
                continue
            if budget is not None and left <= 0:
                break                     # no budget to start its first chunk
            shared, prefix_len, cow_src = self._match_prefix(req)
            if budget is not None:
                first_end = prefix_len + min(left,
                                             req.prompt_len - prefix_len)
                cover = (min(first_end + chunk_tokens, max_len)
                         if first_end == req.prompt_len else first_end)
                need = geom.pages_for(cover)
            else:
                need = geom.pages_for(
                    min(req.prompt_len + chunk_tokens, max_len))
            got = self.page_pool.alloc(need - len(shared))
            if got is None:
                break
            if shared:
                self.page_pool.share(shared)
            del self.queue[idx]
            slot = self.table.allocate(req.rid)
            req.pages = shared + got
            req.prefix_len, req.n_shared, req.cow_src = (prefix_len,
                                                         len(shared), cow_src)
            if self.prefix_index is not None:
                if prefix_len:
                    self.prefix_hits += 1
                    self.shared_prefix_tokens += prefix_len
                    self.cow_copies += cow_src >= 0
                else:
                    self.prefix_misses += 1
                if budget is None:
                    self.prefix_index.register(req.prompt, req.pages)
            req.status = PREFILLING
            if self.disaggregate:
                req.owner = PREFILL_ROLE
            self.active[slot] = req
            self.admit_order.append(req.rid)
            self._active_order.append(slot)
            plan.admits.append((slot, req))
            if budget is not None:
                # first chunk rides this boundary's remaining budget; the
                # pages above already cover it, so this never preempts
                req.prefill_pos = prefix_len
                left = self._plan_prefill_chunk(plan, slot, req, left,
                                                chunk_tokens, max_len)
            elif self.disaggregate:
                # unchunked admission prefills the whole prompt this
                # boundary, so the handover follows immediately
                self._plan_handover(plan, slot, req)
        if budget is not None:
            self.boundary_prefill_tokens.append(budget - left)
        else:
            self.boundary_prefill_tokens.append(sum(
                r.prompt_len - r.prefix_len for _, r in plan.admits))
        self.resident_high_water = max(self.resident_high_water,
                                       len(self.active))
        return plan

    def _plan_prefill_chunk(self, plan: PagePlan, slot: int, req: Request,
                            left: int, chunk_tokens: int,
                            max_len: int) -> int:
        """Plan one prompt chunk for an in-prefill resident: grow its pages
        to cover the chunk (a final chunk also covers the next decode
        chunk), preempting youngest-first exactly like decode growth, then
        append the :class:`PrefillStep` and advance the cursor. Returns
        the remaining token budget. A resident that had to spill ITSELF
        (it was the youngest) consumes no budget; its cursor survives the
        preemption and resumes a boundary after its restore."""
        geom = self.pages
        n = min(left, req.prompt_len - req.prefill_pos)
        end = req.prefill_pos + n
        final = end == req.prompt_len
        cover = min(end + chunk_tokens, max_len) if final else end
        while True:
            need = geom.pages_for(cover) - len(req.pages)
            if need <= 0:
                break
            got = self.page_pool.alloc(need)
            if got is not None:
                req.pages.extend(got)
                break
            if self._active_order[-1] != slot:
                plan.spills.append(self._preempt(self._active_order[-1]))
                continue
            plan.spills.append(self._preempt(slot))
            return left
        plan.prefill_steps.append(PrefillStep(
            slot=slot, req=req, start=req.prefill_pos, n_tokens=n,
            final=final))
        req.prefill_pos = end
        self.prefill_chunks += 1
        if final and self.prefix_index is not None:
            # deferred from admission: a chunked request's pages hold real
            # content only once the last chunk lands — registering earlier
            # could hand a concurrent admission pages still being filled
            self.prefix_index.register(req.prompt, req.pages)
        if final and self.disaggregate:
            self._plan_handover(plan, slot, req)
        return left - n

    def _plan_handover(self, plan: PagePlan, slot: int,
                       req: Request) -> None:
        """Route a prompt-complete request to the decode role: emit the
        :class:`HandoverStep` the engine executes as a zero-copy ownership
        flip. Safe within one plan: preemption picks the YOUNGEST resident,
        so a spill planned after this (by a later chunk or admission) can
        never hit an older, already-handed-over slot before the engine
        executes both — and if THIS slot spills in a later boundary, its
        restore re-enters straight into the decode role (owner survives
        preemption)."""
        req.owner = DECODE_ROLE
        self.handovers += 1
        self.handover_pages += len(req.pages)
        plan.handovers.append(HandoverStep(slot=slot, req=req,
                                           pages=list(req.pages)))

    def _match_prefix(self, req: Request) -> Tuple[List[int], int, int]:
        """Prefix-index lookup for a fresh admission.

        Returns ``(shared_pages, prefix_len, cow_src)``: the physical pages
        to map read-only at logical indices ``0..len(shared)-1``, how many
        prompt tokens they cover, and — when the match ends mid-page — the
        source page the engine COW-copies the frontier page from (else -1).

        The match is capped at ``prompt_len - 1`` tokens: at least one
        prompt token is always prefilled (the request's first output token
        is the argmax at the last prompt position). When the cap bites (a
        page-aligned prompt fully covered by the index), the final matched
        page would hold the write frontier — it is NEVER shared; the engine
        copies it into a fresh private page instead (the copy-on-write rule:
        decode writes must not mutate another request's history)."""
        if self.prefix_index is None:
            return [], 0, -1
        matched = self.prefix_index.match(req.prompt)
        pt = self.pages.page_tokens
        prefix_len = min(len(matched) * pt, req.prompt_len - 1)
        full = prefix_len // pt
        cow_src = matched[full] if prefix_len % pt else -1
        return matched[:full], prefix_len, cow_src

    def block_table(self, role: Optional[str] = None) -> np.ndarray:
        """The (n_slots, max_pages_per_slot) int32 block table implied by
        the current page mappings; unmapped entries point at null page 0.

        With ``role`` set (disaggregated serving), only slots OWNED by that
        role get rows — everything else maps to the null page. The decode
        role's view therefore routes done-masked junk writes for
        mid-prefill slots into page 0 instead of their real pages, which is
        safe by construction: positions at or past a prefill cursor are
        never read, and the next prefill chunk's whole-page scatter
        rewrites the frontier page anyway. Handover is exactly the moment a
        slot's row appears in the decode view."""
        assert self.pages is not None
        bt = np.zeros((self.n_slots, self.pages.max_pages_per_slot), np.int32)
        for slot, req in self.active.items():
            if role is not None and req.owner != role:
                continue
            bt[slot, :len(req.pages)] = req.pages
        return bt

    # ------------------------------------------------------------- state
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

    def stats(self) -> Dict[str, Any]:
        allocs = self.table.allocations
        done = [r for r in self.drained if r.status == DRAINED]
        out = {
            "n_slots": self.n_slots,
            "policy": self.policy,
            "queued": len(self.queue),
            "active": len(self.active),
            "drained": len(done),
            "rejected": sum(r.status == REJECTED for r in self.drained),
            "slot_allocations": list(allocs),
            "max_slot_reuse": max(allocs) if allocs else 0,
            # per-request latency, in decode-step clock units: time to first
            # token (admission wait) and end-to-end (submit -> drain).
            # ttft_emit_steps counts to the FIRST OUTPUT TOKEN — under
            # chunked prefill that is the final chunk's boundary, later
            # than the admission the slot-wait ttft_steps measures.
            "ttft_steps": [r.admit_step - r.submit_step for r in done],
            "ttft_emit_steps": [
                (r.first_step if r.first_step >= 0 else r.admit_step)
                - r.submit_step for r in done],
            "e2e_steps": [r.finish_step - r.submit_step for r in done
                          if r.finish_step >= 0],
            "preemptions": self.preemptions,
            "spilled_pages": self.spilled_pages,
            "restores": self.restores,
            # chunked prefill (DESIGN.md §Chunked prefill)
            "chunk_prefill_tokens": self.chunk_prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "max_boundary_prefill_tokens": (
                max(self.boundary_prefill_tokens)
                if self.boundary_prefill_tokens else 0),
        }
        if self.pages is not None:
            geom = self.pages
            out.update({
                "paged": True,
                "page_tokens": geom.page_tokens,
                "n_pages": geom.n_data_pages,
                "n_spill_pages": geom.n_spill_data_pages,
                "pages_in_use": self.page_pool.in_use,
                "pages_high_water": self.page_pool.high_water,
                "spill_pages_in_use": self.spill_pool.in_use,
                "spill_high_water": self.spill_pool.high_water,
                "pool_bytes": geom.layer0_bytes,
                "spill_bytes": geom.layer1_bytes,
                # prefix sharing: logical mappings vs physical pages — the
                # ratio is the concurrent-residency win per layer-0 byte
                "prefix_sharing": self.prefix_index is not None,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "shared_prefix_tokens": self.shared_prefix_tokens,
                "cow_copies": self.cow_copies,
                "mapped_pages": self.page_pool.mapped,
                "mapped_high_water": self.page_pool.mapped_high_water,
                "indexed_pages": (len(self.prefix_index)
                                  if self.prefix_index is not None else 0),
                # disaggregated roles (DESIGN.md §Disaggregated serving):
                # always reported so dashboards need no key probing — both
                # stay 0 in combined mode
                "disaggregate": self.disaggregate,
                "handovers": self.handovers,
                "handover_pages": self.handover_pages,
                # tiered codecs + layer-2 host tier (DESIGN.md §Tiered KV
                # compression & host parking)
                "layer0_codec": geom.layer0_codec,
                "layer1_codec": geom.layer1_codec,
                "parks": self.parks,
                "park_resumes": self.park_resumes,
                "resident_high_water": self.resident_high_water,
            })
        else:
            out["paged"] = False
        return out
