"""Pool ownership for the serving engine: construction, tier copies and
the slot-ownership map of disaggregated serving.

The counterpart of ``src/repro/serve/pool.py``. Two pools: the dense slot slab (one ``max_len``-deep KV row per
slot, :meth:`PoolManager.init_pool`), and the paged pool, one device-side
address space: a flat layer-0 page pool addressed through per-slot block
tables, and a layer-1 spill tier the scheduler preempts into when layer 0
runs out. Recurrent SSM state is not
paged: layer 0 holds one row per slot and layer 1 one seat per spill page,
and a spill or restore moves the row between the slot and its seat.

Each paged tier stores its pages at its own codec (:data:`CODECS`): fp16
(bf16 storage, the identity), fp8-e4m3 (a cast) or int8 (codes plus one
f32 scale a page a leaf). A copy between tiers of one codec moves codes and
scales verbatim, so spill -> restore is bit-exact at any codec; across
codecs (the fp8 policy's fp8 layer 0 and int8 layer 1) each moved page is
dequantized to f32 and re-encoded, with fresh scales for an int8
destination.

Unlike the reference's functional arrays, the pools here are updated IN
PLACE. That is safe because the engine executes a boundary's copies in the
scheduler's plan order — spills first, then restores, then admissions —
and every copy is complete, in stream order, before the next one starts:
a spill copies its pages and its slot's row OUT of layer 0 (it never keeps
a view of them), so a restore or an admission that reuses those layer-0
pages or that slot later in the same boundary cannot change what was
spilled.

With disaggregated roles the pool stays one address space both roles
compute against; :meth:`PoolManager.transfer_ownership` hands a slot from
the prefill role to the decode role by flipping one entry of the ownership
map. No KV byte moves: the decode role's next block-table upload carries
the slot's row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.paged_attention import (as_bits,
                                                 dequantize_page_int8,
                                                 quantize_page_int8)
from repro_torch.serve import scheduler as sched_mod

PREFILL_ROLE = sched_mod.PREFILL_ROLE
DECODE_ROLE = sched_mod.DECODE_ROLE


# ------------------------------------------------------------- tier codecs


@dataclasses.dataclass(frozen=True)
class TierCodec:
    """How one pool tier stores KV bytes. ``scaled`` codecs (int8) carry one
    f32 scale per page per leaf in a sibling ``<leaf>_scale`` leaf;
    unscaled codecs are a cast (fp8-e4m3) or the identity (fp16: bf16
    storage, the bit-exact reference every quantized tier is held to)."""

    name: str
    dtype: Any
    bytes_per_value: int
    scaled: bool


CODECS: Dict[str, TierCodec] = {
    "fp16": TierCodec("fp16", torch.bfloat16, 2, False),
    "fp8": TierCodec("fp8", torch.float8_e4m3fn, 1, False),
    "int8": TierCodec("int8", torch.int8, 1, True),
}


def quant_policy(kv_quant: Optional[str]) -> Tuple[str, str]:
    """Map a ``--kv-quant`` knob to ``(layer0_codec, layer1_codec)``."""
    if kv_quant in (None, "none", "fp16"):
        return ("fp16", "fp16")
    if kv_quant == "fp8":
        return ("fp8", "int8")
    if kv_quant == "int8":
        return ("int8", "int8")
    raise ValueError(f"unknown kv quant codec {kv_quant!r} "
                     f"(choices: {', '.join(sorted(CODECS))})")


def check_page_ids(ids: np.ndarray, n_pages: int, what: str) -> np.ndarray:
    """``ids`` (host int32: a block table, or a read / write / tier-copy
    row) unchanged if every entry lies in ``[0, n_pages)``, else raise.

    The page-walk kernel and the in-place page copies index pages by these
    ids unchecked, and with prefix sharing several tables alias one page,
    so a bad id would read or overwrite another sequence's KV on the card.
    The check runs on the host copy before upload: it costs no device read.
    """
    ids = np.asarray(ids, np.int32)
    bad = (ids < 0) | (ids >= n_pages)
    if bad.any():
        raise ValueError(
            f"{what}: page ids {sorted(set(ids[bad].tolist()))[:8]} outside "
            f"the pool's [0, {n_pages})")
    return ids


@dataclasses.dataclass
class PoolState:
    """Device-side state of the KV slot pool (batch axis = slot index).

    ``block_tables`` is the ``(S, P)`` int32 map from each slot's logical
    page index to a physical layer-0 page (null page 0 when unmapped); the
    host uploads it at every drain boundary.
    """

    state: Dict[str, Any]       # model caches, page-major
    tok: torch.Tensor           # (S,) int32 — last emitted token per slot
    cache_len: torch.Tensor     # (S,) int32 — filled KV prefix per slot
    done: torch.Tensor          # (S,) bool — drained/empty slot mask
    n_gen: torch.Tensor         # (S,) int32 — tokens emitted per occupant
    budget: torch.Tensor        # (S,) int32 — occupant's max_new_tokens
    block_tables: Optional[torch.Tensor] = None    # (S, P) int32


class PoolManager:
    """Owns PoolState construction, the layer-0 <-> layer-1 copies and slot
    ownership. One PoolManager backs an engine, shared by its prefill and
    decode roles."""

    def __init__(self, model: Any, ecfg: Any):
        self.model = model
        self.ecfg = ecfg
        self.device = None if model is None else model.device
        self.geom: Optional[sched_mod.PageGeometry] = None  # paged pools
        # disaggregated slot ownership (role name per occupied slot); empty
        # in combined mode, where one engine owns everything
        self.owner: Dict[int, str] = {}
        self.handovers = 0
        self.handover_pages = 0

    # ------------------------------------------------------- construction
    def _vectors(self, n_slots: int) -> Dict[str, torch.Tensor]:
        """The per-slot vectors of an empty pool: every slot done (free)."""
        def vec(value, dtype=torch.int32):
            return torch.full((n_slots,), value, dtype=dtype,
                              device=self.device)

        return dict(tok=vec(self.ecfg.pad_token), cache_len=vec(0),
                    done=vec(True, torch.bool), n_gen=vec(0), budget=vec(0))

    def init_pool(self, n_slots: int) -> PoolState:
        """Empty dense slot-slab pool: one ``max_len``-deep KV row (and one
        recurrent row) per slot, every slot done (free)."""
        cfg = self.model.cfg
        if cfg.family == "encdec":
            raise NotImplementedError(
                "pooled serving targets decoder-only families; encdec "
                "requests go through one-shot generate()")
        if cfg.frontend_len:
            raise NotImplementedError(
                "pooled serving takes token prompts; frontend-embed "
                "requests go through one-shot generate()")
        from repro_torch.models import transformer
        state = {"caches": transformer.init_caches(
            cfg, n_slots, self.ecfg.max_len, self.device)}
        return PoolState(state=state, **self._vectors(n_slots))

    def init_paged_pool(self, sch: sched_mod.Scheduler
                        ) -> Tuple[PoolState, Dict[str, Any]]:
        """Empty paged pool (all slots done/free) + the layer-1 spill
        tier's device arrays: recurrent rows for ``n_slots`` slots in
        layer 0 and one seat per spill page in layer 1 (a spilled sequence
        holds at least one page, so seats cannot run out first)."""
        geom = sch.pages
        if geom is None:
            raise ValueError("init_paged_pool needs a paged scheduler")
        cfg = self.model.cfg
        if cfg.family == "encdec" or cfg.frontend_len:
            raise NotImplementedError(
                "paged serving targets decoder-only token-prompt models; "
                "others go through one-shot generate()")
        from repro_torch.models import transformer
        from repro_torch.models.api import has_recurrent_state
        cfg, dev = self.model.cfg, self.device
        l0, l1 = CODECS[geom.layer0_codec], CODECS[geom.layer1_codec]
        if (l0.name, l1.name) != ("fp16", "fp16") and has_recurrent_state(cfg):
            raise ValueError(
                "quantized KV pages require attention-only models: "
                "recurrent SSM state integrates every step and has no "
                "bounded per-page error story (docs/SERVING.md)")
        self.geom = geom
        n_slots = sch.n_slots
        state = {"caches": transformer.init_paged_caches(
            cfg, n_slots, geom.n_pages, geom.page_tokens, dev,
            dtype=l0.dtype, quant_scales=l0.scaled)}
        spill = transformer.init_paged_caches(
            cfg, geom.n_spill_pages, geom.n_spill_pages, geom.page_tokens,
            dev, dtype=l1.dtype, quant_scales=l1.scaled)

        pool = PoolState(
            state=state, **self._vectors(n_slots),
            block_tables=torch.zeros((n_slots, geom.max_pages_per_slot),
                                     dtype=torch.int32, device=dev))
        return pool, spill

    # -------------------------------------------------------- tier copies
    def _tier_copy(self, src_caches, dst_caches, row_src: int, row_dst: int,
                   pages_src: torch.Tensor, pages_dst: torch.Tensor,
                   src_codec: str, dst_codec: str) -> None:
        """dst[:, pages_dst] = src[:, pages_src] for every paged leaf, and
        dst[:, row_dst] = src[:, row_src] for every recurrent (per-slot)
        leaf. Padded page entries route through the null pages.

        Between tiers of one codec the page leaves (codes, and scales for
        int8) move as bits, so spill -> restore is bit-exact. Across codecs
        each moved page is dequantized to f32 and re-encoded at the
        destination's codec, with fresh per-page scales when that is
        int8."""
        from repro_torch.models import transformer
        src_c, dst_c = CODECS[src_codec], CODECS[dst_codec]
        for gname, gkey, attn in transformer.cache_attn_kinds(
                self.model.cfg):
            src_g, dst_g = src_caches[gname][gkey], dst_caches[gname][gkey]
            for name, dst in dst_g.items():
                if attn == "mamba":
                    dst[:, row_dst] = src_g[name][:, row_src]
                elif src_codec == dst_codec:
                    as_bits(dst)[:, pages_dst] = \
                        as_bits(src_g[name])[:, pages_src]
                elif not name.endswith("_scale"):
                    src = src_g[name]
                    sel = as_bits(src)[:, pages_src].view(src.dtype)
                    if src_c.scaled:                   # (r, P, *page)
                        sel = dequantize_page_int8(
                            sel, src_g[name + "_scale"][:, pages_src],
                            tuple(range(2, sel.ndim)))
                    if dst_c.scaled:
                        codes, scales = quantize_page_int8(
                            sel, tuple(range(2, sel.ndim)),
                            scale_max=tp.kv_scale_reduce(
                                self.model.cfg.n_kv_heads, attn))
                        dst[:, pages_dst] = codes
                        dst_g[name + "_scale"][:, pages_dst] = scales
                    else:
                        as_bits(dst)[:, pages_dst] = as_bits(
                            sel.float().to(dst.dtype))

    def pad_pages(self, pages: Sequence[int], p_max: int,
                  n_pages: int) -> torch.Tensor:
        """``pages`` null-padded to ``p_max`` entries, each checked against
        its tier's ``n_pages`` on the host, then uploaded."""
        row = np.zeros((p_max,), np.int32)
        row[:len(pages)] = pages
        return torch.as_tensor(check_page_ids(row, n_pages, "page row"),
                               device=self.device)

    def exec_spill(self, pool: PoolState, spill: Dict[str, Any],
                   act: sched_mod.SpillAction, p_max: int) -> Dict[str, Any]:
        """Copy a preempted sequence's layer-0 pages into layer 1, and its
        slot's recurrent row into its seat. The slot frees, and with it its
        owner entry."""
        self.owner.pop(act.slot, None)
        geom = self.geom
        self._tier_copy(pool.state["caches"], spill, act.slot, act.seat,
                        self.pad_pages(act.src_pages, p_max,
                                       geom.n_pages).long(),
                        self.pad_pages(act.dst_pages, p_max,
                                       geom.n_spill_pages).long(),
                        geom.layer0_codec, geom.layer1_codec)
        return spill

    def exec_restore(self, pool: PoolState, spill: Dict[str, Any],
                     act: sched_mod.RestoreAction, p_max: int) -> PoolState:
        """Copy a preempted sequence back into layer 0 (its pages, and its
        seat's recurrent row into the slot) and re-arm its slot.

        The per-slot vectors come from the host mirror: the KV frontier is
        one behind the emitted count (the last token's K/V is written by
        its own upcoming decode step), so decode resumes bit-exactly where
        preemption cut it."""
        req, geom = act.req, self.geom
        self._tier_copy(spill, pool.state["caches"], act.seat, act.slot,
                        self.pad_pages(act.src_pages, p_max,
                                       geom.n_spill_pages).long(),
                        self.pad_pages(req.pages[:len(act.src_pages)],
                                       p_max, geom.n_pages).long(),
                        geom.layer1_codec, geom.layer0_codec)
        slot = act.slot
        pool.cache_len[slot] = req.cache_len
        if req.status == sched_mod.PREFILLING:
            pool.done[slot] = True
            return pool
        pool.tok[slot] = int(req.tokens[-1])
        pool.done[slot] = False
        pool.n_gen[slot] = len(req.tokens)
        pool.budget[slot] = req.max_new_tokens
        return pool

    # ---------------------------------------------------------- ownership
    def claim(self, slot: int, role: str) -> None:
        """Record which role issues a slot's work (disaggregated serving
        only; a combined engine never fills the map)."""
        self.owner[slot] = role

    def release(self, slot: int) -> None:
        self.owner.pop(slot, None)

    def transfer_ownership(self, slot: int, pages: List[int], *,
                           src: str = PREFILL_ROLE,
                           dst: str = DECODE_ROLE) -> None:
        """Hand a slot (and its mapped pages) from ``src`` to ``dst``: pure
        bookkeeping, since the pages already live in the pool both roles
        compute against. Raises if ``src`` does not own the slot (a
        handover for a slot the prefill role lost to preemption would
        corrupt routing)."""
        cur = self.owner.get(slot)
        if cur != src:
            raise RuntimeError(
                f"handover of slot {slot}: owned by {cur!r}, expected "
                f"{src!r} — page handover must follow the final prefill "
                f"chunk of the owning role")
        self.owner[slot] = dst
        self.handovers += 1
        self.handover_pages += len(pages)
