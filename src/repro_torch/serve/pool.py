"""Pool ownership for the serving engine: construction and tier copies.

The counterpart of ``src/repro/serve/pool.py`` for the fp16 (bf16 storage)
codec. The KV pool is one device-side address space: a flat layer-0 page
pool addressed through per-slot block tables, and a layer-1 spill tier the
scheduler preempts into when layer 0 runs out. Recurrent SSM state is not
paged: layer 0 holds one row per slot and layer 1 one seat per spill page,
and a spill or restore moves the row between the slot and its seat.

Unlike the reference's functional arrays, the pools here are updated IN
PLACE. That is safe because the engine executes a boundary's copies in the
scheduler's plan order — spills first, then restores, then admissions —
and every copy is complete, in stream order, before the next one starts:
a spill copies its pages and its slot's row OUT of layer 0 (it never keeps
a view of them), so a restore or an admission that reuses those layer-0
pages or that slot later in the same boundary cannot change what was
spilled.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.serve import scheduler as sched_mod


# ------------------------------------------------------------- tier codecs


@dataclasses.dataclass(frozen=True)
class TierCodec:
    """How one pool tier stores KV bytes. Only ``fp16`` (bf16 storage, the
    bit-exact identity) is served by this slice; the int8 / fp8 codecs are
    listed so the scheduler prices their pages as the reference does."""

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
    """Owns PoolState construction and the layer-0 <-> layer-1 copies."""

    def __init__(self, model: Any, ecfg: Any):
        self.model = model
        self.ecfg = ecfg
        self.device = model.device

    # ------------------------------------------------------- construction
    def init_paged_pool(self, sch: sched_mod.Scheduler
                        ) -> Tuple[PoolState, Dict[str, Any]]:
        """Empty paged pool (all slots done/free) + the layer-1 spill
        tier's device arrays: recurrent rows for ``n_slots`` slots in
        layer 0 and one seat per spill page in layer 1 (a spilled sequence
        holds at least one page, so seats cannot run out first)."""
        geom = sch.pages
        if geom is None:
            raise ValueError("init_paged_pool needs a paged scheduler")
        if (geom.layer0_codec, geom.layer1_codec) != ("fp16", "fp16"):
            raise NotImplementedError(
                "quantized KV tiers (int8/fp8) are not ported yet "
                "(ROADMAP A6)")
        from repro_torch.models import transformer
        cfg, dev = self.model.cfg, self.device
        n_slots = sch.n_slots
        state = {"caches": transformer.init_paged_caches(
            cfg, n_slots, geom.n_pages, geom.page_tokens, dev)}
        spill = transformer.init_paged_caches(
            cfg, geom.n_spill_pages, geom.n_spill_pages, geom.page_tokens,
            dev)

        def vec(value, dtype=torch.int32):
            return torch.full((n_slots,), value, dtype=dtype, device=dev)

        pool = PoolState(
            state=state, tok=vec(self.ecfg.pad_token), cache_len=vec(0),
            done=vec(True, torch.bool), n_gen=vec(0), budget=vec(0),
            block_tables=torch.zeros((n_slots, geom.max_pages_per_slot),
                                     dtype=torch.int32, device=dev))
        return pool, spill

    # -------------------------------------------------------- tier copies
    def _tier_copy(self, src_caches, dst_caches, row_src: int, row_dst: int,
                   pages_src: torch.Tensor, pages_dst: torch.Tensor) -> None:
        """dst[:, pages_dst] = src[:, pages_src] for every paged leaf, and
        dst[:, row_dst] = src[:, row_src] for every recurrent (per-slot)
        leaf. Padded page entries route through the null pages."""
        from repro_torch.models import transformer
        for gname, gkey, is_paged in transformer.paged_cache_kinds(
                self.model.cfg):
            src_g, dst_g = src_caches[gname][gkey], dst_caches[gname][gkey]
            for name, dst in dst_g.items():
                if is_paged:
                    dst[:, pages_dst] = src_g[name][:, pages_src]
                else:
                    dst[:, row_dst] = src_g[name][:, row_src]

    def pad_pages(self, pages: Sequence[int], p_max: int) -> torch.Tensor:
        row = [0] * p_max
        row[:len(pages)] = list(pages)
        return torch.tensor(row, dtype=torch.int32, device=self.device)

    def exec_spill(self, pool: PoolState, spill: Dict[str, Any],
                   act: sched_mod.SpillAction, p_max: int) -> Dict[str, Any]:
        """Copy a preempted sequence's layer-0 pages into layer 1, and its
        slot's recurrent row into its seat."""
        self._tier_copy(pool.state["caches"], spill, act.slot, act.seat,
                        self.pad_pages(act.src_pages, p_max).long(),
                        self.pad_pages(act.dst_pages, p_max).long())
        return spill

    def exec_restore(self, pool: PoolState, spill: Dict[str, Any],
                     act: sched_mod.RestoreAction, p_max: int) -> PoolState:
        """Copy a preempted sequence back into layer 0 (its pages, and its
        seat's recurrent row into the slot) and re-arm its slot.

        The per-slot vectors come from the host mirror: the KV frontier is
        one behind the emitted count (the last token's K/V is written by
        its own upcoming decode step), so decode resumes bit-exactly where
        preemption cut it."""
        req = act.req
        self._tier_copy(spill, pool.state["caches"], act.seat, act.slot,
                        self.pad_pages(act.src_pages, p_max).long(),
                        self.pad_pages(req.pages[:len(act.src_pages)],
                                       p_max).long())
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
