"""Serving engine over the paged KV pool: continuous batching on the card.

The counterpart of ``src/repro/serve/engine.py``. Two surfaces share one
decode substrate:

  * :meth:`Engine.generate` — one-shot batched greedy decode: prefill
    through the flash kernel, then chunks of ``sync_interval`` steps over
    the dense slot slab (the masked oracle). Done rows are masked on the
    device and the host reads the done mask once per chunk.
  * :meth:`Engine.serve` — continuous batching over the paged two-tier
    pool: the :class:`~repro_torch.serve.scheduler.Scheduler` plans grow /
    preempt / restore / admit in pages at every drain boundary, the engine
    executes the copies in plan order, uploads the block table, and every
    chunk decodes ALL slots with the page-walk kernel.

The drain-boundary discipline is the reference's: :meth:`EngineCore._fetch`
is the only device->host read, counted in ``last_stats["host_syncs"]``. On
the card every decode chunk runs under
``torch.cuda.set_sync_debug_mode("error")``, so any hidden device->host
sync inside a chunk raises — the counterpart of the reference's transfer
guard.

Not in this slice (ROADMAP A4, A6): the dense slot-slab ``serve`` loop,
prefix sharing, chunked prefill, speculative decoding, disaggregated roles
and host parking.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.pool import PoolManager, PoolState

__all__ = ["Engine", "EngineConfig", "EngineCore", "PrefillRole",
           "DecodeRole", "PoolState", "ServeReport"]


@dataclasses.dataclass
class EngineConfig:
    """``max_len`` bounds prompt + generation (the KV slot depth);
    ``sync_interval`` is the decode-chunk length between host syncs;
    ``pad_token`` fills empty slots. Prompts prefill at their exact length
    (the reference's ``prompt_pad_multiple`` bucketing comes with the
    dense slot-slab stream, ROADMAP A4)."""

    max_len: int
    eos_token: int = 1
    sync_interval: int = 8
    pad_token: int = 0


@dataclasses.dataclass
class ServeReport:
    """Result of one :meth:`Engine.serve` run over a request stream."""

    requests: List[sched_mod.Request]
    stats: Dict[str, Any]

    @property
    def outputs(self) -> Dict[int, List[int]]:
        return {r.rid: r.tokens for r in self.requests}


@contextlib.contextmanager
def device_only(device: torch.device):
    """Make any device->host sync on ``device`` raise inside the block
    (a no-op on the CPU, where there is no device to sync with)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _to_host(tree):
    if torch.is_tensor(tree):
        return tree.cpu().numpy()
    return type(tree)(_to_host(t) for t in tree)


class EngineCore:
    """What the roles share: the serving params, kernel plans, device
    placement, host IO and the bucketing rule."""

    def __init__(self, model: Model, params: Any, ecfg: EngineConfig):
        self.model = model
        self.device = model.device
        self.params = model.prepare(params)
        self.ecfg = ecfg
        self.plans = model.kernel_plans(ecfg.max_len, ecfg.max_len)
        self.last_stats: Dict[str, Any] = {}

    def _fetch(self, tree):
        """The ONLY device->host read path, issued at drain boundaries and
        counted in ``last_stats["host_syncs"]``."""
        self.last_stats["host_syncs"] = self.last_stats.get("host_syncs", 0) + 1
        return _to_host(tree)

    def tensor(self, data, dtype=torch.int32) -> torch.Tensor:
        """A host->device upload (never inside a decode chunk)."""
        return torch.as_tensor(np.asarray(data), dtype=dtype,
                               device=self.device)


class PrefillRole:
    """Admissions: prefill one prompt and scatter its pages into the pool."""

    def __init__(self, core: EngineCore, pools: PoolManager):
        self.core = core
        self.pools = pools

    def _check_prompt(self, prompt: np.ndarray) -> int:
        true_len = int(prompt.shape[0])
        if true_len > self.core.ecfg.max_len:
            raise ValueError(
                f"prompt of {true_len} tokens exceeds the KV slot depth "
                f"(max_len={self.core.ecfg.max_len})")
        return true_len

    def paged_admit(self, pool: PoolState, slot: int,
                    req: sched_mod.Request, geom: sched_mod.PageGeometry
                    ) -> Tuple[PoolState, torch.Tensor]:
        """Prefill ``req``'s prompt at the pool's page-aligned depth, cut it
        into pages at the slot's block-table row and arm the slot. Returns
        (pool, first token); the token stays on the device until the next
        drain."""
        core = self.core
        cfg, ecfg = core.model.cfg, core.ecfg
        tokens = np.asarray(req.prompt, np.int32)
        true_len = self._check_prompt(tokens)
        block_row = self.pools.pad_pages(req.pages, geom.max_pages_per_slot)
        logits, row = core.model.prefill(
            core.params, {"tokens": core.tensor(tokens[None])}, geom.depth,
            plans=core.plans, last_pos=core.tensor([true_len - 1]))
        first = torch.argmax(logits[0, -1, :cfg.vocab_size]).to(torch.int32)
        core.model.slot_update_paged(pool.state, row, slot, block_row,
                                     geom.page_tokens)
        budget = req.max_new_tokens
        pool.tok[slot] = first
        pool.cache_len[slot] = true_len
        pool.done[slot] = ((first == ecfg.eos_token)
                           | (budget <= 1) | (true_len >= ecfg.max_len))
        pool.n_gen[slot] = 1
        pool.budget[slot] = budget
        return pool, first


class DecodeRole:
    """Batched decode chunks: ``n`` steps on the device, no host read."""

    def __init__(self, core: EngineCore, pools: PoolManager):
        self.core = core
        self.pools = pools

    def decode_chunk(self, n: int):
        """``n`` one-shot decode steps with on-device EOS masking — the
        :meth:`Engine.generate` substrate."""
        core = self.core
        cfg, ecfg, plans = core.model.cfg, core.ecfg, core.plans

        def run(params, tok, state, cache_len, done):
            toks = []
            with device_only(core.device):
                for _ in range(n):
                    logits, state = core.model.decode_step(
                        params, tok[:, None], state, cache_len, plans=plans)
                    nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
                    tok = torch.where(done, ecfg.eos_token,
                                      nxt.to(torch.int32))
                    done = done | (tok == ecfg.eos_token)
                    cache_len = cache_len + 1
                    toks.append(tok)
            return torch.stack(toks, dim=1), tok, state, cache_len, done

        return run

    def pool_chunk(self, n: int):
        """``n`` batched decode steps over ALL slots with per-slot
        ``cache_len`` and on-device done masking. Emits per-step (token,
        was_active) pairs, each ``(n, S)``; the host sees them only after
        the chunk."""
        core = self.core
        cfg, ecfg, plans = core.model.cfg, core.ecfg, core.plans

        def run(params, pool: PoolState):
            toks, valid = [], []
            with device_only(core.device):
                for _ in range(n):
                    logits, state = core.model.decode_step(
                        params, pool.tok[:, None], pool.state, pool.cache_len,
                        plans=plans, block_tables=pool.block_tables)
                    nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
                    was_done = pool.done
                    tok = torch.where(was_done, ecfg.eos_token,
                                      nxt.to(torch.int32))
                    n_gen = torch.where(was_done, pool.n_gen, pool.n_gen + 1)
                    cache_len = torch.where(was_done, pool.cache_len,
                                            pool.cache_len + 1)
                    done = (was_done | (tok == ecfg.eos_token)
                            | (n_gen >= pool.budget)
                            | (cache_len >= ecfg.max_len))
                    pool = PoolState(state=state, tok=tok,
                                     cache_len=cache_len, done=done,
                                     n_gen=n_gen, budget=pool.budget,
                                     block_tables=pool.block_tables)
                    toks.append(tok)
                    valid.append(~was_done)
            return pool, torch.stack(toks), torch.stack(valid)

        return run


class Engine:
    """One :class:`EngineCore`, one :class:`PoolManager`, a
    :class:`PrefillRole` and a :class:`DecodeRole`, plus the serve loop."""

    def __init__(self, model: Model, params: Any, ecfg: EngineConfig):
        self.core = EngineCore(model, params, ecfg)
        self.pools = PoolManager(model, ecfg)
        self.prefill_role = PrefillRole(self.core, self.pools)
        self.decode_role = DecodeRole(self.core, self.pools)

    @property
    def model(self) -> Model:
        return self.core.model

    @property
    def params(self):
        return self.core.params

    @property
    def ecfg(self) -> EngineConfig:
        return self.core.ecfg

    @property
    def plans(self):
        return self.core.plans

    @property
    def last_stats(self) -> Dict[str, Any]:
        return self.core.last_stats

    @last_stats.setter
    def last_stats(self, value: Dict[str, Any]) -> None:
        self.core.last_stats = value

    # ---------------------------------------------------------- one-shot
    def prefill(self, batch: Dict[str, torch.Tensor]):
        return self.model.prefill(self.params, batch, self.ecfg.max_len,
                                  plans=self.plans)

    def generate(self, batch: Dict[str, torch.Tensor], n_steps: int
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Greedy continuation. Returns (tokens (B, <=n_steps), state).

        Rows that hit EOS are frozen on the device (EOS fill); the host
        reads the done mask once per ``sync_interval`` chunk and stops
        early at that granularity — never per token.
        """
        self.last_stats = {"host_syncs": 0, "decode_steps": 0}
        vocab, eos = self.model.cfg.vocab_size, self.ecfg.eos_token
        logits, state = self.prefill(batch)
        cache_len = torch.tensor(batch["tokens"].shape[1], dtype=torch.int32,
                                 device=self.core.device)
        tok = torch.argmax(logits[:, -1, :vocab], dim=-1).to(torch.int32)
        done = tok == eos
        out = [tok[:, None]]
        left = n_steps - 1
        while left > 0:
            n = min(self.ecfg.sync_interval, left)
            toks, tok, state, cache_len, done = \
                self.decode_role.decode_chunk(n)(
                    self.params, tok, state, cache_len, done)
            out.append(toks)
            left -= n
            self.last_stats["decode_steps"] += n
            if left > 0 and bool(self.core._fetch(done).all()):
                break
        return torch.cat(out, dim=1), state

    # -------------------------------------------------------- paged serve
    def _serve_paged(self, sch: sched_mod.Scheduler,
                     max_steps: Optional[int] = None) -> ServeReport:
        """Continuous batching over the paged two-tier pool.

        Boundary order: spills -> restores -> admissions (each copy in plan
        order, so the in-place pools see exactly the reference's sequence
        of functional updates) -> block-table upload -> decode chunk -> ONE
        drain fetch of the chunk's tokens, the done mask and any pending
        first tokens.
        """
        core, pools = self.core, self.pools
        pre, dec = self.prefill_role, self.decode_role
        if sch.prefix_index is not None or sch.chunk_prefill_tokens is not None \
                or sch.disaggregate:
            raise NotImplementedError(
                "prefix sharing, chunked prefill and disaggregated roles are "
                "not ported yet (ROADMAP A6)")
        geom = sch.pages
        self.last_stats = {"host_syncs": 0, "decode_steps": 0, "chunks": 0,
                           "admissions": 0}
        pool, spill = pools.init_paged_pool(sch)
        pending_first: List[Tuple[sched_mod.Request, torch.Tensor]] = []
        boundary_wall: List[float] = []
        boundary_tokens: List[int] = []
        step_clock = 0
        n = self.ecfg.sync_interval
        p_max = geom.max_pages_per_slot
        while sch.has_work():
            t0 = time.perf_counter()
            plan = sch.plan_boundary(chunk_tokens=n, max_len=self.ecfg.max_len)
            if plan.resumes:
                raise NotImplementedError(
                    "host park/resume is not ported yet (ROADMAP A6)")
            for req in plan.rejects:
                req.finish_step = step_clock
            # spills FIRST: they copy layer-0 pages that restores/admits
            # may reuse later this boundary
            for act in plan.spills:
                spill = pools.exec_spill(pool, spill, act, p_max)
            for act in plan.restores:
                pool = pools.exec_restore(pool, spill, act, p_max)
            for slot, req in plan.admits:
                req.admit_step = step_clock
                pool, first = pre.paged_admit(pool, slot, req, geom)
                self.last_stats["admissions"] += 1
                req.status = sched_mod.DECODING
                pending_first.append((req, first))
            pool = dataclasses.replace(
                pool, block_tables=core.tensor(sch.block_table()))
            pool, toks, valid = dec.pool_chunk(n)(core.params, pool)
            step_clock += n
            self.last_stats["decode_steps"] += n
            self.last_stats["chunks"] += 1
            # ---- drain boundary: the single host sync of this iteration
            toks_h, valid_h, done_h, firsts = core._fetch(
                (toks, valid, pool.done, [f for _, f in pending_first]))
            emitted = len(firsts)
            for (req, _), f in zip(pending_first, firsts):
                req.tokens.append(int(f))
                req.first_step = step_clock
            pending_first.clear()
            for slot in sorted(sch.active):
                req = sch.active[slot]
                before = len(req.tokens)
                req.tokens.extend(
                    int(t) for t, v in zip(toks_h[:, slot], valid_h[:, slot])
                    if v)
                emitted += len(req.tokens) - before
                if done_h[slot] and req.status != sched_mod.PREFILLING:
                    req.finish_step = step_clock
                    sch.complete(slot)
            boundary_wall.append(time.perf_counter() - t0)
            boundary_tokens.append(emitted)
            if max_steps is not None and step_clock >= max_steps:
                break
        self.last_stats["boundary_wall_s"] = boundary_wall
        self.last_stats["boundary_tokens"] = boundary_tokens
        stats = dict(self.last_stats)
        stats.update(sch.stats())
        return ServeReport(requests=(sch.drained + list(sch.active.values())
                                     + list(sch.queue)),
                           stats=stats)

    def serve(self, requests: Iterable[sched_mod.Request] = (),
              scheduler: Optional[sched_mod.Scheduler] = None, *,
              max_steps: Optional[int] = None) -> ServeReport:
        """Continuous batching over a request stream (paged pool only in
        this slice; the dense slot-slab loop is ROADMAP A4)."""
        sch = scheduler or sched_mod.Scheduler.for_model(
            self.model.cfg, self.ecfg.max_len, paged=True)
        for req in requests:
            sch.submit_request(req)
        if sch.pages is None:
            raise NotImplementedError(
                "the dense slot-slab serve loop is not ported yet (ROADMAP "
                "A4); pass a paged Scheduler")
        return self._serve_paged(sch, max_steps)
