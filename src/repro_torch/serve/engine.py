"""Serving engine over the pooled KV cache: continuous batching on the card.

The counterpart of ``src/repro/serve/engine.py``. Two surfaces share one
decode substrate:

  * :meth:`Engine.generate` — one-shot batched greedy decode: prefill
    through the flash kernel, then chunks of ``sync_interval`` steps over
    the dense slot slab (the masked oracle). Done rows are masked on the
    device and the host reads the done mask once per chunk.
  * :meth:`Engine.serve` — continuous batching. With a dense scheduler the
    KV cache is a slab of ``n_slots`` ``max_len``-deep slots
    (:meth:`PoolManager.init_pool`): admissions prefill a prompt and write
    its row at a free slot, and every chunk decodes ALL slots over the slab
    through the masked oracle (the reference's own dispatch: no kernel
    walks a slot slab). With a paged scheduler the KV cache is the paged
    two-tier pool: the :class:`~repro_torch.serve.scheduler.Scheduler`
    plans grow / preempt / restore / admit in pages at every drain
    boundary, the engine executes the copies in plan order, uploads the
    block table, and every chunk decodes ALL slots with the page-walk
    kernel. A ``prefix_share`` scheduler turns prefix-index hits into
    suffix-only prefills over shared, ref-counted pages (copy-on-write at
    the frontier page); a ``chunk_prefill_tokens`` scheduler prefills
    prompts a budget of tokens per boundary, interleaved with decode, on
    either pool.

Two more modes run on either pool's loop:

  * ``EngineConfig(speculate_tokens=k)`` — self-drafting speculative
    decoding: at each drain boundary the host proposes up to k drafts a
    live slot (:func:`~repro_torch.serve.speculate.propose_ngram`) and ONE
    width-(k+1) verify forward scores them
    (:meth:`DecodeRole.verify_fn`), emitting the accepted prefix + 1.
    Attention-only models.
  * ``EngineConfig(disaggregate=True)`` (paged pool) — the same loop
    routed by role: admissions and prompt chunks belong to the prefill
    role, decode to the decode role, and at a request's final prefill
    chunk the scheduler's handover flips the slot's owner
    (:meth:`PoolManager.transfer_ownership`, zero-copy); the decode role
    uploads only the block-table rows it owns. Both roles issue on one
    stream, as the reference issues them in one program; outputs are the
    combined engine's, bit for bit.

The paged pool's tiers store pages at the scheduler geometry's codecs
(fp16, fp8-e4m3 or int8; :mod:`repro_torch.serve.pool`). Between
:meth:`Engine.serve` calls an idle decoding session can leave the card
altogether: :meth:`Engine.park_request` packs its pages (codes and scales,
verbatim) and rows into a host blob (:mod:`repro_torch.serve.park`) and
frees its slot and pages; :meth:`Engine.resume_parked` queues it again, and
the boundary that re-admits it scatters the blob back into its private
pages: a resume, never a re-prefill.

With ``EngineConfig(mesh=...)`` (a ``sharding.Mesh`` of this rank, from
``launch.mesh``) the engine serves one rank's part of a sharded model:
the params are the rank's shards, every model call runs under
``distributed.tensor_parallel.use_mesh`` (tensor-parallel attention, MLP
and vocabulary; head-sharded pools where the KV heads divide the ``model``
axis, whole pools and the pooled decode where they do not; MLA's heads
over ``model`` beside a latent pool whole on every rank; expert-parallel
MoE layers, ``n_experts / M`` experts a rank, and shared experts as a
tensor-parallel SwiGLU), and the greedy pick merges
the ranks' vocabulary columns. Every rank runs the same host scheduler on
the same requests, so every MoE call sees the same rows on every rank,
idle slots included, and every rank plans, copies,
uploads and drains the same boundaries: each rank's pools hold its own
heads of the same page ids, and ``_fetch`` stays the one device->host read
a boundary on each rank. What sharded serving does not run yet raises at
construction (``tensor_parallel.check_serving``, ROADMAP A13c).

The drain-boundary discipline is the reference's: :meth:`EngineCore._fetch`
is the only device->host read, counted in ``last_stats["host_syncs"]`` (and
by role when disaggregated: the decode role reads once a boundary, the
prefill role only at boundaries that completed a prompt). On the card every
decode and verify chunk runs under
``torch.cuda.set_sync_debug_mode("error")``, so any hidden device->host
sync inside a chunk raises — the counterpart of the reference's transfer
guard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.api import Model, has_recurrent_state
from repro_torch.kernels.paged_attention import as_bits
from repro_torch.models import transformer
from repro_torch.serve import park as park_mod
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve import speculate as spec_mod
from repro_torch.serve.pool import (DECODE_ROLE, PREFILL_ROLE, PoolManager,
                                    PoolState, check_page_ids)

__all__ = ["Engine", "EngineConfig", "EngineCore", "PrefillRole",
           "DecodeRole", "PoolState", "ServeReport"]


@dataclasses.dataclass
class EngineConfig:
    """``max_len`` bounds prompt + generation (the KV slot depth);
    ``sync_interval`` is the decode-chunk length between host syncs;
    ``pad_token`` fills empty slots. Prompts prefill at their exact
    length: the reference's prompt bucketing exists only to bound XLA
    compiles, and eager PyTorch has none.

    ``speculate_tokens`` (k) turns on speculative decoding in the serve
    loops: one width-(k+1) verify forward a boundary instead of a
    ``sync_interval``-step chunk; greedy outputs are those of
    ``speculate_tokens=0``. Attention-only models; size k with
    :func:`repro_torch.serve.scheduler.derive_speculate_tokens`.

    ``disaggregate`` routes serving by prefill and decode roles over the
    shared paged pool (see the module docstring); it requires the paged
    pool.

    ``mesh`` serves this rank's part of a sharded model (see the module
    docstring); the params handed to the engine are then the rank's
    shards. ``None`` is the single-device path.

    ``phase_timing`` charges each phase's wall time (prefill / insert /
    generate / drain / handover), blocked on the device, to
    ``last_stats["phase_s"]`` and, by role, ``["role_s"]``: benchmark
    mode only, since blocking serialises the host's issue ahead of the
    device."""

    max_len: int
    eos_token: int = 1
    sync_interval: int = 8
    pad_token: int = 0
    speculate_tokens: int = 0
    phase_timing: bool = False
    disaggregate: bool = False
    mesh: Optional[Any] = None


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


def _leaves(tree: Any, names, under: str = ""):
    """``(parent key, key, leaf)`` of every leaf of ``tree`` named in
    ``names``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, names, k)
        elif k in names:
            yield under, k, v


def _check_shards(cfg, params: Any, mesh) -> None:
    """Raise unless ``params`` look like this rank's shards on ``mesh``:
    the embedding table holds the rows ``spec_for_param`` gives a rank,
    each routed expert leaf ``n_experts / M`` experts, each MLA layer's
    ``wq_b`` / ``wkv_b`` columns and ``wo`` rows ``n_heads / M`` heads',
    and the shared experts' ``w_gate`` / ``w_up`` columns and ``w_down``
    rows a rank's share of their width (whole where it does not split)."""
    m = shd.model_axis_size(mesh)
    table = params["tok"]["embed"]
    want = shd.local_shard(torch.empty((cfg.padded_vocab, 0)),
                           shd.spec_for_param("tok/embed",
                                              (cfg.padded_vocab, 0), mesh),
                           mesh).shape[0]
    held = [f"the embedding holds {table.shape[0]} rows, a rank's shard "
            f"{want}"] if table.shape[0] != want else []
    if cfg.n_experts:
        e_loc = cfg.n_experts // m
        held += [f"an expert leaf holds {w.shape[-3]} experts, a rank's "
                 f"shard {e_loc}"
                 for _, _, w in _leaves(params, ("we_gate", "we_up",
                                                 "we_down"))
                 if w.shape[-3] != e_loc][:1]
    if cfg.use_mla:
        h = cfg.n_heads // m
        widths = {"wq_b": (-1, h * (cfg.qk_nope_head_dim
                                    + cfg.qk_rope_head_dim)),
                  "wkv_b": (-1, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                  "wo": (-2, h * cfg.v_head_dim)}
        held += [f"MLA's {k} holds {w.shape[widths[k][0]]} of its head "
                 f"dim, a rank's {h} heads {widths[k][1]}"
                 for parent, k, w in _leaves(params, tuple(widths))
                 if parent == "attn" and w.shape[widths[k][0]]
                 != widths[k][1]][:1]
    if cfg.n_shared_experts:
        f = cfg.moe_d_ff * cfg.n_shared_experts
        f_loc = f // m if f % m == 0 else f
        dims = {"w_gate": -1, "w_up": -1, "w_down": -2}
        held += [f"a shared-expert {k} holds {w.shape[dims[k]]} of its "
                 f"width {f}, a rank's shard {f_loc}"
                 for parent, k, w in _leaves(params, tuple(dims))
                 if parent == "shared" and w.shape[dims[k]] != f_loc][:1]
    if held:
        raise ValueError(
            f"EngineConfig(mesh=...) serves this rank's shards of the "
            f"params (Model.init_serving(gen, mesh=mesh), "
            f"bridge.sharded_from_numpy); {held[0]}")


def _to_host(tree):
    if torch.is_tensor(tree):
        return tree.cpu().numpy()
    return type(tree)(_to_host(t) for t in tree)


class EngineCore:
    """What the roles share: the serving params, kernel plans, device
    placement and host IO."""

    def __init__(self, model: Model, params: Any, ecfg: EngineConfig):
        self.model = model
        self.device = model.device
        self.mesh = ecfg.mesh
        if self.mesh is not None:
            tp.check_serving(model.cfg, self.mesh.shape)
            _check_shards(model.cfg, params, self.mesh)
        self.params = model.prepare(params)
        self.ecfg = ecfg
        self.plans = model.kernel_plans(ecfg.max_len, ecfg.max_len)
        self.last_stats: Dict[str, Any] = {}
        if self.mesh is not None:
            # the model group's first collective sets its communicator up
            # here, never inside a decode chunk
            with self.scope():
                tp.all_sum(torch.zeros(1, device=self.device))

    def scope(self):
        """The context every model call of this engine runs in: the
        serving mesh's (:func:`repro_torch.distributed.tensor_parallel.
        use_mesh`), or nothing on the single-device path."""
        return tp.use_mesh(self.mesh)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token over the last dim of logits the model returned
        with ``full_logits=False`` (int64; under a mesh every rank gets
        the same ids)."""
        cfg = self.model.cfg
        return tp.greedy(logits, cfg.vocab_size, cfg.padded_vocab)

    def _fetch(self, tree, role: Optional[str] = None):
        """The ONLY device->host read path, issued at drain boundaries and
        counted in ``last_stats["host_syncs"]`` (and under ``role`` in
        ``["host_syncs_by_role"]`` when serving disaggregated)."""
        self.last_stats["host_syncs"] = self.last_stats.get("host_syncs", 0) + 1
        if role is not None:
            by = self.last_stats.setdefault("host_syncs_by_role", {})
            by[role] = by.get(role, 0) + 1
        return _to_host(tree)

    def _timed(self, phase: str, fn, *args, role: Optional[str] = None):
        """Run ``fn(*args)``; with ``phase_timing`` on, wait for the device
        (``torch.cuda.synchronize`` on the card, after ``fn`` returns, so
        never inside a chunk) and charge the wall time to
        ``last_stats["phase_s"][phase]`` and ``["role_s"][role]``."""
        if not self.ecfg.phase_timing:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        acc = self.last_stats.setdefault("phase_s", {})
        acc[phase] = acc.get(phase, 0.0) + dt
        if role is not None:
            racc = self.last_stats.setdefault("role_s", {})
            racc[role] = racc.get(role, 0.0) + dt
        return out

    def tensor(self, data, dtype=torch.int32) -> torch.Tensor:
        """A host->device upload (never inside a decode chunk)."""
        return torch.as_tensor(np.asarray(data), dtype=dtype,
                               device=self.device)


class PrefillRole:
    """Admissions (whole-prompt, suffix-only and chunked) over the pool."""

    name = PREFILL_ROLE

    def __init__(self, core: EngineCore, pools: PoolManager):
        self.core = core
        self.pools = pools

    def _prompt(self, prompt) -> np.ndarray:
        """The prompt as int32 tokens, refused when it exceeds the KV slot
        depth."""
        tokens = np.asarray(prompt, np.int32)
        max_len = self.core.ecfg.max_len
        if tokens.shape[0] > max_len:
            raise ValueError(
                f"prompt of {tokens.shape[0]} tokens exceeds the KV slot "
                f"depth (max_len={max_len})")
        return tokens

    def _prefill(self, tokens: np.ndarray, depth: int, prefix_len: int = 0,
                 prefix=None):
        """Prefill one row of ``tokens`` (a tail after ``prefix_len``
        cached positions when ``prefix`` is given). Returns (logits at the
        row's last token, row state)."""
        core = self.core
        return core.model.prefill(
            core.params, {"tokens": core.tensor(tokens[None])}, depth,
            plans=core.plans, prefix_len=prefix_len, prefix_state=prefix,
            full_logits=False)

    def _arm(self, pool: PoolState, slot: int, logits: torch.Tensor,
             kv_len: int, budget: int) -> Tuple[PoolState, torch.Tensor]:
        """Arm ``slot`` with the first token read from ``logits`` and a
        ``kv_len``-deep KV prefix; the token stays on the device until the
        next drain."""
        ecfg = self.core.ecfg
        first = self.core.greedy(logits[0, -1]).to(torch.int32)
        pool.tok[slot] = first
        pool.cache_len[slot] = kv_len
        pool.done[slot] = ((first == ecfg.eos_token) | (budget <= 1)
                           | (kv_len >= ecfg.max_len))
        pool.n_gen[slot] = 1
        pool.budget[slot] = budget
        return pool, first

    def _chunk_tokens(self, step: sched_mod.PrefillStep) -> np.ndarray:
        return np.asarray(step.req.prompt, np.int32)[
            step.start:step.start + step.n_tokens]

    def _after_chunk(self, pool: PoolState, step: sched_mod.PrefillStep,
                     logits: torch.Tensor
                     ) -> Tuple[PoolState, Optional[torch.Tensor]]:
        """A non-final chunk only advances ``cache_len`` and keeps the slot
        done-masked (a slot freed by preempting a mid-decode request still
        reads done=False on the device, and the interleaved decode chunk
        must not decode a half-prefilled slot); the final chunk arms the
        slot exactly like an admission."""
        new_len = step.start + step.n_tokens
        if not step.final:
            pool.cache_len[step.slot] = new_len
            pool.done[step.slot] = True
            return pool, None
        return self._arm(pool, step.slot, logits, new_len,
                         step.req.max_new_tokens)

    # ------------------------------------------------------ dense slab
    def admit_into_slot(self, pool: PoolState, slot: int,
                        prompt: np.ndarray, max_new_tokens: int
                        ) -> Tuple[PoolState, torch.Tensor]:
        """Prefill ``prompt`` and write its ``max_len``-deep row into
        ``slot`` of the dense slab (in-flight slots untouched). Returns
        (pool, first token)."""
        tokens = self._prompt(prompt)
        logits, row = self._prefill(tokens, self.core.ecfg.max_len)
        self.core.model.slot_update(pool.state, row, slot)
        return self._arm(pool, slot, logits, len(tokens), max_new_tokens)

    def exec_dense_chunk(self, pool: PoolState, step: sched_mod.PrefillStep
                         ) -> Tuple[PoolState, Optional[torch.Tensor]]:
        """One planned prefill chunk on the dense slab: the chunk attends
        over the slot's own row (earlier chunks' K/V, read by
        :meth:`~repro_torch.models.api.Model.gather_row`) and the updated
        row is written back. Returns (pool, first token or None)."""
        model = self.core.model
        prefix = model.gather_row(pool.state, step.slot)
        logits, row = self._prefill(self._chunk_tokens(step),
                                    self.core.ecfg.max_len, step.start,
                                    prefix)
        model.slot_update(pool.state, row, step.slot)
        return self._after_chunk(pool, step, logits)

    # ------------------------------------------------------- paged pool
    def _page_row(self, row: np.ndarray, geom: sched_mod.PageGeometry,
                  what: str) -> torch.Tensor:
        return self.core.tensor(check_page_ids(row, geom.n_pages, what))

    def paged_admit(self, pool: PoolState, slot: int,
                    req: sched_mod.Request, geom: sched_mod.PageGeometry
                    ) -> Tuple[PoolState, torch.Tensor]:
        """Prefill ``req``'s prompt at the pool's page-aligned depth, cut it
        into pages at the slot's block-table row and arm the slot. Returns
        (pool, first token)."""
        tokens = self._prompt(req.prompt)
        block_row = self.pools.pad_pages(req.pages, geom.max_pages_per_slot,
                                         geom.n_pages)
        logits, row = self._prefill(tokens, geom.depth)
        self.core.model.slot_update_paged(pool.state, row, slot, block_row,
                                          geom.page_tokens)
        return self._arm(pool, slot, logits, len(tokens), req.max_new_tokens)

    def _paged_resume(self, pool: PoolState, slot: int, tokens: np.ndarray,
                      prefix_len: int, read: np.ndarray, write: np.ndarray,
                      geom: sched_mod.PageGeometry):
        """Gather the pages ``read`` maps into a dense row, prefill the
        tail at ``prefix_len`` and scatter the row through ``write``."""
        model = self.core.model
        prefix = model.gather_row_paged(
            pool.state, self._page_row(read, geom, "read row"),
            geom.page_tokens)
        logits, row = self._prefill(tokens, geom.depth, prefix_len, prefix)
        model.slot_update_paged(pool.state, row, slot,
                                self._page_row(write, geom, "write row"),
                                geom.page_tokens)
        return logits

    def shared_paged_admit(self, pool: PoolState, slot: int,
                           req: sched_mod.Request,
                           geom: sched_mod.PageGeometry
                           ) -> Tuple[PoolState, torch.Tensor]:
        """A prefix-index hit: prefill ONLY the unmatched suffix.

        ``read_row`` maps the pages the suffix attends over: the shared
        full pages, plus — when the match ends mid-page — the COW *source*
        page at the frontier index. ``write_row`` maps where the suffix's
        K/V lands: null (page 0) under the shared prefix, the request's own
        fresh pages from the frontier on. The frontier page is therefore
        read from the canonical copy but written to a private one, and
        shared history is never written."""
        pt, p_max = geom.page_tokens, geom.max_pages_per_slot
        tokens = self._prompt(req.prompt)
        f_w = req.prefix_len // pt                  # frontier logical page
        read = np.zeros((p_max,), np.int32)
        read[:req.n_shared] = req.pages[:req.n_shared]
        if req.cow_src >= 0:
            read[f_w] = req.cow_src
        write = np.zeros((p_max,), np.int32)
        write[f_w:len(req.pages)] = req.pages[f_w:]
        logits = self._paged_resume(pool, slot, tokens[req.prefix_len:],
                                    req.prefix_len, read, write, geom)
        return self._arm(pool, slot, logits, len(tokens),
                         req.max_new_tokens)

    def exec_prefill_chunk(self, pool: PoolState,
                           step: sched_mod.PrefillStep,
                           geom: sched_mod.PageGeometry
                           ) -> Tuple[PoolState, Optional[torch.Tensor]]:
        """One planned prefill chunk on the paged pool.

        ``read_row`` maps every page holding KV the chunk attends over: the
        request's own pages below the cursor (the shared prefix pages for
        its leading entries), plus the copy-on-write source when the first
        chunk starts at a mid-page prefix match. ``write_row`` maps the
        pages the chunk's K/V lands in, from the cursor's page on (the
        whole-page scatter re-writes the frontier page's earlier tokens
        with the content just gathered, so a COW source is copied private
        on the first chunk for free). The chunk prefills at its exact
        length, at the host-int cursor ``step.start``."""
        req = step.req
        pt, p_max = geom.page_tokens, geom.max_pages_per_slot
        f_r = -(-step.start // pt)              # pages covering [0, start)
        read = np.zeros((p_max,), np.int32)
        read[:f_r] = req.pages[:f_r]
        if step.start == req.prefix_len and req.cow_src >= 0:
            read[step.start // pt] = req.cow_src
        f_w = step.start // pt                  # cursor's (frontier) page
        end_pages = geom.pages_for(step.start + step.n_tokens)
        write = np.zeros((p_max,), np.int32)
        write[f_w:end_pages] = req.pages[f_w:end_pages]
        logits = self._paged_resume(pool, step.slot, self._chunk_tokens(step),
                                    step.start, read, write, geom)
        return self._after_chunk(pool, step, logits)


class DecodeRole:
    """Batched decode and speculative-verify chunks over the pool: the
    device's work between two drain boundaries, with no host read. In
    disaggregated serving its block table carries only the rows it owns:
    a done-masked slot it does not own writes its junk K/V to the null
    page, never to that slot's pages."""

    name = DECODE_ROLE

    def __init__(self, core: EngineCore, pools: PoolManager):
        self.core = core
        self.pools = pools

    def decode_chunk(self, n: int):
        """``n`` one-shot decode steps with on-device EOS masking — the
        :meth:`Engine.generate` substrate."""
        core = self.core
        ecfg, plans = core.ecfg, core.plans

        def run(params, tok, state, cache_len, done):
            toks = []
            with device_only(core.device):
                for _ in range(n):
                    logits, state = core.model.decode_step(
                        params, tok[:, None], state, cache_len, plans=plans,
                        full_logits=False)
                    nxt = core.greedy(logits[:, -1])
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
        ecfg, plans = core.ecfg, core.plans

        def run(params, pool: PoolState):
            toks, valid = [], []
            with device_only(core.device):
                for _ in range(n):
                    logits, state = core.model.decode_step(
                        params, pool.tok[:, None], pool.state, pool.cache_len,
                        plans=plans, block_tables=pool.block_tables,
                        full_logits=False)
                    nxt = core.greedy(logits[:, -1])
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

    def verify_fn(self, k: int):
        """The speculative boundary: ONE width-(k+1) verify forward over
        ALL slots, folded into the pool's done-masked updates.

        A slot's verify row is its last emitted token, then its k drafts
        (``drafts`` ``(S, k)`` int32 on the device, ``dlen`` of them real),
        so argmax column j is what the j-th sequential :meth:`pool_chunk`
        step would give; :func:`~repro_torch.serve.speculate.
        fold_acceptance` emits the longest agreeing prefix plus one token
        and rolls ``cache_len`` back over the rest. Returns (pool, tokens,
        valid), the last two ``(k+1, S)`` like :meth:`pool_chunk`'s. The
        verify forward attends as a decode step does: on the card the paged
        kernel walks the pool once per query column (the reference gathers
        + runs the oracle), the masked oracle covers the slab."""
        core = self.core
        ecfg, plans = core.ecfg, core.plans

        def run(params, pool: PoolState, drafts: torch.Tensor,
                dlen: torch.Tensor):
            with device_only(core.device):
                tokens = torch.cat([pool.tok[:, None], drafts], dim=1)
                logits, state = core.model.verify_step(
                    params, tokens, pool.state, pool.cache_len, plans=plans,
                    block_tables=pool.block_tables, full_logits=False)
                targets = core.greedy(logits).to(torch.int32)  # (S, k+1)
                fold = spec_mod.fold_acceptance(
                    targets, drafts, dlen, done=pool.done, n_gen=pool.n_gen,
                    budget=pool.budget, cache_len=pool.cache_len,
                    max_len=ecfg.max_len, eos_token=ecfg.eos_token)
                toks = torch.where(fold.valid, targets, ecfg.eos_token)
                new = PoolState(state=state, tok=fold.tok,
                                cache_len=fold.cache_len, done=fold.done,
                                n_gen=fold.n_gen, budget=pool.budget,
                                block_tables=pool.block_tables)
            return new, toks.T, fold.valid.T

        return run

    def build_drafts(self, sch: sched_mod.Scheduler, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side drafts for every live slot, from the slot's prompt and
        emitted tokens (:func:`~repro_torch.serve.speculate.propose_ngram`).
        Slots with nothing to propose from — free, mid-prefill, or admitted
        at this boundary (first token still on the device) — get ``dlen =
        0``, which the fold turns into an ordinary single-token step."""
        drafts = np.zeros((sch.n_slots, k), np.int32)
        dlen = np.zeros((sch.n_slots,), np.int32)
        for slot, req in sch.active.items():
            if req.status != sched_mod.DECODING or not req.tokens:
                continue
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.tokens, np.int32)])
            d = spec_mod.propose_ngram(ctx, k)
            drafts[slot, :d.shape[0]] = d
            dlen[slot] = d.shape[0]
        return drafts, dlen


class Engine:
    """One :class:`EngineCore`, one :class:`PoolManager`, a
    :class:`PrefillRole` and a :class:`DecodeRole`, plus the serve loop.
    With ``EngineConfig(disaggregate=True)`` (paged pool) the loop routes
    work, host syncs and timing by role and executes the scheduler's page
    handovers; otherwise both roles run as one engine."""

    def __init__(self, model: Model, params: Any, ecfg: EngineConfig):
        if ecfg.speculate_tokens and has_recurrent_state(model.cfg):
            raise ValueError(
                "speculative decoding requires attention-only models: "
                "recurrent SSM state cannot roll back rejected draft tokens")
        self.core = EngineCore(model, params, ecfg)
        self.pools = PoolManager(model, ecfg)
        self.prefill_role = PrefillRole(self.core, self.pools)
        self.decode_role = DecodeRole(self.core, self.pools)
        # the layer-2 host tier: the paged pool of the LAST serve() call,
        # kept so idle sessions can park between calls, and the contents
        # of resumed sessions by rid until a boundary re-admits them
        self._last_pool: Optional[PoolState] = None
        self._last_spill: Optional[Dict[str, Any]] = None
        self._park_pending: Dict[int, Dict[str, torch.Tensor]] = {}

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
        with self.core.scope():
            return self.model.prefill(self.params, batch, self.ecfg.max_len,
                                      plans=self.plans)

    def generate(self, batch: Dict[str, torch.Tensor], n_steps: int
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Greedy continuation. Returns (tokens (B, <=n_steps), state).

        Rows that hit EOS are frozen on the device (EOS fill); the host
        reads the done mask once per ``sync_interval`` chunk and stops
        early at that granularity — never per token.
        """
        with self.core.scope():
            return self._generate(batch, n_steps)

    def _generate(self, batch, n_steps):
        self.last_stats = {"host_syncs": 0, "decode_steps": 0}
        cfg, eos = self.model.cfg, self.ecfg.eos_token
        logits, state = self.model.prefill(self.params, batch,
                                           self.ecfg.max_len,
                                           plans=self.plans,
                                           full_logits=False)
        # a frontend's embeddings fill the first cache positions; an
        # enc-dec model's source frames live in the encoder, not the cache
        prompt_len = batch["tokens"].shape[1]
        if cfg.family != "encdec":
            prompt_len += cfg.frontend_len
        cache_len = torch.tensor(prompt_len, dtype=torch.int32,
                                 device=self.core.device)
        tok = self.core.greedy(logits[:, -1]).to(torch.int32)
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

    # ------------------------------------------- layer-2 host tier (park)
    def park_request(self, sch: sched_mod.Scheduler, rid: int) -> bytes:
        """Park an active DECODING session to the host tier, between
        :meth:`serve` calls.

        Reads the contents of every page the session maps (codes and
        per-page scales, verbatim: lossless at any codec) and its per-slot
        rows off the last serve()'s pool, packs them with the scheduler
        residue (:func:`~repro_torch.serve.park.pack_parked`), then frees
        the slot and its pages (:meth:`Scheduler.park`). This is a
        device->host read, so it runs outside serve(), whose chunks make
        such reads errors. Feed the blob to :meth:`resume_parked`."""
        if has_recurrent_state(self.model.cfg):
            raise ValueError(
                "host parking requires attention-only models: recurrent SSM "
                "state is per-slot, not paged")
        slot = next((s for s, r in sch.active.items() if r.rid == rid), None)
        if slot is None:
            raise KeyError(f"rid {rid} is not active; only resident "
                           f"sessions park")
        req = sch.active[slot]
        if req.status != sched_mod.DECODING:
            raise ValueError(
                "only decoding sessions park — a mid-prefill request has "
                "no emitted token to resume from; requeue it instead")
        if self._last_pool is None:
            raise RuntimeError("park_request follows a serve() call — no "
                               "paged pool state is staged")
        caches = self._last_pool.state["caches"]
        pages = torch.as_tensor(
            check_page_ids(req.pages, sch.pages.n_pages, "park row"),
            device=self.core.device).long()
        arrays: Dict[str, torch.Tensor] = {}
        for gname, gkey, attn in transformer.cache_attn_kinds(
                self.model.cfg):
            for name, arr in caches[gname][gkey].items():
                key = f"{gname}/{gkey}/{name}"
                if attn != "mamba":
                    arrays["pages/" + key] = as_bits(arr)[:, pages].view(
                        arr.dtype)
                else:
                    arrays["rows/" + key] = arr[:, slot:slot + 1]
        meta = {"prompt": [int(t) for t in req.prompt],
                "tokens": [int(t) for t in req.tokens],
                "max_new_tokens": int(req.max_new_tokens),
                "cache_len": int(req.cache_len),
                "n_pages": len(req.pages)}
        blob = park_mod.pack_parked(meta, arrays)
        sch.park(slot)
        self.pools.release(slot)
        return blob

    def resume_parked(self, sch: sched_mod.Scheduler,
                      blob: bytes) -> sched_mod.Request:
        """Re-enter a parked session: rebuild its scheduler residue
        (:meth:`Scheduler.submit_parked`) and stage its page contents for
        the boundary that re-admits it."""
        meta, arrays = park_mod.unpack_parked(blob)
        req = sch.submit_parked(meta["prompt"], meta["max_new_tokens"],
                                meta["tokens"])
        self._park_pending[req.rid] = arrays
        return req

    def _exec_resume(self, pool: PoolState, rs: sched_mod.ResumeStep,
                     geom: sched_mod.PageGeometry) -> PoolState:
        """Scatter a parked session's staged contents into its freshly
        mapped pages and re-arm its slot for decode.

        Only PRIVATE logical pages are written: shared (prefix re-matched)
        pages already hold the canonical bytes, at fp16 bit-identical to
        the parked copies. Parked pages past the new mapping sit past the
        KV frontier and are dropped; mapped pages past the parked coverage
        stay as they are until decode writes them (an int8 page's scale
        resets at offset 0). The page ids are checked on the host before
        upload, as every other row is."""
        req, slot = rs.req, rs.slot
        arrays = self._park_pending.pop(req.rid)
        n_shared = req.n_shared
        parked_n = next((v.shape[1] for key, v in arrays.items()
                         if key.startswith("pages/")), len(req.pages))
        k = min(parked_n, len(req.pages)) - n_shared
        priv = torch.as_tensor(
            check_page_ids(req.pages[n_shared:n_shared + k], geom.n_pages,
                           "resume row"), device=self.core.device).long()
        caches = pool.state["caches"]
        for gname, gkey, attn in transformer.cache_attn_kinds(
                self.model.cfg):
            for name, arr in caches[gname][gkey].items():
                key = f"{gname}/{gkey}/{name}"
                if attn != "mamba":
                    src = arrays["pages/" + key][:, n_shared:n_shared + k]
                    as_bits(arr)[:, priv] = as_bits(src).to(arr.device)
                else:
                    arr[:, slot:slot + 1] = arrays["rows/" + key].to(
                        arr.device)
        pool.tok[slot] = int(req.tokens[-1])
        pool.cache_len[slot] = req.cache_len
        pool.done[slot] = False
        pool.n_gen[slot] = len(req.tokens)
        pool.budget[slot] = req.max_new_tokens
        return pool

    # ------------------------------------------------------------ serve
    def _start_stats(self, disagg: bool) -> None:
        self.last_stats = {"host_syncs": 0, "decode_steps": 0, "chunks": 0,
                           "admissions": 0}
        if disagg:
            self.last_stats.update(
                host_syncs_by_role={PREFILL_ROLE: 0, DECODE_ROLE: 0},
                decode_tokens=0)
        if self.ecfg.speculate_tokens:
            self.last_stats.update(speculate_tokens=self.ecfg.speculate_tokens,
                                   spec_proposed=0, spec_accepted=0)

    def _decode_and_drain(self, sch: sched_mod.Scheduler, pool: PoolState,
                          pending_first: List[Tuple[sched_mod.Request,
                                                    torch.Tensor]],
                          step_clock: int, disagg: bool
                          ) -> Tuple[PoolState, int, Tuple[int, int], float]:
        """The boundary's decode work — one ``sync_interval`` decode chunk,
        or one verify forward when speculating — over every slot, then its
        host sync: ONE fetch of the chunk's tokens, the done mask and any
        pending first tokens; disaggregated, one decode-role fetch and a
        prefill-role fetch only when a prompt completed. Drained slots are
        freed. Returns (pool, step clock, (tokens emitted, requests that
        received one), the decode role's wall time: its dispatch and its
        drain)."""
        core, dec, stats = self.core, self.decode_role, self.last_stats
        spec_k = self.ecfg.speculate_tokens
        dec_role = DECODE_ROLE if disagg else None
        t_dec = time.perf_counter()
        if spec_k:
            # one verify forward replaces the sync_interval-step chunk; the
            # boundary still costs exactly one host sync a role below
            drafts, dlen = dec.build_drafts(sch, spec_k)
            pool, toks, valid = core._timed(
                "generate", dec.verify_fn(spec_k), core.params, pool,
                core.tensor(drafts), core.tensor(dlen), role=dec_role)
            step_clock += 1
            stats["decode_steps"] += 1
            stats["spec_proposed"] += int(dlen.sum())
        else:
            n = self.ecfg.sync_interval
            pool, toks, valid = core._timed(
                "generate", dec.pool_chunk(n), core.params, pool,
                role=dec_role)
            step_clock += n
            stats["decode_steps"] += n
        stats["chunks"] += 1
        if disagg:
            toks_h, valid_h, done_h = core._timed(
                "drain", core._fetch, (toks, valid, pool.done), DECODE_ROLE,
                role=DECODE_ROLE)
            decode_wall = time.perf_counter() - t_dec
            firsts = []
            if pending_first:
                firsts = core._timed(
                    "drain", core._fetch, [f for _, f in pending_first],
                    PREFILL_ROLE, role=PREFILL_ROLE)
        else:
            toks_h, valid_h, done_h, firsts = core._timed(
                "drain", core._fetch,
                (toks, valid, pool.done, [f for _, f in pending_first]))
            decode_wall = time.perf_counter() - t_dec
        emitted = len(firsts)
        t_drained = time.perf_counter()
        fed = set()         # rids that received a token at this boundary
        for (req, _), f in zip(pending_first, firsts):
            req.tokens.append(int(f))
            # the first token becomes real only at THIS drain
            req.first_step, req.first_wall = step_clock, t_drained
            fed.add(req.rid)
        pending_first.clear()
        for slot in sorted(sch.active):
            req = sch.active[slot]
            before = len(req.tokens)
            req.tokens.extend(
                int(t) for t, v in zip(toks_h[:, slot], valid_h[:, slot])
                if v)
            got = len(req.tokens) - before
            emitted += got
            if got:
                fed.add(req.rid)
            if disagg:
                stats["decode_tokens"] += got
            if spec_k:
                # accepted drafts + 1 correction token; a slot admitted at
                # this boundary (dlen = 0) emits 1 and accepts 0
                stats["spec_accepted"] += max(got - 1, 0)
            # a mid-prefill slot's done flag is still the free marker from
            # before its admission: only DECODING slots can drain
            if done_h[slot] and req.status != sched_mod.PREFILLING:
                req.finish_step = step_clock
                self.pools.release(slot)
                sch.complete(slot)
        return pool, step_clock, (emitted, len(fed)), decode_wall

    def _run_boundaries(self, sch: sched_mod.Scheduler, pool: PoolState,
                        boundary, max_steps: Optional[int],
                        disagg: bool = False) -> PoolState:
        """The serve loop both pools share: ``boundary(pool, step_clock,
        pending_first)`` does a boundary's admissions and copies and
        returns the pool, then the decode work and the drain. Returns the
        last pool."""
        pending_first: List[Tuple[sched_mod.Request, torch.Tensor]] = []
        boundary_wall: List[float] = []
        boundary_tokens: List[int] = []
        boundary_streams: List[int] = []
        decode_wall: List[float] = []
        step_clock = 0
        while sch.has_work():
            t0 = time.perf_counter()
            pool = boundary(pool, step_clock, pending_first)
            pool, step_clock, (emitted, streams), t_dec = \
                self._decode_and_drain(sch, pool, pending_first, step_clock,
                                       disagg)
            boundary_wall.append(time.perf_counter() - t0)
            boundary_tokens.append(emitted)
            boundary_streams.append(streams)
            decode_wall.append(t_dec)
            if max_steps is not None and step_clock >= max_steps:
                break
        self.last_stats["boundary_wall_s"] = boundary_wall
        self.last_stats["boundary_tokens"] = boundary_tokens
        # requests that received a token at each boundary, a request's first
        # token counted with it: the speculative inter-token clock (a verify
        # forward emits a varying number of tokens a stream)
        self.last_stats["boundary_streams"] = boundary_streams
        if disagg:
            # the inter-token clock a decode consumer sees when prefill runs
            # on its own engine (meaningful under phase_timing)
            self.last_stats["boundary_decode_wall_s"] = decode_wall
        self._finish_spec_stats()
        return pool

    def _finish_spec_stats(self) -> None:
        """Derive the acceptance summary once a serve run ends."""
        stats = self.last_stats
        if "spec_proposed" not in stats:
            return
        prop, acc = stats["spec_proposed"], stats["spec_accepted"]
        stats["spec_rejected"] = prop - acc
        stats["spec_acceptance_rate"] = acc / prop if prop else 0.0

    def _report(self, sch: sched_mod.Scheduler,
                requests: List[sched_mod.Request]) -> ServeReport:
        stats = dict(self.last_stats)
        stats.update(sch.stats())
        return ServeReport(requests=requests, stats=stats)

    def _serve_dense(self, sch: sched_mod.Scheduler,
                     max_steps: Optional[int] = None) -> ServeReport:
        """Continuous batching over the dense slot slab.

        Boundary order: admissions (an over-long prompt is rejected
        cleanly, without aborting the stream or leaking its slot) -> the
        planned prefill chunks when chunking -> decode chunk or verify
        forward -> ONE drain fetch."""
        if self.ecfg.disaggregate or sch.disaggregate:
            raise ValueError(
                "disaggregated serving requires the paged pool: page "
                "handover moves block-table rows, which the dense "
                "slot-slab pool does not have")
        chunked = sch.chunk_prefill_tokens is not None
        if chunked and has_recurrent_state(self.model.cfg):
            raise ValueError(
                "chunked prefill requires attention-only models: recurrent "
                "SSM state has no resumable KV prefix")
        core, pre, max_len = self.core, self.prefill_role, self.ecfg.max_len
        self._start_stats(False)

        def boundary(pool, step_clock, pending_first):
            for slot, req in sch.admit():
                req.admit_step = step_clock
                if req.prompt_len > max_len:
                    req.finish_step = step_clock
                    sch.complete(slot, status=sched_mod.REJECTED)
                    continue
                if chunked:
                    continue        # prefills by chunks via plan_prefill
                pool, first = core._timed(
                    "prefill", pre.admit_into_slot, pool, slot, req.prompt,
                    req.max_new_tokens)
                self.last_stats["admissions"] += 1
                req.status = sched_mod.DECODING
                pending_first.append((req, first))
            if chunked:
                for step in sch.plan_prefill():
                    pool, first = core._timed("prefill", pre.exec_dense_chunk,
                                              pool, step)
                    if step.final:
                        step.req.status = sched_mod.DECODING
                        pending_first.append((step.req, first))
            return pool

        self._run_boundaries(sch, self.pools.init_pool(sch.n_slots), boundary,
                             max_steps)
        return self._report(sch, sch.drained + list(sch.active.values()))

    @staticmethod
    def _owner_role(req: sched_mod.Request) -> str:
        """Which role a request's pool work belongs to: mid-prefill (the
        cursor short of the prompt, or still PREFILLING) is prefill-role
        work; everything decoding is decode-role work."""
        if (req.status == sched_mod.PREFILLING
                or 0 <= req.prefill_pos < req.prompt_len):
            return PREFILL_ROLE
        return DECODE_ROLE

    def _serve_paged(self, sch: sched_mod.Scheduler,
                     max_steps: Optional[int] = None) -> ServeReport:
        """Continuous batching over the paged two-tier pool.

        Boundary order: spills -> restores -> resumes of parked sessions
        (before any admission: a resumed session's pages are in the prefix
        index from plan time, so a same-boundary matcher must read settled
        bytes) -> admissions (whole-prompt, or suffix-only for a
        prefix-index hit) -> the planned prefill chunks
        (each copy in plan order, so the in-place pools see exactly the
        reference's sequence of functional updates) -> page handovers when
        disaggregated -> block-table upload (the decode role's view when
        disaggregated: only the rows it owns) -> decode chunk or verify
        forward -> the drain fetch (one a role when disaggregated).
        """
        core, pools, pre = self.core, self.pools, self.prefill_role
        disagg = self.ecfg.disaggregate or sch.disaggregate
        if disagg and not sch.disaggregate:
            sch.enable_disaggregation()
        ssm = has_recurrent_state(self.model.cfg)
        if sch.prefix_index is not None and ssm:
            raise ValueError(
                "prefix sharing requires attention-only models: recurrent "
                "SSM state is per-sequence, not per-page")
        if sch.chunk_prefill_tokens is not None and ssm:
            raise ValueError(
                "chunked prefill requires attention-only models: recurrent "
                "SSM state has no resumable KV prefix")
        # every serve() builds a fresh spill tier: a request still preempted
        # into layer 1 by an earlier call would be restored from zeros
        stranded = [r.rid for r in sch.queue
                    if r.status == sched_mod.PREEMPTED]
        if stranded:
            raise ValueError(
                f"requests {stranded} are still preempted into the layer-1 "
                f"spill tier of an earlier serve() call, which this call "
                f"does not keep: their restore would read zeros. Serve the "
                f"stream to the end in one call, or park sessions only when "
                f"no request is preempted")
        geom = sch.pages
        self._start_stats(disagg)
        pool, spill = pools.init_paged_pool(sch)
        spec_k, p_max = self.ecfg.speculate_tokens, geom.max_pages_per_slot
        pre_role = PREFILL_ROLE if disagg else None
        # a speculative boundary advances a slot by up to k+1 tokens in its
        # one verify forward, so page growth is planned for k+1
        grow = spec_k + 1 if spec_k else self.ecfg.sync_interval

        def boundary(pool, step_clock, pending_first):
            nonlocal spill
            plan = sch.plan_boundary(chunk_tokens=grow,
                                     max_len=self.ecfg.max_len)
            for req in plan.rejects:
                req.finish_step = step_clock
            # spills FIRST: they copy layer-0 pages that restores/admits
            # may reuse later this boundary
            for act in plan.spills:
                spill = core._timed(
                    "insert", pools.exec_spill, pool, spill, act, p_max,
                    role=self._owner_role(act.req) if disagg else None)
            for act in plan.restores:
                role = self._owner_role(act.req) if disagg else None
                if disagg:
                    pools.claim(act.slot, role)
                pool = core._timed("insert", pools.exec_restore, pool, spill,
                                   act, p_max, role=role)
            for rs in plan.resumes:
                if disagg:
                    pools.claim(rs.slot, DECODE_ROLE)
                pool = core._timed("insert", self._exec_resume, pool, rs,
                                   geom, role=DECODE_ROLE if disagg else None)
            for slot, req in plan.admits:
                req.admit_step = step_clock
                if disagg:
                    pools.claim(slot, PREFILL_ROLE)
                if req.prefill_pos >= 0:
                    continue        # chunked admission: via prefill_steps
                admit = (pre.shared_paged_admit if req.prefix_len
                         else pre.paged_admit)
                pool, first = core._timed("prefill", admit, pool, slot, req,
                                          geom, role=pre_role)
                self.last_stats["admissions"] += 1
                req.status = sched_mod.DECODING
                pending_first.append((req, first))
            # chunk prefills AFTER every copy, in plan order; a final chunk
            # arms its slot like an admission
            for step in plan.prefill_steps:
                pool, first = core._timed("prefill", pre.exec_prefill_chunk,
                                          pool, step, geom, role=pre_role)
                if step.final:
                    step.req.status = sched_mod.DECODING
                    pending_first.append((step.req, first))
            # page handover: a request whose prompt completed this boundary
            # moves prefill -> decode by a zero-copy ownership flip; the
            # decode role's table below carries its row from now on
            for h in plan.handovers:
                core._timed("handover", pools.transfer_ownership, h.slot,
                            h.pages)
            table = sch.block_table(role=DECODE_ROLE if disagg else None)
            table = check_page_ids(table, geom.n_pages, "block table")
            return dataclasses.replace(pool, block_tables=core.tensor(table))

        pool = self._run_boundaries(sch, pool, boundary, max_steps, disagg)
        # staged for park_request between serve() calls: the next serve()
        # builds a fresh pool, and parking is how a still-active session's
        # KV survives the gap
        self._last_pool, self._last_spill = pool, spill
        return self._report(sch, sch.drained + list(sch.active.values())
                            + list(sch.queue))

    def serve(self, requests: Iterable[sched_mod.Request] = (),
              scheduler: Optional[sched_mod.Scheduler] = None, *,
              max_steps: Optional[int] = None) -> ServeReport:
        """Continuous batching over a request stream. With no scheduler the
        reference's default is built: the dense slot slab, slots derived
        for ``max_len``.

        Loop invariant: between drain boundaries everything is on the
        device. Each iteration admits queued requests into free slots (and
        runs planned prefill chunks), runs one ``sync_interval`` decode
        chunk (or one verify forward) over the whole pool, and performs ONE
        host sync (one a role when disaggregated) to read the chunk's
        tokens and done mask; drained slots are freed at once."""
        sch = scheduler or sched_mod.Scheduler.for_model(
            self.model.cfg, self.ecfg.max_len)
        for req in requests:
            sch.submit_request(req)
        with self.core.scope():
            if sch.pages is not None:
                return self._serve_paged(sch, max_steps)
            return self._serve_dense(sch, max_steps)
