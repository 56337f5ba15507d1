"""Decoder-only LM: init / forward / loss / prefill / decode.

The counterpart of ``src/repro/models/transformer.py`` for dense GQA
stacks and attention-free Mamba-1 stacks (``family="ssm"``). The layer
stack is factorized into repeated superblocks
(:meth:`ModelConfig.layer_groups`) whose params are stacked on a leading
axis; a Python loop over the repeats replaces the reference's
``lax.scan``. Caches are stacked the same way, and each layer reads and
writes its slice in place (:mod:`repro_torch.models.attention`,
:mod:`repro_torch.models.ssm`). Attention layers keep K/V, paged or in a
dense slab; mamba layers keep one recurrent row per sequence, never paged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.planner import KernelPlans
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm
from repro_torch.models.config import LayerKind, ModelConfig

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"A8 MoE, A9 hybrid attention + mamba, A10 enc-dec, A7 vlm)")
    if cfg.use_mla or cfg.mrope or cfg.frontend_len or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MLA / M-RoPE / frontends / MoE are not ported yet "
            f"(ROADMAP A7, A8)")


# ----------------------------------------------------------------- init

def _init_layer(cfg: ModelConfig, kind: LayerKind, gen: torch.Generator,
                n: int) -> Params:
    d = cfg.d_model

    def norm():
        return {"scale": torch.ones((n, d), dtype=torch.float32,
                                    device=gen.device)}

    if kind.attn == "mamba":     # an ssm stack's layers have no MLP
        return {"ln1": norm(), "mamba": ssm.init_mamba(cfg, gen, n)}
    return {"ln1": norm(), "attn": attn_mod.init_gqa(cfg, gen, n),
            "ln2": norm(), "mlp": layers.init_mlp(gen, d, cfg.d_ff, n)}


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random f32 params on ``gen``'s device, in the reference's tree:
    ``params["groups"][name]["pos{i}"]`` stacked over repeats, matrices
    stored ``(d_in, d_out)``."""
    check_supported(cfg)
    params: Params = {
        "tok": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                 tie=cfg.tie_embeddings),
        "final_norm": layers.init_rmsnorm(cfg.d_model, gen.device),
        "groups": {},
    }
    for group in cfg.layer_groups():
        params["groups"][group.name] = {
            f"pos{pos}": _init_layer(cfg, kind, gen, group.n_repeat)
            for pos, kind in enumerate(group.pattern)}
    return params


# ----------------------------------------------------------- layer apply

def _apply_layer(cfg: ModelConfig, kind: LayerKind, p: Params,
                 x: torch.Tensor, *, positions, cache, cache_len,
                 plans: Optional[KernelPlans] = None, block_tables=None):
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind.attn == "mamba":
        # recurrent state is a per-slot row, never paged: block tables only
        # address the attention page pools
        y, _ = ssm.mamba_block(p["mamba"], h, cfg=cfg, cache=cache,
                               plan=plans.scan_chunk if plans else None)
        return x + y
    y, _ = attn_mod.gqa_attention(
        p["attn"], h, cfg=cfg, kind=kind, positions=positions, cache=cache,
        cache_len=cache_len, plan=plans.attention if plans else None,
        block_tables=block_tables)
    x = x + y
    return x + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _index(tree, i: int):
    if torch.is_tensor(tree):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def _run_groups(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                positions, caches=None, cache_len=None,
                plans: Optional[KernelPlans] = None, block_tables=None):
    for group in cfg.layer_groups():
        stacked = params["groups"][group.name]
        g_caches = caches.get(group.name) if caches else None
        for r in range(group.n_repeat):
            for pos, kind in enumerate(group.pattern):
                key = f"pos{pos}"
                cache = _index(g_caches[key], r) if g_caches else None
                x = _apply_layer(cfg, kind, _index(stacked[key], r), x,
                                 positions=positions, cache=cache,
                                 cache_len=cache_len, plans=plans,
                                 block_tables=block_tables)
    return x


# ----------------------------------------------------------------- public

def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            caches=None, cache_len=None,
            positions: Optional[torch.Tensor] = None,
            plans: Optional[KernelPlans] = None,
            block_tables: Optional[torch.Tensor] = None):
    """tokens: (B, S) int. Returns (final-normed hidden (B, S, d), caches);
    the caches are updated in place."""
    x = layers.embed(params["tok"], tokens)
    b, s, _ = x.shape
    if positions is None:
        start = cache_len if cache_len is not None else 0
        if torch.is_tensor(start) and start.ndim == 1:
            start = start[:, None]      # per-slot frontiers (B,)
        positions = start + torch.arange(s, dtype=torch.int32,
                                         device=x.device)[None, :]
        positions = torch.broadcast_to(positions, (b, s))
    x = _run_groups(cfg, params, x, positions=positions, caches=caches,
                    cache_len=cache_len, plans=plans,
                    block_tables=block_tables)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches


def lm_loss(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, *, loss_chunk: int = 2048,
            plans: Optional[KernelPlans] = None):
    """Causal LM loss of a full-sequence forward. labels: (B, S) int, -1 =
    ignore. As in the reference, the vocab projection and the softmax run
    in sequence chunks (the largest power-of-two share of ``loss_chunk``
    that divides S), with the padded vocab masked, so the (tokens x vocab)
    logits never materialize whole. Returns (total, {loss, aux, tokens});
    ``aux`` is 0 (no MoE layer is ported)."""
    x, _ = forward(cfg, params, tokens, plans=plans)
    b, s, _ = x.shape
    chunk = min(loss_chunk, s)
    while s % chunk:
        chunk //= 2
    neg = torch.finfo(torch.float32).min
    col = torch.arange(cfg.padded_vocab, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        li = labels[:, i:i + chunk]
        logits = layers.unembed_logits(params["tok"], x[:, i:i + chunk])
        logits = torch.where(col < cfg.vocab_size, logits.float(), neg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            li.clamp(min=0).long()[..., None])[..., 0]
        valid = (li >= 0).float()
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    loss = tot / torch.clamp(cnt, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss + cfg.router_aux_weight * aux, {"loss": loss, "aux": aux,
                                                 "tokens": cnt}


# -------------------------------------------------------------- caches

def _stack(one: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    return {k: a.unsqueeze(0).repeat((n,) + (1,) * a.ndim)
            for k, a in one.items()}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Per-layer dense decode caches ``{group: {posN: {leaf: tensor}}}``,
    stacked on the repeats: attention layers ``{k, v}`` of ``(n_repeat, B,
    Hkv, max_len, D)``, mamba layers ``{conv, ssm}`` with one f32 row per
    sequence."""
    return {group.name: {
        f"pos{pos}": _stack(
            ssm.init_mamba_cache(cfg, batch, device) if kind.attn == "mamba"
            else attn_mod.init_gqa_cache(cfg, batch, max_len, device, dtype),
            group.n_repeat)
        for pos, kind in enumerate(group.pattern)}
        for group in cfg.layer_groups()}


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_tokens: int, device,
                      dtype=torch.bfloat16) -> Dict[str, Any]:
    """Paged pool caches: every attention layer owns a flat page pool
    ``(n_repeat, n_pages, Hkv, page_tokens, D)`` (page 0 = null); recurrent
    SSM state stays a resident row per slot (``batch`` rows; in the spill
    tier, one seat per spill page), exactly as in :func:`init_caches`."""
    return {group.name: {
        f"pos{pos}": _stack(
            ssm.init_mamba_cache(cfg, batch, device) if kind.attn == "mamba"
            else attn_mod.init_gqa_pages(cfg, n_pages, page_tokens, device,
                                         dtype),
            group.n_repeat)
        for pos, kind in enumerate(group.pattern)}
        for group in cfg.layer_groups()}


def paged_cache_kinds(cfg: ModelConfig):
    """Yield ``(group_name, pos_key, is_paged)`` for every cache entry —
    the walk order spill/restore and page scatter share. ``is_paged`` is
    False for recurrent (per-slot resident) entries."""
    for group in cfg.layer_groups():
        for pos, kind in enumerate(group.pattern):
            yield group.name, f"pos{pos}", kind.attn != "mamba"


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int, *, plans: Optional[KernelPlans] = None):
    """Run the prompt into fresh ``max_len``-deep caches. Attention runs
    over the whole (zero-filled) cache depth at ``q_offset = 0``, as in the
    reference. Returns (hidden, caches)."""
    caches = init_caches(cfg, tokens.shape[0], max_len, tokens.device)
    return forward(cfg, params, tokens, caches=caches, cache_len=0,
                   plans=plans)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                caches, cache_len: torch.Tensor,
                plans: Optional[KernelPlans] = None,
                block_tables: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1); cache_len: 0-d or per-slot (B,).
    With ``block_tables`` (B, P) the caches are the paged pool. Returns
    (logits f32 (B, 1, Vpad), caches)."""
    x, caches = forward(cfg, params, tokens, caches=caches,
                        cache_len=cache_len, plans=plans,
                        block_tables=block_tables)
    return layers.unembed_logits(params["tok"], x), caches
