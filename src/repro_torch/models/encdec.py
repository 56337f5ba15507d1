"""Encoder-decoder model (the seamless-m4t backbone).

The counterpart of ``src/repro/models/encdec.py``. Encoder: a stack of
bidirectional GQA self-attention + SwiGLU layers over precomputed frame
embeddings (the speech frontend is a stub). Decoder: causal GQA
self-attention with a KV cache, cross-attention to the encoder's output,
SwiGLU. The parameter tree is the reference's: ``encoder`` and ``decoder``
stacks (every leaf stacked on a leading layer axis), ``enc_norm``,
``final_norm``, ``tok``.

As in the reference's code (its module docstring speaks of a cross cache,
its ``decode`` does not keep one), every decoder call recomputes each
layer's cross K/V from ``enc_out``. Every attention call reaches
:func:`repro_torch.kernels.ops.attention` with an int offset, so on the
card the encoder's non-causal self-attention, the decoder's causal prefill
and all cross-attention (Sq = 1 at each decode step included) run the
flash kernel (at seamless' head_dim, its (64, 64) instance); the decoder's
decode steps over the dense cache take the masked oracle, the reference's
dispatch for a tensor offset.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.planner import KernelPlans
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.transformer import _index, chunked_xent, remat_call

Params = Dict[str, Any]
_KIND = LayerKind(attn="gqa", mlp="mlp")


def init_encdec(cfg: ModelConfig, gen: torch.Generator,
                leaf: layers.Leaf = layers.keep) -> Params:
    """Random f32 params on ``gen``'s device, in the reference's tree; each
    leaf goes through ``leaf`` as it is made."""
    d, dev = cfg.d_model, gen.device
    ne, nd = cfg.n_encoder_layers, cfg.n_layers

    def norm(n):
        return {"scale": leaf("scale", torch.ones(
            (n, d), dtype=torch.float32, device=dev))}

    return {
        "tok": layers.init_embed(gen, cfg.padded_vocab, d,
                                 tie=cfg.tie_embeddings, leaf=leaf),
        "encoder": {"ln1": norm(ne),
                    "attn": attn_mod.init_gqa(cfg, gen, ne, leaf),
                    "ln2": norm(ne),
                    "mlp": layers.init_mlp(gen, d, cfg.d_ff, ne, leaf)},
        "decoder": {"ln1": norm(nd),
                    "attn": attn_mod.init_gqa(cfg, gen, nd, leaf),
                    "lnx": norm(nd),
                    "xattn": attn_mod.init_gqa(cfg, gen, nd, leaf),
                    "ln2": norm(nd),
                    "mlp": layers.init_mlp(gen, d, cfg.d_ff, nd, leaf)},
        "enc_norm": layers.init_rmsnorm(d, dev, leaf),
        "final_norm": layers.init_rmsnorm(d, dev, leaf),
    }


def _encoder_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, plan) -> torch.Tensor:
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, _ = attn_mod.gqa_attention(p["attn"], h, cfg=cfg, kind=_KIND,
                                  positions=positions, causal=False,
                                  plan=plan)
    x = x + y
    return x + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x,
                                                    cfg.norm_eps))


def encode(cfg: ModelConfig, params: Params, src_embeds: torch.Tensor, *,
           plans: Optional[KernelPlans] = None,
           remat: bool = False) -> torch.Tensor:
    """src_embeds: (B, Ss, d) frame embeddings from the (stub) frontend.
    Returns the normed encoder output (B, Ss, d). ``remat`` recomputes
    each layer in the backward."""
    b, s, _ = src_embeds.shape
    plan = plans.attention if plans else None
    positions = torch.broadcast_to(
        torch.arange(s, dtype=torch.int32, device=src_embeds.device)[None],
        (b, s))
    x = src_embeds.to(layers.COMPUTE_DTYPE)
    for i in range(cfg.n_encoder_layers):
        x = remat_call(remat, _encoder_layer, cfg,
                       _index(params["encoder"], i), x, positions, plan)
    return layers.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor):
    """One decoder layer's cross-attention K and V, (B, Hkv, Ss, D)."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = layers.linear(enc_out, p["wk"], p.get("bk")).reshape(
        b, s, hkv, hd).transpose(1, 2)
    v = layers.linear(enc_out, p["wv"], p.get("bv")).reshape(
        b, s, hkv, hd).transpose(1, 2)
    return k, v


def _decoder_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   enc_out: torch.Tensor, positions: torch.Tensor, cache,
                   cache_len, plan) -> torch.Tensor:
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, _ = attn_mod.gqa_attention(p["attn"], h, cfg=cfg, kind=_KIND,
                                  positions=positions, cache=cache,
                                  cache_len=cache_len, plan=plan)
    x = x + y
    h = layers.rmsnorm(p["lnx"], x, cfg.norm_eps)
    y, _ = attn_mod.gqa_attention(
        p["xattn"], h, cfg=cfg, kind=_KIND, positions=positions,
        cross_kv=_cross_kv(cfg, p["xattn"], enc_out), plan=plan)
    x = x + y
    return x + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x,
                                                    cfg.norm_eps))


def decode(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           enc_out: torch.Tensor, *, caches=None, cache_len=None,
           plans: Optional[KernelPlans] = None, remat: bool = False):
    """The decoder stack over ``tokens`` (B, S) at ``cache_len`` (an int
    for a prefill, a 0-d tensor for a decode step; None without caches).
    Returns (final-normed hidden (B, S, d), caches), the caches written in
    place. ``remat`` recomputes each layer in the backward (without
    caches only, as in the reference)."""
    x = layers.embed(params["tok"], tokens)
    b, s, _ = x.shape
    plan = plans.attention if plans else None
    start = cache_len if cache_len is not None else 0
    positions = torch.broadcast_to(
        start + torch.arange(s, dtype=torch.int32, device=x.device)[None, :],
        (b, s))
    remat = remat and caches is None
    for i in range(cfg.n_layers):
        cache = _index(caches, i) if caches is not None else None
        x = remat_call(remat, _decoder_layer, cfg,
                       _index(params["decoder"], i), x, enc_out, positions,
                       cache, cache_len, plan)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def encdec_loss(cfg: ModelConfig, params: Params, src_embeds: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor, *,
                remat: bool = True, loss_chunk: int = 2048,
                plans: Optional[KernelPlans] = None):
    """The decoder's chunked LM loss over ``tokens`` given the source
    frames. Returns (loss, {loss, aux (0), tokens}), as the reference.
    ``remat`` recomputes each encoder and decoder layer and each loss
    chunk in the backward, as the reference remats all three."""
    enc_out = encode(cfg, params, src_embeds, plans=plans, remat=remat)
    x, _ = decode(cfg, params, tokens, enc_out, plans=plans, remat=remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return chunked_xent(cfg, params, x, labels, aux, loss_chunk, remat=remat)


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The decoder's dense self-attention caches, ``{k, v}`` of
    ``(n_layers, B, Hkv, max_len, D)``."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
