"""Plain PyTorch oracles for the kernels of this package.

Mirrors ``src/repro/kernels/ref.py``: these are the ground truth the kernels
are checked against and the implementations the model stack uses on the
CPU. All math is f32 (f64 for f64 inputs, so that gradient checks can run
through them); outputs come back in the input's dtype unless an
``out_dtype`` is given.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Offset = Union[int, torch.Tensor]


def wide(dtype: torch.dtype) -> torch.dtype:
    """The type the oracles compute in for inputs of ``dtype``: f32, or
    f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A @ B with f32 accumulation, cast to ``out_dtype`` (default
    ``a.dtype``)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _mask(sq: int, skv: int, q_offset: Offset, causal: bool,
          window: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: Offset = 0) -> torch.Tensor:
    """Multi-head attention oracle.

    q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) with
    Hq % Hkv == 0 (GQA). ``window`` masks keys further than ``window``
    positions behind the query; ``q_offset`` is the absolute position of
    q[0] (an int or a 0-d tensor). Fully masked rows give zeros.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    group = hq // hkv
    kk = k if group == 1 else k.repeat_interleave(group, dim=1)
    vv = v if group == 1 else v.repeat_interleave(group, dim=1)
    f = wide(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f), kk.to(f)) * scale
    mask = _mask(sq, skv, q_offset, causal, window, q.device)
    logits = torch.where(mask[None, None], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.to(f))
    return out.to(q.dtype)


def attention_ref_blockwise(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            q_offset: Offset = 0,
                            block_q: int = 1024,
                            block_kv: int = 1024) -> torch.Tensor:
    """Online-softmax blockwise attention (loops over blocks).

    Numerically the same function as :func:`attention_ref` with
    O(block^2) transients — the path for long sequences, and the plain
    mirror of the flash kernel's phase structure.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    group = hq // hkv
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    while sq % bq:
        bq //= 2
    while skv % bkv:
        bkv //= 2
    qf, kf, vf = q.float(), k.float(), v.float()
    neg = -torch.inf
    blocks = []
    for iq in range(sq // bq):
        qb = qf[:, :, iq * bq:(iq + 1) * bq]
        m = torch.full((b, hq, bq, 1), neg, device=q.device)
        l = torch.zeros((b, hq, bq, 1), device=q.device)
        acc = torch.zeros((b, hq, bq, dv), device=q.device)
        for ik in range(skv // bkv):
            kb = kf[:, :, ik * bkv:(ik + 1) * bkv]
            vb = vf[:, :, ik * bkv:(ik + 1) * bkv]
            if group > 1:
                kb = kb.repeat_interleave(group, dim=1)
                vb = vb.repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
            mask = _mask(bq, bkv, q_offset + iq * bq - ik * bkv, causal,
                         window, q.device)
            s = torch.where(mask[None, None], s, neg)
            m_n = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.where(m > neg, torch.exp(m - m_n), 0.0)
            p = torch.where(s > neg, torch.exp(s - m_n), 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
            m = m_n
        blocks.append(acc / torch.clamp(l, min=1e-30))
    return torch.cat(blocks, dim=2).to(q.dtype)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                       h0: Optional[torch.Tensor] = None,
                       return_state: bool = False):
    """Mamba-1 selective scan oracle (discretized zero-order hold).

    x, dt: (B, L, Di);  a: (Di, Ds);  b, c: (B, L, Ds);  d: (Di,)
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t ;  y_t = h_t . C_t + D*x_t
    A Python loop over L takes the place of the reference's ``lax.scan``.
    """
    bsz, length, di = x.shape
    ds = a.shape[1]
    f = wide(x.dtype)
    xf, dtf, bf, cf, af = (t.to(f) for t in (x, dt, b, c, a))
    h = (torch.zeros((bsz, di, ds), dtype=f, device=x.device)
         if h0 is None else h0.to(f))
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t, :, None] * af[None])
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, di))
    y = (y + xf * d.to(f)[None, None, :]).to(x.dtype)
    if return_state:
        return y, h
    return y
