"""Mamba-1 block (falcon-mamba).

The counterpart of ``src/repro/models/ssm.py``, with the same numerics:
projections in bf16 with f32 accumulation, the depthwise causal conv in
bf16 (its weights cast inside the op), dt in f32 (a bf16 projection plus
the f32 ``dt_bias``, through softplus), A, D and the state in f32.

Every selective scan goes through :func:`repro_torch.kernels.ops.selective_
scan` with ``impl="auto"``: the full-sequence forward (``cache=None``), and
prefill and decode, which carry ``(conv, ssm)`` state. The reference sends
the carried-state calls to its oracle; on the card the port sends them to
the kernel, which takes the initial state and writes the final one over
it (no copy follows the scan). The cache is updated in place, as the
port's attention caches are.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tiling
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Leaf, cast, keep, linear, randn


def init_mamba(cfg: ModelConfig, gen: torch.Generator, n: int = 1,
               leaf: Leaf = keep) -> Dict:
    """The reference's tree and leaf names, stacked ``n`` deep on a leading
    axis: S4D-real A, and a dt bias whose softplus is log-uniform in
    [1e-3, 1e-1]."""
    d, di, ds, dr = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
    dev = gen.device
    a_init = torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).expand(n, di, ds)
    u = torch.rand((n, di), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))     # inverse softplus
    k = cfg.ssm_conv
    return {
        "in_proj": leaf("in_proj", randn(gen, (n, d, 2 * di),
                                         1 / math.sqrt(d))),
        "conv_w": leaf("conv_w", randn(gen, (n, k, di), 1 / math.sqrt(k))),
        "conv_b": leaf("conv_b", torch.zeros((n, di), dtype=torch.float32,
                                             device=dev)),
        "x_proj": leaf("x_proj", randn(gen, (n, di, dr + 2 * ds),
                                       1 / math.sqrt(di))),
        "dt_proj": leaf("dt_proj", randn(gen, (n, dr, di),
                                         1 / math.sqrt(dr))),
        "dt_bias": leaf("dt_bias", dt_bias),
        "a_log": leaf("a_log", torch.log(a_init)),
        "ssm_d": leaf("ssm_d", torch.ones((n, di), dtype=torch.float32,
                                          device=dev)),
        "out_proj": leaf("out_proj", randn(gen, (n, di, d),
                                           1 / math.sqrt(di))),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, device,
                     dtype=torch.float32) -> Dict:
    """One row per sequence: the conv tail (B, K-1, Di) and the state
    (B, Di, Ds), both f32."""
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, ds), dtype=dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (B, L, Di); w: (K, Di). Returns
    (y, new_state): the last K-1 inputs, the next call's left context."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)       # (B, K-1+L, Di)
    length = x.shape[1]
    y = xp[:, 0:length] * cast(w[0])
    for i in range(1, k):
        y = y + xp[:, i:i + length] * cast(w[i])
    return y + cast(b), xp[:, -(k - 1):]


def mamba_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                cache: Optional[Dict] = None,
                plan: Optional[tiling.ScanChunkPlan] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (out, cache); the cache, when given, is updated in
    place."""
    di, ds, dr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
    xz = linear(x, p["in_proj"])
    xs, z = torch.split(xz, di, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    proj = linear(xs, p["x_proj"])
    dt, bmat, cmat = torch.split(proj, [dr, ds, ds], dim=-1)
    dt = F.softplus(linear(dt, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if cache is not None:
        y, _ = ops.selective_scan(xs, dt, a, bmat, cmat, p["ssm_d"],
                                  plan=plan, h0=cache["ssm"],
                                  return_state=True, state_in_place=True)
        cache["conv"].copy_(new_conv)
    else:
        y = ops.selective_scan(xs, dt, a, bmat, cmat, p["ssm_d"], plan=plan)

    y = y * F.silu(z)
    return linear(y, p["out_proj"]), cache
