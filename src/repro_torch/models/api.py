"""Model facade: init / loss / prefill / decode_step / slot_update_paged.

The counterpart of ``src/repro/models/api.py`` for ``family="dense"`` and
``family="ssm"``.
A :class:`Model` lives on one device: CUDA unless the caller passes
``device="cpu"``. With no card and no explicit CPU it raises — the port
never drops to the CPU silently.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.planner import KernelPlans, Mem3DPlanner
from repro_torch.core.target import HardwareTarget
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means the card; raise if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller passes device='cpu' (--device cpu)")
    return dev


#: the mamba leaves the reference casts to bf16 inside every op
#: (``src/repro/models/ssm.py``); ``a_log``, ``dt_bias`` and ``ssm_d`` stay f32
_MAMBA_MATRICES = ("in_proj", "x_proj", "dt_proj", "out_proj", "conv_w",
                   "conv_b")


def _is_matrix(name: str) -> bool:
    """Leaves the reference casts to bf16 inside every op: projection
    matrices (``w*``), the embedding tables and the mamba projections and
    conv weights."""
    return (name.startswith("w") or name in ("embed", "unembed")
            or name in _MAMBA_MATRICES)


class Model:
    """Facade over the dense GQA and Mamba-1 substrate on one device.

    The model owns a :class:`Mem3DPlanner` for the given hardware target
    (default: the process-wide current target), as in the reference.
    """

    def __init__(self, cfg: ModelConfig,
                 target: Optional[HardwareTarget] = None,
                 device: Device = None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.planner = Mem3DPlanner(target)

    # ------------------------------------------------------------ plans
    def kernel_plans(self, seq_q: int, seq_kv: Optional[int] = None, *,
                     tokens: Optional[int] = None) -> KernelPlans:
        """Capacity-partitioned block plans for this arch at one shape cell."""
        cfg = self.cfg
        seq_kv = seq_q if seq_kv is None else seq_kv
        return self.planner.plan_for(
            d_model=cfg.d_model, d_ff=max(cfg.d_ff, cfg.moe_d_ff),
            seq_q=max(seq_q, 1), seq_kv=max(seq_kv, 1),
            head_dim=cfg.head_dim if cfg.n_heads else 0,
            tokens_per_device=max(tokens or seq_q, 1),
            ssm_d_inner=cfg.ssm_d_inner if cfg.ssm_d_state else 0,
            ssm_d_state=cfg.ssm_d_state)

    # ------------------------------------------------------------- init
    def init(self, gen: torch.Generator) -> Any:
        """Random f32 params from ``gen``, made directly on the model's
        device (``gen`` must live there)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return transformer.init_lm(self.cfg, gen)

    def prepare(self, params: Any) -> Any:
        """The serving copy of ``params``: matrices cast to bf16 ONCE
        (the reference casts them inside every op; the cast is
        deterministic, so the results are bit-identical), vectors (biases,
        norm scales) left f32."""
        def walk(tree):
            return {k: (walk(v) if isinstance(v, dict)
                        else layers.cast(v) if _is_matrix(k) else v)
                    for k, v in tree.items()}
        return walk(params)

    # ------------------------------------------------------------- loss
    @torch.no_grad()
    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             plans: Optional[KernelPlans] = None):
        """Causal LM loss of one full-sequence forward (no caches), forward
        only: ``batch`` holds ``tokens`` and ``labels`` (B, S), -1 =
        ignore. Returns ``(total, {loss, aux, tokens})`` as the reference.
        The backward pass comes with training (ROADMAP A11)."""
        plans = plans or self.kernel_plans(batch["tokens"].shape[1])
        return transformer.lm_loss(self.cfg, params, batch["tokens"],
                                   batch["labels"], plans=plans)

    # ---------------------------------------------------------- serving
    def prefill(self, params, batch: Dict[str, torch.Tensor], max_len: int,
                *, plans: Optional[KernelPlans] = None,
                last_pos: Optional[torch.Tensor] = None):
        """Run the prompt, building ``max_len``-deep KV caches.

        Returns ``(logits f32 (B, 1, padded_vocab), state)``. Logits come
        from the final position, or per row from ``last_pos`` ``(B,)``.
        """
        tokens = batch["tokens"]
        plans = plans or self.kernel_plans(tokens.shape[1], max_len)
        x, caches = transformer.prefill(self.cfg, params, tokens, max_len,
                                        plans=plans)
        if last_pos is None:
            x = x[:, -1:]
        else:
            idx = last_pos.long().reshape(-1, 1, 1).expand(
                x.shape[0], 1, x.shape[2])
            x = torch.gather(x, 1, idx)
        return layers.unembed_logits(params["tok"], x), {"caches": caches}

    def decode_step(self, params, tokens: torch.Tensor,
                    state: Dict[str, Any], cache_len: torch.Tensor, *,
                    plans: Optional[KernelPlans] = None,
                    block_tables: Optional[torch.Tensor] = None):
        """One decode step for every row; ``cache_len`` is 0-d (one-shot)
        or ``(B,)`` (slots). With ``block_tables`` the state holds the
        paged pool. All masking stays on the device."""
        logits, caches = transformer.decode_step(
            self.cfg, params, tokens, state["caches"], cache_len,
            plans=plans, block_tables=block_tables)
        return logits, {**state, "caches": caches}

    def slot_update_paged(self, pool_state: Dict[str, Any],
                          row_state: Dict[str, Any], slot: int,
                          block_row: torch.Tensor, page_tokens: int
                          ) -> Dict[str, Any]:
        """Scatter a prefilled dense row into the paged pool, in place.

        The row's contiguous ``depth = P * page_tokens`` KV is cut into P
        pages and written at the physical pages ``block_row`` maps (the
        slot's block-table row; unmapped tail entries point at null page
        0, so their junk lands where no sequence reads). Recurrent SSM
        state is written to the slot's own row at ``slot``.
        """
        p_max = block_row.shape[0]
        rows = block_row.long()
        for gname, key, is_paged in transformer.paged_cache_kinds(self.cfg):
            pool_leaf = pool_state["caches"][gname][key]
            row_leaf = row_state["caches"][gname][key]
            for name, pool in pool_leaf.items():
                row = row_leaf[name]
                if not is_paged:                   # (r, 1, ...) -> slot
                    pool[:, slot] = row[:, 0].to(pool.dtype)
                    continue
                r, _, hkv, _, hd = row.shape       # (r, 1, hkv, depth, hd)
                cut = row[:, 0].reshape(r, hkv, p_max, page_tokens, hd)
                pool[:, rows] = torch.movedim(cut, 2, 1).to(pool.dtype)
        return pool_state


def build_model(cfg: ModelConfig, target: Optional[HardwareTarget] = None,
                device: Device = None) -> Model:
    return Model(cfg, target, device)
