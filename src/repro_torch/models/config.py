"""Model configuration and layer-pattern machinery.

Heterogeneous stacks (gemma3's 5:1 local:global, jamba's 1:7 attn:mamba with
every-other-layer MoE) are described as a repeating *pattern* of
:class:`LayerKind`s. The stack is a list of :class:`LayerGroup`s — each group
is `n_repeat` copies of a pattern, whose params are stacked on a leading axis
and driven with `jax.lax.scan` (keeps HLO size flat in depth, which matters
for the 512-device dry-run compiles).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

VOCAB_ALIGN = 256  # pad vocab to a multiple (MXU lanes x mesh divisibility)


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """What one layer is made of."""

    attn: str = "gqa"          # "gqa" | "mla" | "mamba" | "none"
    mlp: str = "mlp"           # "mlp" | "moe" | "none"
    window: Optional[int] = None   # sliding window (None = full attention)

    @property
    def tag(self) -> str:
        w = f"w{self.window}" if self.window else "full"
        return f"{self.attn}-{self.mlp}-{w}"


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    name: str
    pattern: Tuple[LayerKind, ...]
    n_repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_repeat


def _groups_size(groups: List["LayerGroup"]) -> int:
    return sum(len(g.pattern) for g in groups)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention ---
    rope_theta: float = 1e4
    qkv_bias: bool = False
    window: Optional[int] = None           # sliding-window width for local layers
    local_global_ratio: int = 0            # gemma3: N local layers per 1 global
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1                    # MoE every k-th layer (jamba: 2)
    first_dense: int = 0                   # leading dense layers (deepseek: 1)
    capacity_factor: float = 2.0
    router_aux_weight: float = 0.01
    # --- SSM (mamba) ---
    ssm_d_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0                   # 0 -> ceil(d_model/16)
    attn_period: int = 0                   # hybrid: attention every k-th layer
    attn_offset: int = 0                   # position of attn layer inside period
    # --- encoder-decoder ---
    n_encoder_layers: int = 0
    # --- frontends (vlm/audio stubs) ---
    frontend_len: int = 0                  # prefix of precomputed embeddings
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    f32_attn_logits: bool = True

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return math.ceil(self.vocab_size / VOCAB_ALIGN) * VOCAB_ALIGN

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    def kind_for_layer(self, i: int) -> LayerKind:
        """The LayerKind of absolute layer index ``i`` (decoder stack)."""
        if self.family in ("ssm",):
            return LayerKind(attn="mamba", mlp="none")
        if self.family == "hybrid":
            attn = (self.attn_period and i % self.attn_period == self.attn_offset)
            moe = (self.n_experts and i % self.moe_period == self.moe_period - 1)
            return LayerKind(attn="gqa" if attn else "mamba",
                             mlp="moe" if moe else "mlp")
        if self.local_global_ratio:
            r = self.local_global_ratio
            is_global = (i % (r + 1)) == r
            return LayerKind(attn="gqa", mlp="mlp",
                             window=None if is_global else self.window)
        attn = "mla" if self.use_mla else "gqa"
        if self.n_experts:
            moe = i >= self.first_dense and (i % self.moe_period
                                             == self.moe_period - 1)
            return LayerKind(attn=attn, mlp="moe" if moe else "mlp",
                             window=self.window)
        return LayerKind(attn=attn, mlp="mlp", window=self.window)

    def layer_groups(self) -> List[LayerGroup]:
        """Greedy factorization of the layer stack into head + repeated
        pattern + tail (head: e.g. deepseek's leading dense layer)."""
        kinds = [self.kind_for_layer(i) for i in range(self.n_layers)]
        best: Optional[List[LayerGroup]] = None
        for head in range(0, min(4, self.n_layers)):
            body = kinds[head:]
            for period in range(1, len(body) + 1):
                pattern = tuple(body[:period])
                n_rep = len(body) // period
                if list(pattern) * n_rep != body[:period * n_rep]:
                    continue
                rem = body[period * n_rep:]
                groups = []
                if head:
                    groups.append(LayerGroup("head", tuple(kinds[:head]), 1))
                groups.append(LayerGroup("blocks", pattern, n_rep))
                if rem:
                    groups.append(LayerGroup("tail", tuple(rem), 1))
                # prefer the factorization with the smallest unrolled size
                size = head + period + len(rem)
                if best is None or size < _groups_size(best):
                    best = groups
                break  # smallest period for this head
        assert best is not None
        return best

    # --- parameter / FLOP accounting (for the roofline's MODEL_FLOPS) ----
    def attn_params(self, kind: LayerKind) -> int:
        d = self.d_model
        if kind.attn == "mamba":
            di, ds, dr = self.ssm_d_inner, self.ssm_d_state, self.dt_rank
            return (d * 2 * di + di * self.ssm_conv + di * (dr + 2 * ds)
                    + dr * di + di * ds + di + di * d)
        if kind.attn == "mla":
            qd = self.qk_nope_head_dim + self.qk_rope_head_dim
            q_in = self.q_lora_rank or d
            p = (d * self.q_lora_rank if self.q_lora_rank else 0)
            p += q_in * self.n_heads * qd
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim
                                                     + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        if kind.attn == "gqa":
            hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
            return d * hd * (hq + 2 * hkv) + hq * hd * d
        return 0

    def mlp_params(self, kind: LayerKind) -> Tuple[int, int]:
        """(total, active) params of the layer's MLP."""
        d = self.d_model
        if kind.mlp == "mlp":
            p = 3 * d * self.d_ff
            return p, p
        if kind.mlp == "moe":
            e = 3 * d * self.moe_d_ff
            total = self.n_experts * e + self.n_shared_experts * e \
                + d * self.n_experts
            active = (self.top_k + self.n_shared_experts) * e \
                + d * self.n_experts
            return total, active
        return 0, 0

    def param_count(self) -> Tuple[int, int]:
        """(total, active) decoder params incl. embeddings."""
        total = active = 0
        for i in range(self.n_layers):
            kind = self.kind_for_layer(i)
            a = self.attn_params(kind)
            mt, ma = self.mlp_params(kind)
            norms = 2 * self.d_model
            total += a + mt + norms
            active += a + ma + norms
        emb = self.padded_vocab * self.d_model
        emb_total = emb if self.tie_embeddings else 2 * emb
        # encoder stack (GQA + dense MLP per layer)
        if self.n_encoder_layers:
            enc_kind = LayerKind(attn="gqa", mlp="mlp")
            enc = self.n_encoder_layers * (self.attn_params(enc_kind)
                                           + 3 * self.d_model * self.d_ff
                                           + 2 * self.d_model)
            # cross-attention in every decoder layer
            cross = self.n_layers * (self.attn_params(enc_kind) + self.d_model)
            total += enc + cross
            active += enc + cross
        return total + emb_total, active + emb_total

    def model_flops(self, tokens: int) -> float:
        """6 * N_active * D — the roofline's MODEL_FLOPS for a train step."""
        _, active = self.param_count()
        return 6.0 * active * tokens
