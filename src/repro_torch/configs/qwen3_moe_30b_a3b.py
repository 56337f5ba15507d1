"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) d_ff=768(expert) vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, rope_theta=1e6,
    n_experts=128, n_shared_experts=0, top_k=8, moe_d_ff=768,
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, rope_theta=1e6,
    n_experts=8, n_shared_experts=0, top_k=2, moe_d_ff=64,
)
