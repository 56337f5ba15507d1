"""qwen2.5-3b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2.5-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
)
