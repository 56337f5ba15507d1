"""gemma3-27b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144. Sliding window 1024
on local layers; every 6th layer global. Tied embeddings. Runs long_500k
(local attention is sub-quadratic; globals are 1-in-6).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    window=1024, local_global_ratio=5, rope_theta=1e6,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-27b-smoke", family="dense",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    window=16, local_global_ratio=5, rope_theta=1e6,
    tie_embeddings=True,
)
