"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision frontend
is a stub (256 precomputed patch embeddings prefix the text tokens).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    mrope=True, mrope_sections=(16, 24, 24), frontend_len=256,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2-vl-2b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qkv_bias=True, rope_theta=1e6,
    mrope=True, mrope_sections=(2, 3, 3), frontend_len=8,
    tie_embeddings=True,
)
