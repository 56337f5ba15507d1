"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206. Realized as 12
encoder + 12 decoder layers (DESIGN.md §Shape-cell skip rules); the speech frontend is a stub
providing precomputed frame embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
)

REDUCED = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
)
