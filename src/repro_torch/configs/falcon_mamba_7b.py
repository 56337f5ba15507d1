"""falcon-mamba-7b [ssm] — mamba1 arch [arXiv:2410.05355].

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16. Attention-free:
the planner's attention tiling is inapplicable; the same capacity rule sizes
the scan chunk instead (DESIGN.md §Shape-cell skip rules). Runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm_d_state=16, ssm_expand=2, ssm_conv=4,
)

REDUCED = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512,
    ssm_d_state=8, ssm_expand=2, ssm_conv=4,
)
