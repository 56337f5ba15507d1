"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Pattern period 8: attention at offset 4, mamba elsewhere; MoE every 2nd
layer. 398B total / ~94B active (validated in tests against param_count()).
Runs long_500k (SSM state is O(1)).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=24576, moe_period=2,
    attn_period=8, attn_offset=4,
    ssm_d_state=16, ssm_expand=2, ssm_conv=4,
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    n_experts=4, top_k=2, moe_d_ff=128, moe_period=2,
    attn_period=8, attn_offset=4,
    ssm_d_state=8, ssm_expand=2, ssm_conv=4,
)
