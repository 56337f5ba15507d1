"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H d_ff=1536(expert) vocab=102400. MLA: q_lora=1536,
kv_lora=512, qk_nope=128, qk_rope=64, v=128. First layer dense (d_ff=12288,
per the HF config). ~236B total / ~21B active (validated in tests).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab_size=102400,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense=1,
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512,
    use_mla=True, q_lora_rank=48, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=64,
    first_dense=1,
)
