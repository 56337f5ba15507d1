"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. head_dim=128
(explicit; 5120/32 != 128 in this architecture).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="mistral-nemo-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=24,
    d_ff=128, vocab_size=512, rope_theta=1e6,
)
