"""mistral-nemo-12b — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1e6,
)

SMOKE_CONFIG = ArchConfig(
    name="mistral-nemo-12b-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32,
)
