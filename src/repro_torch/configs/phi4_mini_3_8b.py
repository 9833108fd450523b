"""phi4-mini-3.8b — RoPE SwiGLU GQA [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064,
)

SMOKE_CONFIG = ArchConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=256,
)
