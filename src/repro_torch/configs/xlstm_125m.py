"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 (blocks carry their own projections) vocab=50304.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
)

SMOKE_CONFIG = ArchConfig(
    name="xlstm-125m-smoke", family="xlstm",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=256,
)
