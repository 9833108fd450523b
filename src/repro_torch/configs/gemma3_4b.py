"""gemma3-4b — 5 local : 1 global attention, 128k [hf:google/gemma-3; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; local window 1024,
every 6th layer global.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    d_ff=10240, vocab_size=262144,
    window=1024, global_every=6, rope_theta=1e6,
)

SMOKE_CONFIG = ArchConfig(
    name="gemma3-4b-smoke", family="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256, window=16, global_every=6,
)
