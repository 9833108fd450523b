"""whisper-large-v3 — enc-dec, conv frontend stubbed [arXiv:2212.04356].

32L decoder + 32L encoder, d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
input_specs feeds precomputed frame embeddings (assignment note).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, encoder_layers=32, act="gelu",
    cross_attend=True,
)

SMOKE_CONFIG = ArchConfig(
    name="whisper-large-v3-smoke", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=256, encoder_layers=2, act="gelu",
    cross_attend=True,
)
