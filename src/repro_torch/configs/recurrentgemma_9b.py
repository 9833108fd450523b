"""recurrentgemma-9b — RG-LRU + local attn, 1:2 [arXiv:2402.19427; unverified].

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000; pattern
(rec, rec, local-attn), window 2048.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    attn_every=3, window=2048,
)

SMOKE_CONFIG = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=160, vocab_size=256, attn_every=3, window=16,
)
