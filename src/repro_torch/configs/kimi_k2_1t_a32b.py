"""kimi-k2-1t-a32b — Kimi K2 trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts
top-8, 1 shared expert, first layer dense (paper-table figures).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    num_experts=384, top_k=8, num_shared_experts=1, d_expert=2048,
    first_k_dense=1, capacity_factor=1.25,
)

SMOKE_CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    num_experts=8, top_k=2, num_shared_experts=1, d_expert=128,
    first_k_dense=1, capacity_factor=1.25,
)
