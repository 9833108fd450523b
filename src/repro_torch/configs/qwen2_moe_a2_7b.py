"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    num_experts=60, top_k=4, num_shared_experts=4, d_expert=1408,
    capacity_factor=1.25,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=256,
    num_experts=6, top_k=2, num_shared_experts=2, d_expert=96,
    capacity_factor=1.25,
)
