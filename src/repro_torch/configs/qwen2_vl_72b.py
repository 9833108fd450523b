"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. The vision tower
is a STUB: input_specs feeds precomputed patch embeddings (assignment note).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    num_vision_tokens=256, mrope_sections=(16, 24, 24),
)

SMOKE_CONFIG = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256,
    num_vision_tokens=16, mrope_sections=(2, 3, 3),
)
