"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its 700 W power limit), the yardstick of every
roofline share. Copied from `repro_torch.launch.roofline`. A card may run
under a lower `power.limit`: each run records it beside the shares."""

F32_FLOPS = 67e12      # FLOP/s, float32 outside the tensor cores
BF16_FLOPS = 989e12    # FLOP/s, bf16 tensor cores
HBM_BYTES_S = 3.35e12  # B/s, HBM3
MEMORY_BYTES = 80e9    # HBM3
