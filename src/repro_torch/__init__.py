"""PyTorch and CUDA port of the dollar-scored caching reference.

`repro_torch.core` holds the replay engine (`policies_torch`) and its own
copies of the host modules it needs (pricing, traces, the heap policies,
the exact optimum, regret). `repro_torch.kernels` holds the hand-written
CUDA kernels for Hopper (`sm_90a`), their plain PyTorch versions and the
dispatch between them. `repro_torch.serve` is the serving engine with its
egress-billed prefix cache, over the dense transformer of
`repro_torch.models` (configs in `repro_torch.configs`) and copies of the
billing, governance and observability layers (`egress`, `online`, `obs`).
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from . import core, kernels

__all__ = ["core", "kernels"]
