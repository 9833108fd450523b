"""Dispatch between the CUDA kernels and their plain versions.

Mirrors `src/repro/kernels/ops.py`: `use_kernel=None` takes the kernel for
a CUDA tensor and the plain PyTorch version for a CPU tensor, as the
reference takes the Pallas kernel on a TPU. `use_kernel=True` on a CPU
tensor raises (the kernels have no CPU mode); `use_kernel=False` takes the
plain version on any device. A failed build or launch raises.
"""
from __future__ import annotations

import torch

from . import ref
from .evict_argmin import evict_argmin_cuda
from .next_use import next_use_cuda

__all__ = ["on_cuda", "evict_argmin", "next_use", "launch_counts",
           "reset_launch_counts", "KERNELS"]

# name -> wrapper; each wrapper counts its own launches in `.launches`
KERNELS = {"evict_argmin": evict_argmin_cuda, "next_use": next_use_cuda}


def on_cuda() -> bool:
    return torch.cuda.is_available()


def _use_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    return x.is_cuda if use_kernel is None else use_kernel


def evict_argmin(scores: torch.Tensor, touch: torch.Tensor,
                 mask: torch.Tensor, *, use_kernel: bool | None = None):
    """Victim selection: lexicographic argmin of (score, touch) where mask."""
    if _use_kernel(scores, use_kernel):
        return evict_argmin_cuda(scores, touch, mask)
    return ref.evict_argmin_ref(scores, touch, mask)


def next_use(ids: torch.Tensor, num_objects: int, *,
             use_kernel: bool | None = None) -> torch.Tensor:
    """next(t) per request (T where the object never recurs), int32."""
    if _use_kernel(ids, use_kernel):
        return next_use_cuda(ids, num_objects)
    return ref.next_use_ref(ids, num_objects)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
