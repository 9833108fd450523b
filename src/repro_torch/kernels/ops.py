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
from .interval_occupancy import (interval_occupancy_cuda,
                                 occupancy_feasible_cuda)
from .next_use import next_use_cuda
from .replay_scan import replay_bytes_cuda, replay_scan_cuda

__all__ = ["on_cuda", "evict_argmin", "next_use", "interval_occupancy",
           "occupancy_feasible", "launch_counts", "reset_launch_counts",
           "KERNELS"]

# name -> wrapper; each wrapper counts its own launches in `.launches`.
# replay_scan and replay_bytes have no dispatcher here: their plain version
# is the step loop of `core.policies_torch`, and `sweep_torch` picks.
KERNELS = {"evict_argmin": evict_argmin_cuda, "next_use": next_use_cuda,
           "interval_occupancy": interval_occupancy_cuda,
           "occupancy_feasible": occupancy_feasible_cuda,
           "replay_scan": replay_scan_cuda,
           "replay_bytes": replay_bytes_cuda}


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
             use_kernel: bool | None = None, with_rank: bool = False):
    """next(t) per request (T where the object never recurs), int32; with
    `with_rank`, (next, rank), rank[t] the count of ids[t] in ids[:t+1]."""
    if _use_kernel(ids, use_kernel):
        return next_use_cuda(ids, num_objects, rank=with_rank)
    nxt = ref.next_use_ref(ids, num_objects)
    return (nxt, ref.frequency_rank_ref(ids)) if with_rank else nxt


def interval_occupancy(deltas: torch.Tensor, *,
                       use_kernel: bool | None = None) -> torch.Tensor:
    """Occupancy profile (inclusive float32 prefix sum), eq. (2)'s LHS."""
    if _use_kernel(deltas, use_kernel):
        return interval_occupancy_cuda(deltas)
    return ref.interval_occupancy_ref(deltas)


def occupancy_feasible(deltas: torch.Tensor, zcap: torch.Tensor, *,
                       use_kernel: bool | None = None):
    """Schedule feasibility: (occupancy profile, max excess over zcap).

    The check of cost-FOO's rounded schedule: deltas are the accepted
    intervals' range-adds, zcap the per-instant caps.
    """
    if _use_kernel(deltas, use_kernel):
        return occupancy_feasible_cuda(deltas, zcap)
    return ref.occupancy_feasible_ref(deltas, zcap)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    next_use_cuda.rank_launches = 0
