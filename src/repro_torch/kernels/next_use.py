"""Wrapper of the CUDA `next_use` kernel (`csrc/next_use.cu`).

The port of `src/repro/kernels/next_use.py:next_use_pallas`. The plain
PyTorch version is `ref.next_use_ref`; `ops.next_use` picks between the two.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["next_use_cuda", "shared_table_entries"]


def shared_table_entries() -> int:
    """Largest object count whose last-seen table the kernel keeps in
    shared memory on the current device; above it the table is global."""
    return int(_build.library().next_use_max_shared_entries())


def next_use_cuda(ids: torch.Tensor, num_objects: int) -> torch.Tensor:
    """next(t) per request (T where the object never recurs), on the card.

    ids: (T,) contiguous int32 CUDA tensor with values in [0, num_objects).
    Returns (T,) int32. Checks the id range on the host first (one
    synchronisation), then launches on the current stream and raises if
    the launch is refused.
    """
    if not ids.is_cuda:
        raise ValueError("next_use_cuda: ids is not a CUDA tensor")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("next_use_cuda: ids must be a contiguous (T,) int32 "
                         "tensor")
    T = ids.shape[0]
    if num_objects < 1 or T >= 2**31 - 1:
        raise ValueError(f"next_use_cuda: unsupported T={T}, "
                         f"num_objects={num_objects}")
    out = torch.empty(T, dtype=torch.int32, device=ids.device)
    if T == 0:
        return out
    lo, hi = torch.aminmax(ids)
    if int(lo) < 0 or int(hi) >= num_objects:
        raise ValueError(f"next_use_cuda: ids outside [0, {num_objects})")
    lib = _build.library()
    with torch.cuda.device(ids.device):
        in_shared = num_objects <= lib.next_use_max_shared_entries()
        table = torch.empty(0 if in_shared else num_objects,
                            dtype=torch.int32, device=ids.device)
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.next_use_launch(ids.data_ptr(), out.data_ptr(),
                                  table.data_ptr(), T, num_objects,
                                  int(in_shared), stream)
    if err != 0:
        raise RuntimeError(f"next_use kernel launch failed: CUDA error {err}")
    next_use_cuda.launches += 1
    return out


next_use_cuda.launches = 0
