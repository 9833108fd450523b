"""Carry the reference's inputs into the port.

This system's "weights" are its data: the (Q, 6) policy weight stack, the
trace (ids, sizes) and the (P, N) per-object cost matrix, all numpy on the
reference's side. These helpers turn them into tensors of the types the
replay uses (float32 weights, costs and sizes; int32 ids) on a given
device, with the same float64 -> float32 rounding as the reference's
`jnp.asarray(..., dtype=jnp.float32)`, and back.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["weight_stack", "trace_tensors", "cost_matrix", "to_numpy"]


def weight_stack(stack, device) -> torch.Tensor:
    """(Q, 6) policy weight stack -> float32 tensor; ValueError otherwise."""
    arr = np.asarray(stack, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] != 6:
        raise ValueError("weight stack must have shape (Q, 6)")
    return torch.as_tensor(arr, device=device)


def trace_tensors(ids, sizes, device, num_objects: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T,) ids -> int32 tensor; (N,) sizes -> float32 tensor (ones when
    `sizes` is None, with N = num_objects or max(ids) + 1)."""
    ids = np.asarray(ids, dtype=np.int32)
    if sizes is None:
        n = int(num_objects if num_objects is not None else ids.max() + 1)
        sizes = np.ones(n, np.float32)
    return (torch.as_tensor(ids, device=device),
            torch.as_tensor(np.asarray(sizes, dtype=np.float32), device=device))


def cost_matrix(costs, device) -> torch.Tensor:
    """(P, N) or (N,) per-object costs -> float32 tensor of the same shape."""
    return torch.as_tensor(np.asarray(costs, dtype=np.float32), device=device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
