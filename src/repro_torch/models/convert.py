"""Carry parameter trees between numpy and PyTorch, bit for bit.

`params_from_numpy` takes the reference's parameters as numpy arrays
(`jax.tree.map(np.asarray, params)`) into the port's tree of tensors;
`params_to_numpy` and `tensor_bytes` go the other way. numpy has no
bfloat16 of its own: an array whose dtype is named `bfloat16` (ml_dtypes'
type, which JAX returns) is read through its 16-bit pattern, so nothing
here imports ml_dtypes, and a bfloat16 tensor comes back as its bit
pattern in uint16.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .common import tree_map

__all__ = ["params_from_numpy", "params_to_numpy", "tensor_bytes",
           "tensor_from_numpy", "tensor_to_numpy"]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array to a tensor on `device`; a bfloat16 array keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor to a host array; bfloat16 comes back as its uint16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The tensor's bytes in row-major order, as numpy's `tobytes` gives
    them for the same array."""
    return np.ascontiguousarray(tensor_to_numpy(t)).tobytes()


def params_from_numpy(tree: Any, device=None) -> Any:
    """A tree (dicts, lists) of numpy arrays to the same tree of tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    return tree_map(tensor_to_numpy, tree)
