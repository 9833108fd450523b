"""Wrapper of the CUDA `evict_argmin` kernel (`csrc/evict_argmin.cu`).

The port of `src/repro/kernels/evict_argmin.py:evict_argmin_pallas`. The
plain PyTorch version is `ref.evict_argmin_ref`; `ops.evict_argmin` picks
between the two.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["evict_argmin_cuda"]


def evict_argmin_cuda(scores: torch.Tensor, touch: torch.Tensor,
                      mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic argmin of (score, touch, index) where mask, on the card.

    scores: (N,) or (C, N) float32 or bfloat16; touch: int32, (N,) (shared
    by every row) or the shape of scores; mask: bool, the shape of scores.
    All contiguous CUDA tensors on one device. Returns (index int32, score
    float32), 0-d for a vector and (C,) for a batch, with the semantics of
    `ref.evict_argmin_ref`. Launches on the current stream, does not
    synchronise, and raises if the launch is refused.
    """
    for name, x in (("scores", scores), ("touch", touch), ("mask", mask)):
        if not x.is_cuda:
            raise ValueError(f"evict_argmin_cuda: {name} is not a CUDA tensor")
        if x.device != scores.device:
            raise ValueError("evict_argmin_cuda: tensors on different devices")
        if not x.is_contiguous():
            raise ValueError(f"evict_argmin_cuda: {name} is not contiguous")
    if scores.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"evict_argmin_cuda: scores dtype {scores.dtype}")
    if touch.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError("evict_argmin_cuda: touch must be int32, mask bool")
    if scores.dim() not in (1, 2) or mask.shape != scores.shape:
        raise ValueError("evict_argmin_cuda: scores and mask must be (N,) or "
                         "(C, N) of one shape")
    n = scores.shape[-1]
    rows = scores.shape[0] if scores.dim() == 2 else 1
    if n == 0 or rows == 0 or n >= 2**31 - 1:
        raise ValueError(f"evict_argmin_cuda: unsupported shape {scores.shape}")
    if touch.shape == (n,):
        touch_stride = 0
    elif touch.shape == scores.shape:
        touch_stride = n
    else:
        raise ValueError(f"evict_argmin_cuda: touch shape {tuple(touch.shape)}"
                         f" fits neither ({n},) nor {tuple(scores.shape)}")
    lib = _build.library()
    with torch.cuda.device(scores.device):
        idx = torch.empty(rows, dtype=torch.int32, device=scores.device)
        val = torch.empty(rows, dtype=torch.float32, device=scores.device)
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.evict_argmin_launch(
            scores.data_ptr(), int(scores.dtype == torch.bfloat16),
            touch.data_ptr(), mask.data_ptr(), idx.data_ptr(), val.data_ptr(),
            rows, n, touch_stride, stream)
    if err != 0:
        raise RuntimeError(f"evict_argmin kernel launch failed: CUDA error {err}")
    evict_argmin_cuda.launches += 1
    if scores.dim() == 1:
        return idx[0], val[0]
    return idx, val


evict_argmin_cuda.launches = 0
