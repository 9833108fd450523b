"""Wrappers of the CUDA occupancy scans (`csrc/occupancy_scan.cu`).

The port of `src/repro/kernels/interval_occupancy.py`:
`interval_occupancy_cuda` replaces `interval_occupancy_pallas` and
`occupancy_feasible_cuda` replaces `occupancy_feasible_pallas`. The plain
PyTorch versions are `ref.interval_occupancy_ref` and
`ref.occupancy_feasible_ref`; `ops.interval_occupancy` and
`ops.occupancy_feasible` pick between kernel and plain version.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["interval_occupancy_cuda", "occupancy_feasible_cuda",
           "error_chain"]


def error_chain(T: int) -> int:
    """k of the scan's rounding bound on T items: each occ[p] lies within
    k * 2^-24 * sum_{q<=p} |d_q| of the exact prefix sum of the float32
    deltas (derived in `csrc/occupancy_scan.cu`)."""
    return int(_build.library().occupancy_scan_error_chain(T))


def _check(fn: str, deltas: torch.Tensor, zcap: torch.Tensor | None) -> None:
    named = [("deltas", deltas)] + ([] if zcap is None else [("zcap", zcap)])
    for name, x in named:
        if not x.is_cuda:
            raise ValueError(f"{fn}: {name} is not a CUDA tensor")
        if x.device != deltas.device:
            raise ValueError(f"{fn}: tensors on different devices")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous (T,) tensor")
    if deltas.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"{fn}: deltas dtype {deltas.dtype}, not float32 or "
                         "int32")
    if zcap is not None and (zcap.dtype != torch.float32
                             or zcap.shape != deltas.shape):
        raise ValueError(f"{fn}: zcap must be float32 of the deltas' shape")
    if deltas.numel() == 0:
        raise ValueError(f"{fn}: T = 0 (the plain max of an empty tensor "
                         "raises too)")


# (device index, stream, floats) -> the scan's scratch: zeroed once (one
# fill on the first call of a size on a stream), then left by every call
# as the next one needs it (carries tagged with the call's number, counters
# that only grow). A scratch serves one stream, so two streams never share
# carries. The oldest is dropped past _KEEP sizes; the caching allocator
# reuses its memory in stream order.
_scratch: dict = {}
_KEEP = 16


def _scratch_for(lib, T: int, dev: torch.device, stream: int) -> torch.Tensor:
    n = lib.occupancy_scan_scratch_floats(T)
    key = (dev.index, stream, n)
    buf = _scratch.get(key)
    if buf is None:
        if len(_scratch) >= _KEEP:
            _scratch.pop(next(iter(_scratch)))
        buf = _scratch[key] = torch.zeros(n, dtype=torch.float32, device=dev)
    return buf


def _launch(deltas: torch.Tensor, zcap: torch.Tensor | None):
    lib = _build.library()
    T = deltas.numel()
    dev = deltas.device
    with torch.cuda.device(dev):
        occ = torch.empty(T, dtype=torch.float32, device=dev)
        excess = torch.empty((), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch_for(lib, T, dev, stream)
        is_int = int(deltas.dtype == torch.int32)
        if zcap is None:
            err = lib.interval_occupancy_launch(
                deltas.data_ptr(), is_int, occ.data_ptr(), scratch.data_ptr(),
                T, stream)
        else:
            err = lib.occupancy_feasible_launch(
                deltas.data_ptr(), is_int, zcap.data_ptr(), occ.data_ptr(),
                excess.data_ptr(), scratch.data_ptr(), T, stream)
    if err != 0:
        raise RuntimeError(f"occupancy scan launch failed: CUDA error {err}")
    return occ, excess


def interval_occupancy_cuda(deltas: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum of (T,) deltas, on the card.

    deltas: contiguous (T,) float32 or int32 CUDA tensor, T >= 1. Returns
    (T,) float32 with the semantics of `ref.interval_occupancy_ref`.
    Launches one device kernel on the current stream, does not
    synchronise, and raises if the launch is refused.
    """
    _check("interval_occupancy_cuda", deltas, None)
    occ, _ = _launch(deltas, None)
    interval_occupancy_cuda.launches += 1
    return occ


def occupancy_feasible_cuda(deltas: torch.Tensor, zcap: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Occupancy profile and max(occ - zcap) in one scan, on the card.

    deltas: contiguous (T,) float32 or int32 CUDA tensor, T >= 1; zcap:
    (T,) float32 on the same device. Returns (occ (T,) float32, excess 0-d
    float32) with the semantics of `ref.occupancy_feasible_ref`. Launches
    one device kernel on the current stream, does not synchronise, and
    raises if the launch is refused.
    """
    _check("occupancy_feasible_cuda", deltas, zcap)
    occ, excess = _launch(deltas, zcap)
    occupancy_feasible_cuda.launches += 1
    return occ, excess


interval_occupancy_cuda.launches = 0
occupancy_feasible_cuda.launches = 0
