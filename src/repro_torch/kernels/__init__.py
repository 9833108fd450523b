# Hand-written CUDA kernels for Hopper (sm_90a) behind the replay:
#   evict_argmin — the eviction decision of every priority policy, batched
#                  over the cells of a sweep
#   next_use     — next(t), read by Belady and cost-Belady
# Each has a CUDA source in csrc/, a ctypes wrapper that counts its launches,
# a plain PyTorch version in ref.py, and a dispatcher in ops.py. The CUDA
# library is built by nvcc at first use (_build.py), never at import.
from . import ops, ref
from .ops import (evict_argmin, launch_counts, next_use, on_cuda,
                  reset_launch_counts)

__all__ = ["ops", "ref", "evict_argmin", "next_use", "on_cuda",
           "launch_counts", "reset_launch_counts"]
