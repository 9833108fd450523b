# Hand-written CUDA kernels for Hopper (sm_90a) behind the replay:
#   replay_scan  — the whole (policy x price x budget) sweep in one launch
#   replay_bytes — the same sweep under byte budgets (replay_scan.cu's
#                  byte replay: evict until the object fits, or fetch it
#                  through)
#   next_use     — next(t), read by Belady and cost-Belady, and the
#                  frequency rank
#   evict_argmin — the eviction decision of every priority policy, batched
#                  over the cells of a sweep (the step loop's, which gives
#                  the per-step trajectory)
# and behind cost-FOO's schedule check, one scan in one source:
#   occupancy_feasible — occupancy profile and max excess over the cap
#   interval_occupancy — the occupancy profile alone
# Each has a CUDA source in csrc/, a ctypes wrapper that counts its launches,
# a plain PyTorch version in ref.py and a dispatcher in ops.py; replay_scan's
# plain version is the step loop of core/policies_torch.py, whose
# sweep_torch dispatches. The CUDA library is built by nvcc at first use
# (_build.py), never at import.
from . import ops, ref
from .ops import (evict_argmin, interval_occupancy, launch_counts, next_use,
                  occupancy_feasible, on_cuda, reset_launch_counts)

__all__ = ["ops", "ref", "evict_argmin", "next_use", "interval_occupancy",
           "occupancy_feasible", "on_cuda", "launch_counts",
           "reset_launch_counts"]
