"""replay_scan.roofline (%, device trace): the least time the card could
replay a grid in, over the `replay_scan` kernel's device time a job.

The least time is the larger of
  bytes: each input byte read once and each output byte written once
         (ids, next(t) and the frequency rank: 4 bytes a request each;
         float32 costs (P, N) and sizes (N,); the weights and budgets;
         dollars and hits, 4 bytes a cell each), over 3.35e12 B/s;
  operations: OPS_PER_CELL_REQUEST for each (cell, request), over the
         float32 peak of 6.7e13 FLOP/s.
Both are functions of the cell's inputs alone: no term grows with the
cache's size and none reads the kernel's own work counters, so the share
reads the same work whatever implements the replay."""
from portbench import devtrace, peaks

KERNELS = ("replay_scan_kernel",)
# what any exact replay does for every cell at every request: test whether
# the object is cached, add its cost to the bill on a miss, count the hit,
# and set the object's score at its touch
OPS_PER_CELL_REQUEST = 4


def bound_seconds(facts: dict) -> float:
    ops = OPS_PER_CELL_REQUEST * facts["cells"] * facts["T"]
    return max(facts["replay_bytes"] / peaks.HBM_BYTES_S,
               ops / peaks.F32_FLOPS)


def read(run):
    s = devtrace.kernel_seconds(run, KERNELS)
    jobs = run.job_spans()
    if s is None or not jobs:
        return None
    return 100.0 * bound_seconds(run.facts) / (s / len(jobs))
