"""replay_bytes.roofline (%, device trace): the least time the card could
replay a byte-budget grid in, over the `replay_bytes` kernel's device time
a job.

The least time is the larger of
  bytes: each input byte read once and each output byte written once
         (ids, next(t) and the frequency rank: 4 bytes a request each;
         float32 costs (P, N) and int32 sizes (N,); the float32 weights
         (Q, 6) and int64 budgets (K,); dollars and hits, 4 bytes a cell
         each), over 3.35e12 B/s;
  operations: OPS_PER_CELL_REQUEST for each (cell, request), over the
         float32 peak of 6.7e13 FLOP/s.
As `replay_scan.roofline`, both are functions of the cell's inputs alone:
no term grows with the cache or reads the kernel's counters."""
from portbench import devtrace, peaks

KERNELS = ("replay_bytes_kernel",)
# what any exact replay does for every cell at every request: test whether
# the object is cached, add its cost to the bill on a miss, count the hit,
# and set the object's score at its touch
OPS_PER_CELL_REQUEST = 4


def bound_seconds(facts: dict) -> float:
    T, N, P, Q, K = (facts[k] for k in ("T", "N", "P", "Q", "K"))
    cells = facts["cells"]
    moved = 3 * 4 * T + 4 * P * N + 4 * N + 24 * Q + 8 * K + 8 * cells
    ops = OPS_PER_CELL_REQUEST * cells * T
    return max(moved / peaks.HBM_BYTES_S, ops / peaks.F32_FLOPS)


def read(run):
    s = devtrace.kernel_seconds(run, KERNELS)
    jobs = run.job_spans()
    if s is None or not jobs:
        return None
    return 100.0 * bound_seconds(run.facts) / (s / len(jobs))
