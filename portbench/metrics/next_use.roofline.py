"""next_use.roofline (%, device trace): the least time the card could work
out next(t) in, over the device time of the `next_use` kernels a job.

The least time: the ids read once and next(t) written once, 4 bytes a
request each, over 3.35e12 B/s. Its kernels are those of
`repro_torch/kernels/csrc/next_use.cu`, by name."""
from portbench import devtrace, peaks

KERNELS = ("stats_kernel", "first_pass", "radix_pass", "write_kernel")


def bound_seconds(facts: dict) -> float:
    return facts["next_use_bytes"] / peaks.HBM_BYTES_S


def read(run):
    s = devtrace.kernel_seconds(run, KERNELS)
    jobs = run.job_spans()
    if s is None or not jobs:
        return None
    return 100.0 * bound_seconds(run.facts) / (s / len(jobs))
