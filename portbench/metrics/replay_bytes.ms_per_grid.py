"""replay_bytes.ms_per_grid (ms, device trace): the device time of the
byte replay's kernel (`replay_bytes_kernel`) in the window over the jobs."""
from portbench import devtrace

KERNELS = ("replay_bytes_kernel",)


def read(run):
    s = devtrace.kernel_seconds(run, KERNELS)
    jobs = run.job_spans()
    return None if s is None or not jobs else 1e3 * s / len(jobs)
