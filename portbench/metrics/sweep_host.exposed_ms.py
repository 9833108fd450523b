"""sweep_host.exposed_ms (ms, device trace): a job's wall time that no
device work covers (host preparation, the frequency rank, uploads' host
side, the copy back's wait), summed over the window's jobs and divided by
their count. Each job is the harness's span around the call; the device's
busy time inside it is the union of its kernel, copy and set intervals."""
from portbench import devtrace


def read(run):
    tr = run.trace
    jobs = run.job_spans()
    if tr is None or not jobs:
        return None
    merged = devtrace.union((a, b) for _, a, b in tr.device)
    exposed = sum((b - a) - devtrace.busy_within(merged, a, b)
                  for a, b in jobs)
    return 1e3 * exposed / len(jobs)
