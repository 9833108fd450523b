"""device.idle_share (%, device trace): 1 - the union of the device's busy
intervals (kernels, copies, sets) over the traced window, as a share."""
from portbench import devtrace


def read(run):
    tr = run.trace
    if tr is None or tr.window[1] <= tr.window[0]:
        return None
    lo, hi = tr.window
    merged = devtrace.union((max(a, lo), min(b, hi)) for _, a, b in tr.device)
    return 100.0 * (1.0 - devtrace.busy_within(merged, lo, hi) / (hi - lo))
