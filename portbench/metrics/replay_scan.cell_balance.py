"""replay_scan.cell_balance (%, the kernel's counters): 100 x the mean over
the max of the cells' `cycles` in each pool trace's counted call (how much
of the slowest cell's time the average cell keeps its block busy), mean
over the pool traces.

The counters come from the job kind's `profile=` calls after the window
(`facts["work"]`, `facts["work_columns"]`); a run without them reads None."""


def read(run):
    works = [w for w in run.facts.get("work") or [] if w is not None]
    cols = list(run.facts.get("work_columns") or [])
    if not works or "cycles" not in cols:
        return None
    out = []
    for w in works:
        cycles = w[..., cols.index("cycles")].astype(float).ravel()
        if cycles.size and cycles.max() > 0:
            out.append(100.0 * cycles.mean() / cycles.max())
    return sum(out) / len(out) if out else None
