"""replay_scan.evict_cycles_per_victim (cycles, the kernel's counters): in
each pool trace's counted call, the slowest cell's (most `cycles`)
`evict_cycles` over its victims, mean over the pool traces that have one.
Victims are the `victims` column where the replay writes one (byte
budgets), else `scored_steps` (page budgets, one victim a scored step).

The counters come from the job kind's `profile=` calls after the window
(`facts["work"]`, `facts["work_columns"]`); a run without them reads None."""


def _columns(run):
    works = [w for w in run.facts.get("work") or [] if w is not None]
    cols = run.facts.get("work_columns")
    return (works, list(cols)) if works and cols else ([], [])


def read(run):
    works, cols = _columns(run)
    if not works or "cycles" not in cols or "evict_cycles" not in cols:
        return None
    victims = cols.index("victims" if "victims" in cols else "scored_steps")
    out = []
    for w in works:
        cells = w.reshape(-1, w.shape[-1])
        slow = cells[cells[:, cols.index("cycles")].argmax()]
        if slow[victims] > 0:
            out.append(float(slow[cols.index("evict_cycles")])
                       / float(slow[victims]))
    return sum(out) / len(out) if out else None
