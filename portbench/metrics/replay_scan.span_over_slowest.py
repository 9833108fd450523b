"""replay_scan.span_over_slowest (x, the kernel's launch columns): in each
pool trace's counted call, the launch's span (the last `end_ns` less the
first `start_ns` over its cells) over its longest cell's own time (`end_ns`
less `start_ns`), mean over the pool traces. It reads 1.0 where no cell
waited for an SM, and 2.0 for two back-to-back waves of equal cells.

The columns come from the job kind's `profile=` calls after the window
(`facts["work"]`, `facts["work_columns"]`); a run without them, or a
program whose kernel writes no `start_ns` and `end_ns`, reads None."""


def read(run):
    works = [w for w in run.facts.get("work") or [] if w is not None]
    cols = list(run.facts.get("work_columns") or [])
    if not works or "start_ns" not in cols or "end_ns" not in cols:
        return None
    out = []
    for w in works:
        # int64 differences first: the timer's ns do not fit a float's bits
        start = w[..., cols.index("start_ns")].ravel()
        end = w[..., cols.index("end_ns")].ravel()
        longest = int((end - start).max()) if start.size else 0
        if longest > 0:
            out.append(int(end.max() - start.min()) / longest)
    return sum(out) / len(out) if out else None
