"""The traced run's record: `torch.profiler` over the measured window,
reduced to device intervals, host spans and the window, and the
arithmetic the per-layer readers share.

All times here are seconds on the profiler's clock. torch is imported
inside the functions that need it, so the readers and their tests run
without a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

__all__ = ["DeviceTrace", "Job", "RunRecord", "union", "busy_within",
           "kernel_base", "kernel_seconds", "clean_name", "profiled",
           "spans_around", "breakdown", "JOB_SPAN"]

JOB_SPAN = "portbench.job"
SPAN_PREFIX = "portbench."


@dataclasses.dataclass(frozen=True)
class Job:
    """One job of the window: host clock around the call, and its work."""
    start: float
    end: float
    work: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class DeviceTrace:
    window: tuple[float, float]
    device: list        # (name, start, end): kernels, copies and sets
    spans: list         # (name, start, end): the harness's host spans


@dataclasses.dataclass
class RunRecord:
    """What a run hands its metric readers."""
    jobs: list          # [Job], the measured window's, in order
    window_s: float
    setup_s: float
    facts: dict         # the job kind's sizes of the cell (T, N, cells, ...)
    trace: DeviceTrace | None = None

    def job_spans(self) -> list:
        """(start, end) of each job in the trace's clock."""
        if self.trace is None:
            return []
        return [(a, b) for n, a, b in self.trace.spans if n == JOB_SPAN]


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_within(merged, lo: float, hi: float) -> float:
    """Seconds of the disjoint intervals `merged` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def clean_name(name: str) -> str:
    """A device op's name without `void`, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    head = name.split("(")[0].strip()
    return head or name.strip()


def kernel_base(name: str) -> str:
    """A kernel's name without template arguments: `replay_scan_kernel`."""
    return clean_name(name).split("<")[0].split("::")[-1].strip()


def kernel_seconds(run: RunRecord, names) -> float | None:
    """Summed device seconds, inside the traced window, of the kernels
    whose base name is in `names`; None where the trace holds none."""
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window
    found = [max(0.0, min(b, hi) - max(a, lo)) for n, a, b in tr.device
             if kernel_base(n) in names]
    return sum(found) if found and sum(found) > 0 else None


@contextlib.contextmanager
def spans_around(targets):
    """Wrap each (module, attribute) function in a `record_function` span
    named `portbench.<attribute>` while the block runs; a target that does
    not exist is left out. The calls and their results are unchanged."""
    import torch
    saved = []
    for mod_name, attr in targets:
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        fn = getattr(mod, attr, None)
        if not callable(fn):
            continue

        def wrapped(*a, __fn=fn, __name=SPAN_PREFIX + attr, **k):
            with torch.profiler.record_function(__name):
                return __fn(*a, **k)
        setattr(mod, attr, wrapped)
        saved.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _primer() -> None:
    """A trace drops the first kernels after its start now and then; open
    it with a pause and four spin kernels, before the window."""
    import torch
    time.sleep(0.01)
    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (host and device); on exit `out["trace"]` holds
    its `DeviceTrace`, with the window from the first job span's start to
    the last one's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _primer()
        yield
        torch.cuda.synchronize()
    device, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(SPAN_PREFIX):
            # a span is on the host; its copy on the device's timeline
            # (a user annotation) is no device work
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, a, b))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, a, b))
    jobs = [(a, b) for n, a, b in spans if n == JOB_SPAN]
    window = (min(a for a, _ in jobs), max(b for _, b in jobs)) \
        if jobs else (0.0, 0.0)
    out["trace"] = DeviceTrace(window=window, device=device, spans=spans)


def breakdown(tr: DeviceTrace, top: int = 10) -> dict:
    """The device ops that took most time in the window, and its idle gaps
    summed by the innermost host span open at each gap's middle."""
    lo, hi = tr.window
    ops: dict = {}
    for name, a, b in tr.device:
        d = max(0.0, min(b, hi) - max(a, lo))
        if d > 0:
            key = clean_name(name)
            ops[key] = ops.get(key, 0.0) + d
    merged = union((max(a, lo), min(b, hi)) for _, a, b in tr.device)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_spans = [(sa, n) for n, sa, sb in tr.spans if sa <= mid < sb]
        label = max(open_spans)[1] if open_spans else "between jobs"
        if label == JOB_SPAN:
            label += " (outside the named calls)"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
