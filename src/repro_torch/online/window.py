"""Windowed exact audit: a live dollar-regret estimate over recent traffic.

Keeps a ring buffer of the last `window` accesses (key, bytes, access-time
miss cost, hit/miss) fed by the live cache's `AccessEvent` stream, and on
demand brackets OPT-dollars on that window with the paper's offline
reference: `exact_opt_uniform_sweep` when the window's sizes are uniform
(one warm-started parametric SSP run answers the whole budget grid,
DESIGN.md §5.2), the cost-FOO LP bracket otherwise. Observed dollars are
the sum of the window's miss costs — exactly what the live cache billed
for those accesses, at the prices in effect when they happened.

The resulting regret series is the governor's "are we leaving dollars on
the table RIGHT NOW" signal, published to the metrics registry.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import Trace, cost_foo, exact_opt_uniform_sweep
from repro_torch.egress.cache import AccessEvent

__all__ = ["Watermark", "WindowAudit", "WindowedAuditor"]


class Watermark:
    """Event-time watermark with a bounded-skew guarantee.

    Tracks the maximum event time seen; the watermark trails it by
    `max_skew`, so any event at or after the watermark may still arrive.
    `advance(t)` ingests one event time, asserts its lateness stays within
    the bound (a violation means the clock-skew model is broken, not that
    an event is merely late), and returns the new watermark. Shared by the
    fleet nodes' tumbling windows (`repro.fleet.node`) and by
    `WindowedAuditor`'s out-of-order tolerance below.
    """

    __slots__ = ("max_skew", "max_time", "events", "late")

    def __init__(self, max_skew: float = 0.0):
        assert max_skew >= 0.0, max_skew
        self.max_skew = float(max_skew)
        self.max_time = float("-inf")
        self.events = 0
        self.late = 0          # events that arrived behind max_time

    @property
    def value(self) -> float:
        """Current watermark: no event older than this will be accepted."""
        return self.max_time - self.max_skew

    def advance(self, event_time: float) -> float:
        t = float(event_time)
        self.events += 1
        if t >= self.max_time:
            self.max_time = t
        else:
            self.late += 1
            if self.max_time - t > self.max_skew:
                raise ValueError(
                    f"event time {t} is {self.max_time - t:.6g} behind the "
                    f"stream maximum {self.max_time}; bounded skew is "
                    f"{self.max_skew:.6g}")
        return self.value


@dataclasses.dataclass
class WindowAudit:
    requests: int
    observed_dollars: float      # what the live cache billed on this window
    opt_dollars_lower: float     # exact (uniform) or cost-FOO lower bound
    opt_dollars_upper: float
    dollar_regret: float         # vs the lower bound (conservative)
    uniform: bool
    opt_by_budget: Optional[dict[int, float]] = None  # uniform + grid only
    audit_seconds: float = 0.0   # wall time of the exact solve itself

    def summary(self) -> str:
        return (f"[window audit] T={self.requests} "
                f"$={self.observed_dollars:.6f} "
                f"OPT in [{self.opt_dollars_lower:.6f}, "
                f"{self.opt_dollars_upper:.6f}] "
                f"regret={self.dollar_regret:.3f}")


class WindowedAuditor:
    """Ring buffer + on-demand exact bracket of OPT-dollars on the window.

    Events are buffered in *event-time* order, not arrival order: a late
    event (skewed delivery from a fleet peer, an out-of-order replay) is
    insorted into its true position so the audit replays the trace the
    accesses actually formed. Lateness is bounded by the shared `Watermark`
    helper (`max_skew`, default: the window length in event-time units) —
    an event older than that is a broken clock model and raises.
    """

    def __init__(self, capacity_bytes: float, window: int = 2048,
                 budget_grid=None, metrics=None,
                 series_name: str = "online.window_regret",
                 max_skew: Optional[float] = None,
                 foo_epoch_len: Optional[int] = None,
                 foo_policies: Optional[tuple[str, ...]] = None):
        self.capacity = float(capacity_bytes)
        self.window = int(window)
        self.budget_grid = (None if budget_grid is None
                            else np.asarray(budget_grid, np.int64))
        self.metrics = metrics
        self.series_name = series_name
        # variable-size audit path (DESIGN.md §4): epoch decomposition +
        # segment-tree rounding keep the cost-FOO bracket inside a window
        # interval even at large `window`; `foo_epoch_len=None` lets
        # cost_foo pick (monolithic up to 25k requests)
        self.foo_epoch_len = foo_epoch_len
        self.foo_policies = foo_policies
        self.watermark = Watermark(float(self.window)
                                   if max_skew is None else max_skew)
        # sorted by (event_time, arrival seq): (t, seq, key, nbytes, mc, hit)
        self._buf: list[tuple] = []
        self._seen = 0
        self.audits = 0

    def on_event(self, ev: AccessEvent) -> None:
        self.watermark.advance(ev.event_time)   # asserts bounded skew
        self._seen += 1
        entry = (ev.event_time, self._seen, ev.key, ev.nbytes,
                 ev.miss_cost, ev.hit)
        if not self._buf or entry >= self._buf[-1]:
            self._buf.append(entry)             # in-order fast path
        else:
            bisect.insort(self._buf, entry)     # late: fold into position
        if len(self._buf) > self.window:
            del self._buf[0]

    def __len__(self) -> int:
        return len(self._buf)

    def audit(self) -> Optional[WindowAudit]:
        """Bracket OPT-dollars on the buffered window; None if empty."""
        if not self._buf:
            return None
        buf = list(self._buf)
        uniq: dict[str, int] = {}
        ids = np.empty(len(buf), np.int32)
        sizes: list[float] = []
        costs: list[float] = []
        observed = 0.0
        for t, (_et, _seq, key, nbytes, mc, hit) in enumerate(buf):
            i = uniq.get(key)
            if i is None:
                i = uniq[key] = len(sizes)
                sizes.append(float(nbytes))
                costs.append(float(mc))
            else:
                costs[i] = float(mc)   # latest access-time price wins
            ids[t] = i
            if not hit:
                observed += mc
        sizes_arr = np.asarray(sizes)
        costs_arr = np.asarray(costs)
        uniform = len(set(sizes_arr.tolist())) == 1
        opt_by_budget = None
        t_solve = time.perf_counter()
        if uniform:
            B = max(1, int(self.capacity // sizes_arr[0]))
            grid = (np.unique(np.append(self.budget_grid, B))
                    if self.budget_grid is not None
                    else np.asarray([B], np.int64))
            sweep = exact_opt_uniform_sweep(ids, costs_arr, grid)
            opt_by_budget = {int(b): float(d)
                             for b, d in zip(sweep.budgets, sweep.dollars)}
            lower = upper = opt_by_budget[int(B)]
            if self.metrics is not None and sweep.profile:
                # solver profiling (DESIGN.md §9): where audit time goes
                self.metrics.inc("solver.sweep.runs")
                self.metrics.inc("solver.sweep.dijkstra_calls",
                                 sweep.profile["dijkstra_calls"])
                self.metrics.inc("solver.sweep.augmentations",
                                 sweep.profile["augmentations"])
                self.metrics.inc("solver.sweep.budgets_answered",
                                 sweep.profile["budgets_answered"])
        else:
            tr = Trace(ids=ids, sizes=sizes_arr, name="window_audit")
            kwargs = {}
            if self.foo_policies is not None:
                kwargs["policies"] = self.foo_policies
            r = cost_foo(tr, costs_arr, self.capacity,
                         epoch_len=self.foo_epoch_len, **kwargs)
            lower, upper = r.lower, r.upper
            if self.metrics is not None and r.profile:
                # solver profiling (DESIGN.md §9): how the bracket was made
                self.metrics.inc("solver.costfoo.runs")
                self.metrics.inc("solver.costfoo.epochs",
                                 r.profile.get("epochs", 1))
                self.metrics.inc("solver.costfoo.crossing_intervals",
                                 r.profile.get("crossing_intervals", 0))
        audit_seconds = time.perf_counter() - t_solve
        # observed >= lower mathematically; clip float jitter at exactly-OPT
        reg = max(0.0, (observed - lower) / max(lower, 1e-12))
        self.audits += 1
        if self.metrics is not None:
            self.metrics.observe(self.series_name, reg, step=self._seen)
            self.metrics.observe("online.audit_seconds", audit_seconds,
                                 step=self._seen)
            oh = getattr(self.metrics, "observe_hist", None)
            if oh is not None:   # windowed-regret histogram (DESIGN.md §9)
                oh(self.series_name + "_hist", reg,
                   bounds=[0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0])
        return WindowAudit(requests=len(buf), observed_dollars=observed,
                           opt_dollars_lower=lower, opt_dollars_upper=upper,
                           dollar_regret=reg, uniform=uniform,
                           opt_by_budget=opt_by_budget,
                           audit_seconds=audit_seconds)
