"""Metrics registry for the observability layer (DESIGN.md §9).

Promoted here from `repro.online.metrics` (which re-exports it for
back-compat): a single process-local registry of counters, gauges, time
series and — new in the obs layer — log-bucketed histograms, that
`ObjectStore`, `EgressCache`, `ServeEngine`, and the dollar-governor all
publish through. Publishers hold it duck-typed (anything with `.inc` /
`.set_gauge` / `.observe` / `.observe_hist`), so the egress layer never
imports this module — `repro.obs` sits strictly above `repro.egress`.

Histograms are Prometheus-shaped (le-bucketed cumulative on export, with
`_sum` and `_count`); the stock bucket layouts are geometric:
`log_bounds` for per-GET dollars (they span ~1e-9..1e-2 $), and
`sstar_bounds` for object sizes — octaves centered on the paper's
crossover s* = f/e, so the fee-dominated/egress-dominated split is
readable straight off the bucket counts.

Export is JSON (`to_json` / `write_json`) and Prometheus text exposition
(`to_prometheus` / `write_prometheus`).
"""
from __future__ import annotations

import bisect
import json
import pathlib
import re
import threading
from typing import Optional, Sequence

__all__ = ["MetricsRegistry", "Histogram", "log_bounds", "sstar_bounds"]


def log_bounds(lo: float, hi: float, per_decade: int = 3) -> list[float]:
    """Geometric bucket upper bounds covering [lo, hi]."""
    assert lo > 0 and hi > lo and per_decade >= 1
    out = [lo]
    ratio = 10.0 ** (1.0 / per_decade)
    while out[-1] < hi:
        out.append(out[-1] * ratio)
    return out


def sstar_bounds(crossover_bytes: float, octaves: int = 8) -> list[float]:
    """Size buckets centered on s* = f/e: s* * 2^k for k in [-octaves,
    octaves]. s* itself is a bucket boundary, so the counts at or below
    the s* bound are exactly the fee-dominated accesses."""
    return [crossover_bytes * 2.0 ** k for k in range(-octaves, octaves + 1)]


# default when a publisher doesn't pick bounds: wide geometric coverage
_DEFAULT_BOUNDS = log_bounds(1e-9, 1e3, per_decade=1)


class Histogram:
    """le-bucketed histogram: counts[i] = observations <= bounds[i],
    stored non-cumulative; the +Inf overflow is counts[-1]."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        b = [float(x) for x in bounds]
        assert b == sorted(b) and len(b) >= 1, "bounds must be ascending"
        self.bounds = b
        self.counts = [0] * (len(b) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def snapshot(self) -> dict:
        return dict(bounds=list(self.bounds), counts=list(self.counts),
                    sum=self.sum, count=self.count)


def _prom_name(name: str) -> str:
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return n if re.match(r"[a-zA-Z_:]", n) else "_" + n


def _prom_num(v: float) -> str:
    return repr(float(v))


class MetricsRegistry:
    """Counters (monotone), gauges (last value), series ((step, value)
    lists), histograms (le-bucketed)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.series: dict[str, list[tuple[int, float]]] = {}
        self.histograms: dict[str, Histogram] = {}
        self._step = 0

    # ---- publishing -------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float,
                step: Optional[int] = None) -> None:
        """Append to a time series; `step` defaults to an internal tick."""
        with self._lock:
            if step is None:
                self._step += 1
                step = self._step
            self.series.setdefault(name, []).append((int(step), float(value)))

    def observe_hist(self, name: str, value: float,
                     bounds: Optional[Sequence[float]] = None) -> None:
        """Record into a histogram, creating it on first use with `bounds`
        (or the wide geometric default). Bounds are fixed at creation —
        later `bounds` arguments are ignored (buckets can't be re-binned)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(
                    bounds if bounds is not None else _DEFAULT_BOUNDS)
            h.observe(value)

    # ---- reading / export -------------------------------------------------
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def latest(self, name: str) -> Optional[float]:
        s = self.series.get(name)
        return s[-1][1] if s else None

    def hist(self, name: str) -> Optional[Histogram]:
        return self.histograms.get(name)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                counters=dict(self.counters),
                gauges=dict(self.gauges),
                series={k: [list(p) for p in v]
                        for k, v in self.series.items()},
                histograms={k: h.snapshot()
                            for k, h in self.histograms.items()},
            )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def write_json(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (text/plain; version 0.0.4).

        Counters and gauges expose as-is; a time series exposes its latest
        value as a gauge; histograms expose cumulative `_bucket{le=...}`
        lines plus `_sum` / `_count`."""
        with self._lock:
            lines: list[str] = []
            for name in sorted(self.counters):
                n = _prom_name(name)
                lines.append(f"# TYPE {n} counter")
                lines.append(f"{n} {_prom_num(self.counters[name])}")
            for name in sorted(self.gauges):
                n = _prom_name(name)
                lines.append(f"# TYPE {n} gauge")
                lines.append(f"{n} {_prom_num(self.gauges[name])}")
            for name in sorted(self.series):
                if not self.series[name]:
                    continue
                n = _prom_name(name) + "_last"
                lines.append(f"# TYPE {n} gauge")
                lines.append(f"{n} {_prom_num(self.series[name][-1][1])}")
            for name in sorted(self.histograms):
                h = self.histograms[name]
                n = _prom_name(name)
                lines.append(f"# TYPE {n} histogram")
                cum = h.cumulative()
                for b, c in zip(h.bounds, cum):
                    lines.append(f'{n}_bucket{{le="{b:g}"}} {c}')
                lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
                lines.append(f"{n}_sum {_prom_num(h.sum)}")
                lines.append(f"{n}_count {h.count}")
            return "\n".join(lines) + "\n"

    def write_prometheus(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_prometheus())
        return path
