"""Billing-faithful span tracer: every dollar, attributed to a span.

A `Tracer` records a tree of timed spans — request -> cache lookup ->
store GET — where the spans that bill (store GETs) carry their exact
dollar attribution (`dollars = f + bytes * e`, the same float the
`BillingMeter` accrues) plus a size-vs-s* regime tag, so summing span
dollars for a consumer reproduces that consumer's meter total to float
tolerance (asserted in tests/test_obs.py).

Publishers hold the tracer duck-typed (`repro.egress` never imports this
module) and guard the hot path with plain truthiness: `NullTracer` (and a
disabled `Tracer`) are falsy, so `if tracer:` costs one branch and the
disabled overhead is ~0 (measured in bench_policy_throughput).

Exports: JSON (list of span dicts), Chrome trace-event format — complete
events (`"ph": "X"`) loadable in Perfetto / chrome://tracing — and
OTLP-shaped JSON (`resourceSpans`/`scopeSpans`, `to_otlp`) for collectors
that speak OpenTelemetry.

Span recording is bounded: the tracer keeps at most `max_spans` finished
spans (a ring; `dropped` counts the overflow), so tracing a long-running
server never grows without bound. For full-fidelity capture past the ring,
pass `stream=` a writable file object: every finished span is written
through as one NDJSON line at close time, so the stream holds spans the
ring has already evicted.
"""
from __future__ import annotations

import collections
import json
import math
import os
import pathlib
import threading
import time
from typing import Optional

__all__ = ["Span", "Tracer", "NullTracer", "regime_tag"]


def regime_tag(nbytes: float, crossover_bytes: float) -> str:
    """Which side of the paper's s* = f/e crossover a size falls on."""
    return "fee_dominated" if nbytes <= crossover_bytes else "egress_dominated"


class Span:
    """One timed operation. Mutable while open; frozen by convention after
    close. `attrs` carries the dollar attribution (`dollars`, `bytes`,
    `regime`, `consumer`, ...)."""

    __slots__ = ("name", "cat", "span_id", "parent_id", "t0", "dur", "tid",
                 "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 span_id: int, parent_id: Optional[int], t0: float):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0          # seconds since tracer epoch
        self.dur = 0.0        # seconds
        self.tid = 0
        self.attrs: Optional[dict] = None
        self._tracer = tracer

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    # context-manager protocol (entry is implicit: Tracer.span() opens)
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._close(self)

    def to_dict(self) -> dict:
        return dict(name=self.name, cat=self.cat, span_id=self.span_id,
                    parent_id=self.parent_id, ts_us=self.t0 * 1e6,
                    dur_us=self.dur * 1e6, tid=self.tid,
                    args=dict(self.attrs) if self.attrs else {})


class Tracer:
    """Span recorder with a per-thread open-span stack (nesting)."""

    def __init__(self, max_spans: int = 100_000, enabled: bool = True,
                 stream=None):
        self.enabled = enabled
        self.max_spans = int(max_spans)
        # perf_counter drives durations; the wall-clock epoch captured
        # alongside it anchors OTLP's unix-nano timestamps
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=self.max_spans)
        self._recorded = 0
        self._next_id = 1
        self._local = threading.local()
        self.stream = stream          # NDJSON write-through of closed spans
        self._stream_lock = threading.Lock()

    def __bool__(self) -> bool:
        return self.enabled

    # ---- recording --------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, cat: str = "span", **attrs) -> Span:
        """Open a span; close it via `with` (or `sp.__exit__(...)`)."""
        sp = self.begin(name, cat)
        if attrs:
            sp.attrs = attrs
        return sp

    def begin(self, name: str, cat: str = "span") -> Span:
        """Positional fast path of `span()` for per-access hot loops: no
        attr kwargs (assign `sp.attrs` directly), pair with `end()` in a
        try/finally instead of `with`."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        sid = self._next_id
        self._next_id = sid + 1
        sp = Span(self, name, cat, sid,
                  st[-1].span_id if st else None,
                  time.perf_counter() - self._epoch)
        st.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        sp.dur = (time.perf_counter() - self._epoch) - sp.t0
        sp.tid = threading.get_ident()
        st = getattr(self._local, "stack", None) or ()
        if st and st[-1] is sp:
            st.pop()
        else:                      # out-of-order close: drop up to this span
            while st:
                if st.pop() is sp:
                    break
        self._spans.append(sp)
        self._recorded += 1
        if self.stream is not None:
            line = json.dumps(sp.to_dict(), sort_keys=True)
            with self._stream_lock:
                self.stream.write(line + "\n")

    end = _close   # public pair of `begin()`

    # ---- querying ---------------------------------------------------------
    def spans(self, cat: Optional[str] = None, name: Optional[str] = None,
              **attr_filters) -> list[Span]:
        """Finished spans, optionally filtered by cat/name/attr equality."""
        out = []
        for sp in self._spans:
            if cat is not None and sp.cat != cat:
                continue
            if name is not None and sp.name != name:
                continue
            if attr_filters:
                a = sp.attrs or {}
                if any(a.get(k) != v for k, v in attr_filters.items()):
                    continue
            out.append(sp)
        return out

    def dollars(self, **filters) -> float:
        """Exact (fsum) total of `dollars` attrs over matching spans."""
        return math.fsum(sp.attrs.get("dollars", 0.0)
                         for sp in self.spans(**filters) if sp.attrs)

    @property
    def dropped(self) -> int:
        """Finished spans evicted from the ring by `max_spans`."""
        return self._recorded - len(self._spans)

    # ---- export -----------------------------------------------------------
    def to_dicts(self) -> list[dict]:
        return [sp.to_dict() for sp in self._spans]

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dicts(), indent=indent)

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event format: complete events, ts/dur in us —
        loadable in Perfetto or chrome://tracing."""
        pid = os.getpid()
        events = []
        for sp in self._spans:
            events.append(dict(
                name=sp.name, cat=sp.cat, ph="X",
                ts=sp.t0 * 1e6, dur=sp.dur * 1e6,
                pid=pid, tid=sp.tid,
                args=dict(sp.attrs or {}, span_id=sp.span_id,
                          parent_id=sp.parent_id)))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_otlp(self, service_name: str = "repro") -> dict:
        """OTLP/JSON-shaped export (`resourceSpans`/`scopeSpans`), the
        schema OpenTelemetry collectors ingest: ids are zero-padded hex
        (spanId 16, traceId 32), times are unix-nano strings anchored at
        the wall-clock epoch captured next to the perf_counter epoch, and
        attrs map to typed `AnyValue`s. One tracer = one trace."""
        trace_id = f"{os.getpid() & 0xFFFFFFFFFFFFFFFF:016x}" \
                   f"{int(self._epoch_unix * 1e6) & 0xFFFFFFFFFFFFFFFF:016x}"
        spans = []
        for sp in self._spans:
            start = int((self._epoch_unix + sp.t0) * 1e9)
            attrs = [_otlp_attr("span.cat", sp.cat)]
            for k, v in (sp.attrs or {}).items():
                attrs.append(_otlp_attr(k, v))
            spans.append(dict(
                traceId=trace_id,
                spanId=f"{sp.span_id & 0xFFFFFFFFFFFFFFFF:016x}",
                parentSpanId=(f"{sp.parent_id & 0xFFFFFFFFFFFFFFFF:016x}"
                              if sp.parent_id is not None else ""),
                name=sp.name, kind=1,           # SPAN_KIND_INTERNAL
                startTimeUnixNano=str(start),
                endTimeUnixNano=str(start + int(sp.dur * 1e9)),
                attributes=attrs))
        return {"resourceSpans": [{
            "resource": {"attributes": [
                _otlp_attr("service.name", service_name)]},
            "scopeSpans": [{"scope": {"name": "repro.obs"},
                            "spans": spans}],
        }]}

    def write_json(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path

    def write_otlp(self, path, service_name: str = "repro") -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_otlp(service_name)) + "\n")
        return path

    def write_chrome_trace(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome_trace()) + "\n")
        return path


def _otlp_attr(key: str, v) -> dict:
    """One OTLP KeyValue; bool checked before int (bool is an int)."""
    if isinstance(v, bool):
        value = {"boolValue": v}
    elif isinstance(v, int):
        value = {"intValue": str(v)}       # OTLP/JSON carries i64 as string
    elif isinstance(v, float):
        value = {"doubleValue": v}
    else:
        value = {"stringValue": str(v)}
    return {"key": key, "value": value}


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """API-compatible no-op; falsy so publishers skip it with one branch."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, cat: str = "span", **attrs) -> _NullSpan:
        return _NULL_SPAN

    def begin(self, name: str, cat: str = "span") -> _NullSpan:
        return _NULL_SPAN

    def end(self, sp) -> None:
        return None

    def spans(self, **filters) -> list:
        return []

    def dollars(self, **filters) -> float:
        return 0.0

    def to_dicts(self) -> list:
        return []

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def to_otlp(self, service_name: str = "repro") -> dict:
        return {"resourceSpans": []}
