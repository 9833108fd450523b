# Observability for the egress stack (DESIGN.md §9) — explains every dollar:
#   trace   — span tracer (request -> cache lookup -> store GET) with exact
#             per-span dollar attribution; JSON + Chrome trace-event export
#   events  — ring-buffered cache decision log (hit/miss/admit/reject/evict/
#             policy_swap) with per-event dollar deltas
#   metrics — promoted MetricsRegistry: counters/gauges/series + log-bucketed
#             histograms (sizes centered on s*, per-GET dollars, regret);
#             JSON + Prometheus text exposition
#   schema  — dependency-free JSON-Schema subset validator for the artifacts
# Layering rule: repro.egress never imports repro.obs — every publisher is
# duck-typed (tracer, events, metrics), exactly like the online metrics registry.
from .trace import NullTracer, Span, Tracer, regime_tag
from .events import EVENT_KINDS, DecisionEvent, EventLog
from .metrics import Histogram, MetricsRegistry, log_bounds, sstar_bounds
from .schema import validate

__all__ = [
    "Tracer", "NullTracer", "Span", "regime_tag",
    "EventLog", "DecisionEvent", "EVENT_KINDS",
    "MetricsRegistry", "Histogram", "log_bounds", "sstar_bounds",
    "validate",
]
