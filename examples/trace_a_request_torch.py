"""Trace a request on the PyTorch port: every dollar of a governed serving
run, explained, as `examples/trace_a_request.py` runs it on the JAX package.

Runs the port's governed ServeEngine (egress-billed prefix cache + dollar
governor) with the full obs stack attached — span tracer, decision event
log, metrics registry with s*-centered histograms — then:

  * prints the span tree of one request (serve.request -> cache.get ->
    store.get) with per-span dollar attribution and regime tags,
  * proves billing faithfulness: the fsum of `store.get` span dollars for
    the prefix-cache consumer equals that consumer's BillingMeter total,
    and the event log's lifetime `miss` dollars equal it bit-for-bit,
  * writes the exportable artifacts: `obs.json` (the full governance +
    obs snapshot), `trace.chrome.json` (Chrome trace-event format — load
    it in Perfetto / chrome://tracing), and `metrics.prom` (Prometheus
    text exposition).

    PYTHONPATH=src python examples/trace_a_request_torch.py --out obs_out
    PYTHONPATH=src python examples/trace_a_request_torch.py --device cpu

tests/test_torch_examples.py runs it on the CPU and validates `obs.json`
against tests/schemas/obs.json.
"""
import argparse
import json
import pathlib

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.models import get_model
from repro_torch.obs import EventLog, MetricsRegistry, Tracer
from repro_torch.serve.engine import Request, ServeEngine


def span_tree(tracer: Tracer, root) -> list[str]:
    """Render a finished span subtree, dollars annotated."""
    by_parent: dict = {}
    for sp in tracer.spans():
        by_parent.setdefault(sp.parent_id, []).append(sp)
    lines = []

    def walk(sp, depth):
        a = sp.attrs or {}
        extra = ""
        if "dollars" in a:
            extra = f"  ${a['dollars']:.9f} ({a.get('regime', '?')})"
        elif "hit" in a:
            extra = f"  hit={a['hit']}"
        lines.append(f"{'  ' * depth}{sp.name} [{sp.dur * 1e6:.0f}us]"
                     f"{extra}")
        for ch in by_parent.get(sp.span_id, []):
            walk(ch, depth + 1)

    walk(root, 0)
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for obs.json / trace.chrome.json / "
                         "metrics.prom (default: no files written)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    tracer = Tracer(max_spans=100_000)
    events = EventLog(100_000)
    metrics = MetricsRegistry()

    cfg = get_config("gemma3-4b", smoke=True)
    model = get_model(cfg)
    params = model.init(0, device=device)
    engine = ServeEngine(model, params, prefix_cache_bytes=1 << 22,
                         policy="gdsf", govern=True, governor_window=8,
                         metrics=metrics, tracer=tracer, events=events,
                         device=device)

    rng = np.random.default_rng(0)
    hot = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
           for _ in range(3)]
    rid = 0
    for round_ in range(5):
        reqs = [Request(rid + i, h, max_new_tokens=4)
                for i, h in enumerate(hot)]
        rid += len(reqs)
        engine.serve(reqs)

    # ---- one request, explained -------------------------------------------
    req_spans = tracer.spans(name="serve.request")
    print(f"--- span tree of request rid={req_spans[-1].attrs['rid']} ---")
    print("\n".join(span_tree(tracer, req_spans[-1])))

    # ---- billing faithfulness ---------------------------------------------
    meter = engine.cache.meter
    span_dollars = tracer.dollars(name="store.get",
                                  consumer=engine.cache.consumer)
    event_dollars = events.dollars_billed("miss")
    print("\n--- billing faithfulness ---")
    print(f"prefix-cache meter      $ {meter.dollars:.12f}")
    print(f"sum of store.get spans  $ {span_dollars:.12f}")
    print(f"event log miss dollars  $ {event_dollars:.12f}")
    assert abs(span_dollars - meter.dollars) <= 1e-12 * max(1.0, meter.dollars)
    assert event_dollars == meter.dollars   # same-order accrual: bit-equal
    c = events.counts
    print(f"decisions: {c['hit']} hits, {c['miss']} misses, "
          f"{c['admit']} admits, {c['evict']} evicts "
          f"(${events.dollars_at_stake('hit'):.9f} saved by hits)")

    # ---- artifacts --------------------------------------------------------
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        snap = engine.governance_snapshot()
        (out / "obs.json").write_text(
            json.dumps(snap, indent=2, sort_keys=True) + "\n")
        tracer.write_chrome_trace(out / "trace.chrome.json")
        metrics.write_prometheus(out / "metrics.prom")
        print(f"\nwrote {out / 'obs.json'}, {out / 'trace.chrome.json'}, "
              f"{out / 'metrics.prom'}")


if __name__ == "__main__":
    main()
