"""The port's serving engine on the CPU: the reference's serving, billing
and observability tests, mirrored on `device="cpu"`, and the same request
stream through both engines, on the reference's weights carried across.

The bill depends only on the prompts (the keys) and on each prefix blob's
byte length, so GETs, dollars, hits, misses, the audit and the metrics
must be equal exactly; blob contents are bf16 caches from two frameworks
and agree within bf16 tolerance (rtol 2e-2, atol 1e-2, as in
test_torch_models.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import get_model, params_from_numpy
from repro_torch.obs import EventLog, Tracer
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _prefix_key


def _engine(**kw):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    return ServeEngine(model, params, prefix_cache_bytes=1 << 22,
                       device="cpu", **kw), cfg


# ---------------------------------------------------------------------------
# tests/test_serve.py, mirrored (its fleet test is in test_torch_fleet.py)


def test_serve_batch_produces_tokens():
    engine, cfg = _engine()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                    max_new_tokens=3) for i in range(4)]
    done = engine.serve(reqs)
    for r in done:
        assert r.output is not None and r.output.shape == (3,)
        assert r.output.dtype == np.int32
        assert (0 <= r.output).all() and (r.output < cfg.vocab_size).all()


def test_greedy_decode_deterministic():
    engine, cfg = _engine()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
    a = engine.serve([Request(0, prompt, 4)])[0].output
    b = engine.serve([Request(1, prompt.copy(), 4)])[0].output
    np.testing.assert_array_equal(a, b)


def test_prefix_cache_reduces_billing():
    engine, cfg = _engine()
    rng = np.random.default_rng(2)
    hot = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    for i in range(5):
        engine.serve([Request(i, hot, 2)])
    rep = engine.audit()
    assert rep.requests >= 4        # prefix touched on every repeat
    assert rep.hit_rate > 0.5
    assert rep.observed_dollars >= 0


def test_mixed_lengths_batched_by_length():
    engine, cfg = _engine()
    rng = np.random.default_rng(3)
    reqs = [Request(0, rng.integers(0, cfg.vocab_size, 8).astype(np.int32), 2),
            Request(1, rng.integers(0, cfg.vocab_size, 16).astype(np.int32), 2),
            Request(2, rng.integers(0, cfg.vocab_size, 8).astype(np.int32), 2)]
    done = engine.serve(reqs)
    assert all(r.output is not None for r in done)


# ---------------------------------------------------------------------------
# tests/test_serve_billing.py, mirrored


def test_one_get_per_unique_prefix():
    engine, cfg = _engine()
    rng = np.random.default_rng(0)
    a = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    for _ in range(5):
        engine.serve([Request(0, a, 2)])
    for _ in range(3):
        engine.serve([Request(1, b, 2)])
    assert engine.store.meter.gets == 2            # one per unique prefix
    assert engine.cache.meter.gets == 2            # ... attributed to the cache
    assert engine.cache.hits == (4 - 1) + (2 - 1)  # every later touch is a hit
    engine.serve([Request(2, a, 2)])
    assert engine.store.meter.gets == 2


def test_hot_swap_mid_stream_preserves_contents_and_billing():
    engine, cfg = _engine(policy="gdsf")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
               for _ in range(3)]
    for p in prompts:
        engine.serve([Request(0, p, 2)])
        engine.serve([Request(1, p, 2)])           # warm: 1 GET per prefix
    gets_before = engine.store.meter.gets
    resident = set(engine.cache._data)
    engine.cache.set_policy("lru")                 # hot-swap mid-stream
    assert set(engine.cache._data) == resident     # contents preserved
    out = [engine.serve([Request(2, p, 2)])[0].output for p in prompts]
    assert engine.store.meter.gets == gets_before  # swap never re-bills
    assert all(o is not None for o in out)
    assert engine.cache.policy == "lru"


def test_governed_engine_serves_and_snapshots():
    engine, cfg = _engine(govern=True, governor_window=4)
    rng = np.random.default_rng(2)
    hot = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    for i in range(6):
        engine.serve([Request(i, hot, 2)])
    assert engine.governor is not None
    snap = engine.governance_snapshot()
    assert "governor" in snap and "metrics" in snap
    assert snap["consumers"].keys() == {"serve_prefix_cache"}
    assert snap["store"]["dollars"] == pytest.approx(
        snap["consumers"]["serve_prefix_cache"]["dollars"])
    assert engine.metrics.counter("serve.requests") == 6
    assert engine.metrics.counter("egress.serve_prefix_cache.hits") > 0
    rep = engine.governor.audit()
    assert rep is not None and rep.dollar_regret >= 0


# ---------------------------------------------------------------------------
# tests/test_obs.py's governed serve run, mirrored


def test_governed_serve_span_dollars_equal_meter():
    tracer, events = Tracer(), EventLog()
    engine, cfg = _engine(govern=True, governor_window=4, tracer=tracer,
                          events=events)
    rng = np.random.default_rng(5)
    hot = [rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
           for _ in range(2)]
    rid = 0
    for _ in range(4):
        engine.serve([Request(rid + i, h, 2) for i, h in enumerate(hot)])
        rid += len(hot)
    meter = engine.cache.meter
    assert meter.dollars > 0
    span_total = tracer.dollars(name="store.get",
                                consumer=engine.cache.consumer)
    assert span_total == pytest.approx(meter.dollars, rel=1e-12)
    assert events.dollars_billed("miss") == meter.dollars
    assert tracer.spans(name="serve.request"), "no request spans recorded"
    by_id = {s.span_id: s for s in tracer.spans()}
    for s in tracer.spans(name="cache.get"):
        assert by_id[s.parent_id].name in ("serve.request", "serve.batch")
    snap = engine.governance_snapshot()
    assert "events" in snap and "spans" in snap


# ---------------------------------------------------------------------------
# guards


def test_engine_without_a_device_needs_a_card(monkeypatch):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)


def test_engine_refuses_fleet_mode_and_misplaced_params():
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(AssertionError, match="mutually exclusive"):
        ServeEngine(model, params, fleet_nodes=3, govern=True, device="cpu")
    with pytest.raises(ValueError, match="parameters lie on"):
        ServeEngine(model, params, device="meta")


def test_prefix_key_is_the_reference_key():
    from repro.serve.engine import _prefix_key as ref_key
    prompt = np.random.default_rng(9).integers(0, 256, 33).astype(np.int32)
    assert _prefix_key(prompt) == ref_key(prompt)


# ---------------------------------------------------------------------------
# the same stream through both engines


def _stream(vocab, lengths, seed=11):
    """Ten rounds, each one request from each of two pools of prompts
    (of `lengths[0]` and `lengths[1]` tokens), drawn with skewed weights:
    repeats within and across rounds, so the cache hits, misses, evicts
    and (with the governor) may swap policy. Each round's batch shapes are
    the same, so the reference compiles them once."""
    rng = np.random.default_rng(seed)
    pools = [[rng.integers(0, vocab, n).astype(np.int32) for _ in range(3)]
             for n in lengths]
    return [[pool[rng.choice(3, p=[.5, .3, .2])] for pool in pools]
            for _ in range(10)]


@pytest.mark.parametrize("arch,policy,lengths,capacity", [
    # 1536-byte blobs, two fit: uniform sizes, the exact audit
    ("phi4-mini-3.8b", "gdsf", (12, 12), 3400),
    # 5632- and 6144-byte blobs (five windowed layers of 16 keys, one
    # global), two fit: two sizes, the cost-FOO audit
    ("gemma3-4b", "lru", (8, 16), 13000),
])
def test_serve_bill_equals_reference(arch, policy, lengths, capacity):
    rcfg, tcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rm, tm = ref_model(rcfg), get_model(tcfg)
    rp = rm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    kw = dict(prefix_cache_bytes=capacity, policy=policy, govern=True,
              governor_window=4)
    ref = RefEngine(rm, rp, **kw)
    port = ServeEngine(tm, tp, device="cpu", **kw)
    rid = 0
    for rnd in _stream(rcfg.vocab_size, lengths):
        ref.serve([RefRequest(rid + j, p, 2) for j, p in enumerate(rnd)])
        port.serve([Request(rid + j, p, 2) for j, p in enumerate(rnd)])
        rid += len(rnd)
    assert port.store.meter.snapshot() == ref.store.meter.snapshot()
    assert port.cache.misses > len(set(port.cache._trace_keys))  # evictions
    assert (port.cache.hits, port.cache.misses) == \
        (ref.cache.hits, ref.cache.misses)
    assert port.cache.hits > 0
    assert port.cache._trace_keys == ref.cache._trace_keys
    assert dataclasses.asdict(port.audit()) == dataclasses.asdict(ref.audit())
    assert port.governance_snapshot()["metrics"] == \
        ref.governance_snapshot()["metrics"]
    assert port.governor.snapshot() == ref.governor.snapshot()
    assert sorted(port.store.keys()) == sorted(ref.store.keys())
    for key in ref.store.keys():
        want, got = ref.store._data[key], port.store._data[key]
        assert len(got) == len(want)
        as_f32 = [(np.frombuffer(b, np.uint16).astype(np.uint32) << 16)
                  .view(np.float32) for b in (got, want)]
        np.testing.assert_allclose(*as_f32, rtol=2e-2, atol=1e-2)
