"""The port's recurrent families, RecurrentGemma's RG-LRU hybrid and
xLSTM, against the JAX package's on the same inputs, with the reference's
weights carried across; `associative_scan` against
`jax.lax.associative_scan`; both serving engines on one request stream.
Tolerances: see _torch_parity.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as rrglru
import repro.models.xlstm as rxlstm
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.models import rglru, xlstm
from repro_torch.models.common import associative_scan
from repro_torch.serve import Request, ServeEngine

from _torch_parity import (TOL, batches, check_abstract_caches, check_model,
                           check_param_defs, f32, models, token_pair)

HYBRID, XLSTM = "recurrentgemma-9b", "xlstm-125m"


@pytest.mark.parametrize("arch", [HYBRID, XLSTM])
def test_param_defs_match(arch):
    check_param_defs(arch)


# ---------------------------------------------------------------------------
# associative_scan


def _linear(l, r):
    """RG-LRU's and sLSTM's combine: y_t = a_t y_{t-1} + b_t."""
    return l[0] * r[0], r[0] * l[1] + r[1]


def _shared_decay(l, r):
    """The three-part combine xlstm.py defines beside it: (a, c, n) with c
    and n sharing the decay a."""
    al, bl, nl = l
    ar, br, nr = r
    return al * ar, ar * bl + br, ar * nl + nr


def _rglru_like(rng, shape, parts):
    """a as RG-LRU forms it (exp(-8 softplus(lam) r)), the rest normal, a
    negative zero among them; float32."""
    lam = rng.normal(0, 0.5, shape[-1])
    r = 1 / (1 + np.exp(-rng.standard_normal(shape)))
    a = np.exp(-8.0 * np.logaddexp(lam, 0) * r).astype(np.float32)
    rest = [rng.standard_normal(shape).astype(np.float32)
            for _ in range(parts - 1)]
    rest[0].flat[0] = -0.0
    return [a] + rest


def _flush(x):
    """XLA on the CPU flushes subnormal results to zero; PyTorch keeps
    them. Applied to the port's result only."""
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    return np.where(sub, np.float32(0), x)


@pytest.mark.parametrize("fn,parts", [(_linear, 2), (_shared_decay, 3)])
@pytest.mark.parametrize("S", [1, 2, 7, 16, 33, 512, 2304])
def test_associative_scan_equal_bits(fn, parts, S):
    """The same combines in the same order as JAX's recursion: every
    output equal bit for bit (the decay products once the port's
    subnormals are flushed as XLA flushes them)."""
    rng = np.random.default_rng(S)
    elems = _rglru_like(rng, (2, S, 24), parts)
    want = jax.lax.associative_scan(fn, tuple(jnp.asarray(e) for e in elems),
                                    axis=1)
    got = associative_scan(fn, tuple(torch.from_numpy(e) for e in elems), 1)
    assert len(got) == parts
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _flush(g.numpy()).tobytes() == w.tobytes()
    # the recurrence itself needs no flush
    assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()


@pytest.mark.parametrize("axis", [0, -1])
def test_associative_scan_on_other_axes(axis):
    rng = np.random.default_rng(9)
    elems = _rglru_like(rng, (13, 5, 11), 2)
    want = jax.lax.associative_scan(_linear, tuple(map(jnp.asarray, elems)),
                                    axis=axis)
    got = associative_scan(_linear, tuple(map(torch.from_numpy, elems)), axis)
    for g, w in zip(got, want):
        assert _flush(g.numpy()).tobytes() == np.asarray(w).tobytes()


# ---------------------------------------------------------------------------
# whole models


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S", [24, 10, 1])   # past the window; short; one
def test_hybrid_matches_reference(dtype, S):
    check_model(HYBRID, dtype, S)


def test_hybrid_long_prompt_takes_chunked_attention(monkeypatch):
    """Above _FULL_ATTN_LIMIT query x key the attention layer takes
    chunked_attention (with its window), as the reference does."""
    monkeypatch.setattr(rglru, "_FULL_ATTN_LIMIT", 16 * 16)
    monkeypatch.setattr(rrglru, "_FULL_ATTN_LIMIT", 16 * 16)
    calls = []
    real = rglru.chunked_attention
    monkeypatch.setattr(rglru, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    check_model(HYBRID, "float32", 40)
    assert calls, "chunked_attention was not taken"


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S", [20, 300])     # one chunk; two, padded
def test_xlstm_matches_reference(dtype, S):
    check_model(XLSTM, dtype, S)


def _stepwise(rm, rp, tm, tp, toks, rstate, tstate):
    """Decode every token of `toks` from the given states on both sides;
    the port's logits and states against the reference's at each step."""
    tol = TOL["float32"]
    outs = []
    for t in range(toks.shape[1]):
        rl, rstate = rm.decode_step(rp, jnp.asarray(toks[:, t]), rstate,
                                    jnp.int32(t))
        tl, tstate = tm.decode_step(tp, token_pair(toks[:, t]), tstate, t)
        np.testing.assert_allclose(f32(tl), f32(rl), **tol)
        for ts, rs in zip(tstate, rstate):
            for a, b in zip(ts, rs):
                np.testing.assert_allclose(f32(a), f32(b), **tol)
        outs.append(f32(tl))
    return np.stack(outs, 1)


def test_xlstm_decode_from_init_state_matches_reference():
    """Token by token from init_state, as test_smoke_archs' xLSTM check
    does; the port's sequence also agrees with its own chunkwise forward
    within that check's 0.05."""
    rm, rp, tm, tp = models(XLSTM, "float32")
    toks = np.random.default_rng(0).integers(0, 256, (1, 12)).astype(np.int32)
    seq = _stepwise(rm, rp, tm, tp, toks,
                    rxlstm.init_state(rm.cfg, 1, jnp.float32),
                    xlstm.init_state(tm.cfg, 1, torch.float32))
    par = f32(tm.forward(tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))}))
    np.testing.assert_allclose(seq, par, rtol=0.05, atol=0.05)


def test_rglru_decode_from_init_caches_matches_reference():
    rm, rp, tm, tp = models(HYBRID, "float32")
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    _stepwise(rm, rp, tm, tp, toks,
              rrglru.init_caches(rm.cfg, 2, 32, jnp.float32),
              rglru.init_caches(tm.cfg, 2, 32, torch.float32))


@pytest.mark.parametrize("dtype", list(TOL))
def test_rec_block_with_a_carried_state_matches_reference(dtype):
    """The scan seeded with a carried state (S > 1), which no entry point
    reaches but the block supports."""
    rm, rp, tm, tp = models(HYBRID, dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jdt, tdt = rm.cfg.param_dtype, tm.cfg.param_dtype
    want = rrglru._rec_block(rm.cfg, rp["layers"][0]["rec"],
                             jnp.asarray(x, jdt),
                             (jnp.asarray(h), jnp.asarray(conv, jdt)))
    got = rglru._rec_block(tm.cfg, tp["layers"][0]["rec"],
                           torch.from_numpy(x).to(tdt),
                           (torch.from_numpy(h),
                            torch.from_numpy(conv).to(tdt)))
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), **tol)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(f32(g), f32(w), **tol)


@pytest.mark.parametrize("arch,B,max_seq", [(HYBRID, 2, 40), (HYBRID, 1, 7),
                                            (XLSTM, 3, 40)])
def test_abstract_caches_match(arch, B, max_seq):
    check_abstract_caches(arch, B, max_seq)


def test_xlstm_prefill_returns_a_fresh_state():
    """The reference's stateless stress prefill, reproduced: the states do
    not see the prompt."""
    rm, rp, tm, tp = models(XLSTM, "bfloat16")
    _, tb = batches(rm.cfg, 2, 9, seed=3)
    _, states = tm.prefill(tp, tb)
    fresh = xlstm.init_state(tm.cfg, 2, torch.bfloat16)
    for got, want in zip(states, fresh):
        assert all(torch.equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the serving engine


def _stream(vocab, lengths, seed=11):
    """Ten rounds, each one request from each of two pools of prompts,
    drawn with skewed weights, as test_torch_serve.py's stream."""
    rng = np.random.default_rng(seed)
    pools = [[rng.integers(0, vocab, n).astype(np.int32) for _ in range(3)]
             for n in lengths]
    return [[pool[rng.choice(3, p=[.5, .3, .2])] for pool in pools]
            for _ in range(10)]


@pytest.mark.parametrize("arch,lengths,capacity,blob", [
    # 2 RG-LRU layers' h (float32, 256 B) + a 16-key window (1024 B)
    (HYBRID, (8, 20), 3400, 1536),
    # an mLSTM C (2 x 32 x 32 float32) + an sLSTM c (64 float32)
    (XLSTM, (8, 12), 17000, 8448),
])
def test_engine_matches_reference(arch, lengths, capacity, blob):
    """One request stream through both engines, governed, on the same
    float32 weights: equal tokens, GETs, dollars, hits, misses, audit,
    metrics and governor; blobs of the reference's length and contents."""
    rm, rp, tm, tp = models(arch, "float32")
    kw = dict(prefix_cache_bytes=capacity, policy="gdsf", govern=True,
              governor_window=4)
    ref = RefEngine(rm, rp, **kw)
    port = ServeEngine(tm, tp, device="cpu", **kw)
    rid = 0
    for rnd in _stream(rm.cfg.vocab_size, lengths):
        want = ref.serve([RefRequest(rid + j, p, 3)
                          for j, p in enumerate(rnd)])
        got = port.serve([Request(rid + j, p, 3) for j, p in enumerate(rnd)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.output, w.output)
        rid += len(rnd)
    assert port.store.meter.snapshot() == ref.store.meter.snapshot()
    assert (port.cache.hits, port.cache.misses) == \
        (ref.cache.hits, ref.cache.misses)
    assert port.cache.hits > 0
    assert port.cache.misses > len(set(port.cache._trace_keys))  # evictions
    assert port.cache._trace_keys == ref.cache._trace_keys
    assert dataclasses.asdict(port.audit()) == dataclasses.asdict(ref.audit())
    assert port.governance_snapshot()["metrics"] == \
        ref.governance_snapshot()["metrics"]
    assert port.governor.snapshot() == ref.governor.snapshot()
    assert sorted(port.store.keys()) == sorted(ref.store.keys())
    for key in ref.store.keys():
        want, got = ref.store._data[key], port.store._data[key]
        assert len(got) == len(want) == blob
        np.testing.assert_allclose(np.frombuffer(got, np.float32),
                                   np.frombuffer(want, np.float32),
                                   **TOL["float32"])
