"""The port's model stack against the JAX package's on the same inputs.

Inputs are made with numpy from a seed; the reference's parameters
(`init(jax.random.key(0))`) are carried into the port by
`params_from_numpy`, bit for bit. Tolerances:

* float32: the primitives at rtol = atol = 1e-5; whole models (forward,
  prefill logits and caches, decode after `_grow`) at 1e-4 -- the two
  frameworks sum matrix products in other orders.
* bfloat16: rtol = 2e-2, atol = 1e-2 on logits and caches, a few units
  in the last place of bf16's 8-bit mantissa (2^-8 = 0.0039 relative): XLA
  keeps fused elementwise chains in float32 where PyTorch rounds after
  each op, and the two sum products in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as rcommon
from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.serve.engine import _grow as ref_grow
import repro_torch.models.common as tcommon
from repro_torch.configs import get_config
from repro_torch.models import (get_model, params_from_numpy,
                                params_to_numpy, tensor_bytes)
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models import transformer
from repro_torch.serve.engine import _grow

import _torch_parity as parity

DENSE = ["chatglm3-6b", "phi4-mini-3.8b", "mistral-nemo-12b", "gemma3-4b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}
PRIM = dict(rtol=1e-5, atol=1e-5)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# primitives, float32


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 48))
    wj, wt = _pair(rng, (48,))
    np.testing.assert_allclose(_f32(tcommon.rms_norm(xt, wt)),
                               _f32(rcommon.rms_norm(xj, wj)), **PRIM)


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e4), (0.5, 1e4),
                                            (1.0, 1e6)])
def test_apply_rope_matches(fraction, theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = rcommon.apply_rope(xj, jnp.asarray(pos), theta, fraction)
    got = tcommon.apply_rope(xt, torch.from_numpy(pos), theta, fraction)
    np.testing.assert_allclose(_f32(got), _f32(want), **PRIM)


_ATTN = [  # B, Sq, Sk, H, G, D, window, causal, q_off, k_off
    (2, 16, 16, 4, 2, 8, 0, True, 0, 0),
    (1, 32, 32, 4, 1, 16, 8, True, 0, 0),     # window
    (2, 8, 24, 6, 2, 8, 0, True, 16, 0),      # positive q_offset
    (1, 4, 12, 4, 4, 8, 6, True, 9, -2),      # shift cache, negative k_offset
    (1, 16, 16, 2, 2, 8, 0, False, 0, 0),     # bidirectional
]


def _qkv(rng, B, Sq, Sk, H, G, D):
    return _pair(rng, (B, Sq, H, D)), _pair(rng, (B, Sk, G, D)), \
        _pair(rng, (B, Sk, G, D))


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,window,causal,q_off,k_off", _ATTN)
def test_attention_matches(B, Sq, Sk, H, G, D, window, causal, q_off, k_off):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, Sq, Sk, H, G, D)
    kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off)
    np.testing.assert_allclose(_f32(tcommon.attention(qt, kt, vt, **kw)),
                               _f32(rcommon.attention(qj, kj, vj, **kw)),
                               **PRIM)


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,window,causal,q_off,k_off,chunk", [
    (2, 16, 19, 4, 2, 8, 0, True, 3, 0, 8),   # Sk not a multiple of chunk
    (1, 12, 30, 4, 1, 16, 8, True, 18, 0, 16),
    (1, 4, 13, 4, 4, 8, 6, True, 9, -2, 4),
    (1, 9, 9, 2, 2, 8, 0, False, 0, 0, 4),
])
def test_chunked_attention_matches(B, Sq, Sk, H, G, D, window, causal, q_off,
                                   k_off, chunk):
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, Sq, Sk, H, G, D)
    kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off,
              kv_chunk=chunk)
    got = tcommon.chunked_attention(qt, kt, vt, **kw)
    np.testing.assert_allclose(
        _f32(got), _f32(rcommon.chunked_attention(qj, kj, vj, **kw)), **PRIM)
    kw.pop("kv_chunk")
    np.testing.assert_allclose(_f32(got),
                               _f32(tcommon.attention(qt, kt, vt, **kw)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn_matches(act):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng, (2, 5, 32))
    (w1j, w1t), (w3j, w3t), (w2j, w2t) = (_pair(rng, (32, 48)),
                                          _pair(rng, (32, 48)),
                                          _pair(rng, (48, 32)))
    want = rcommon.ffn(xj, w1j, w3j, w2j, act)
    got = tcommon.ffn(xt, w1t, w3t, w2t, act)
    np.testing.assert_allclose(_f32(got), _f32(want), **PRIM)


# ---------------------------------------------------------------------------
# parameters


def test_params_from_numpy_is_bit_exact_both_ways():
    cfg = ref_config("gemma3-4b", smoke=True)
    host = jax.tree.map(np.asarray, ref_model(cfg).init(jax.random.key(0)))
    tree = params_from_numpy(host, "cpu")
    assert tree["embed"].dtype == torch.bfloat16
    back = params_to_numpy(tree)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype.name == "bfloat16" and b.dtype == np.uint16
        assert a.tobytes() == b.tobytes()
    row = host["layers"][0]["attn"]["wq"]
    assert tensor_bytes(tensor_from_numpy(row)) == row.tobytes()
    f = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    assert tensor_bytes(tensor_from_numpy(f)) == f.tobytes()


@pytest.mark.parametrize("arch", DENSE)
def test_param_defs_match(arch):
    want = jax.tree.leaves(
        ref_model(ref_config(arch, smoke=True)).param_defs(),
        is_leaf=lambda x: isinstance(x, rcommon.ParamDef))
    got = jax.tree.leaves(get_model(get_config(arch, smoke=True)).param_defs(),
                          is_leaf=lambda x: isinstance(x, tcommon.ParamDef))
    assert [(d.shape, d.axes, d.init, d.scale) for d in got] == \
        [(d.shape, d.axes, d.init, d.scale) for d in want]


def test_init_follows_param_defs():
    model = get_model(get_config("phi4-mini-3.8b", smoke=True))
    a = model.init(7, device="cpu")
    b = model.init(torch.Generator().manual_seed(7))
    c = model.init(8, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["ln_f"], torch.ones_like(a["ln_f"]))
    assert 0.8 < float(a["embed"].float().std()) < 1.2         # scale 1.0
    assert 0.016 < float(a["unembed"].float().std()) < 0.024   # scale 0.02


def test_init_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(get_config("phi4-mini-3.8b", smoke=True)).init(0)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen2-moe-a2.7b",
                                  "whisper-large-v3", "recurrentgemma-9b",
                                  "xlstm-125m"])
def test_decode_step_leaves_the_callers_cache_unchanged(arch):
    """decode_step builds new caches (full timelines, shift caches,
    recurrent states) and leaves the ones it is given as they were, byte
    for byte, as the reference's does; so two calls on one input give the
    same bits, and both equal the reference's outputs (float32, 1e-4)."""
    rm, rp, tm, tp = parity.models(arch, "float32")
    S = 8
    jb, tb = parity.batches(rm.cfg, 2, S, seed=8)
    rl, rcache = rm.prefill(rp, jb)
    _, tcache = tm.prefill(tp, tb)
    rcache, tcache = ref_grow(rm, rcache, S + 2), _grow(tm, tcache, S + 2)
    before = [[tensor_bytes(t) for t in layer] for layer in tcache]
    rtok = jnp.argmax(rl, -1).astype(jnp.int32)
    want, rnew = rm.decode_step(rp, rtok, rcache, jnp.int32(S))
    got = [tm.decode_step(tp, parity.token_pair(rtok), tcache, S)
           for _ in range(2)]
    assert [[tensor_bytes(t) for t in layer] for layer in tcache] == before
    assert torch.equal(got[0][0], got[1][0])
    for logits, new in got:
        np.testing.assert_allclose(_f32(logits), _f32(want),
                                   **TOL["float32"])
        parity.assert_caches_close(new, rnew, TOL["float32"])
    changed = [not torch.equal(a, b) for layer, old in zip(got[0][1], tcache)
               for a, b in zip(layer, old)]
    assert any(changed)                 # the step wrote its new state


def test_cache_write_past_the_end_is_clamped_as_the_reference():
    """A write that would run past the cache's end starts at W - S, as
    `dynamic_update_slice_in_dim` clamps it (a negative start counts from
    the end first, as there), into a new cache. And
    decode_step at a position past the grown cache equals the
    reference's there."""
    rng = np.random.default_rng(9)
    cache = rng.standard_normal((2, 6, 1, 3)).astype(np.float32)
    x = rng.standard_normal((2, 2, 1, 3)).astype(np.float32)
    for at in (-9, -3, -1, 0, 3, 4, 5, 9):
        want = jax.lax.dynamic_update_slice_in_dim(
            jnp.asarray(cache), jnp.asarray(x), at, 1)
        before = torch.from_numpy(cache.copy())
        got = transformer._write(before, torch.from_numpy(x), at)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(before, torch.from_numpy(cache))

    rm, rp, tm, tp = _models("phi4-mini-3.8b", "float32")
    S = 8
    toks = np.random.default_rng(10).integers(
        0, rm.cfg.vocab_size, (2, S)).astype(np.int32)
    rl, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})
    rcache, tcache = ref_grow(rm, rcache, S + 2), _grow(tm, tcache, S + 2)
    rtok = jnp.argmax(rl, -1).astype(jnp.int32)
    want, rnew = rm.decode_step(rp, rtok, rcache, jnp.int32(S + 4))
    got, tnew = tm.decode_step(
        tp, torch.from_numpy(np.asarray(rtok).astype(np.int64)), tcache,
        S + 4)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])
    parity.assert_caches_close(tnew, rnew, TOL["float32"])


# ---------------------------------------------------------------------------
# whole dense models: forward, prefill, decode


def _models(arch, dtype):
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        rc = dataclasses.replace(rc, param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, param_dtype=torch.float32)
    rm, tm = ref_model(rc), get_model(tc)
    rp = rm.init(jax.random.key(0))
    return rm, rp, tm, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


_CASES = [(a, d, 20) for a in DENSE for d in TOL] + \
    [("gemma3-4b", d, 10) for d in TOL]   # shorter than the window


@pytest.mark.parametrize("arch,dtype,S", _CASES)
def test_dense_model_matches_reference(arch, dtype, S):
    rm, rp, tm, tp = _models(arch, dtype)
    tol = TOL[dtype]
    toks = np.random.default_rng(5).integers(
        0, rm.cfg.vocab_size, (2, S)).astype(np.int32)
    jt, tt = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks.astype(np.int64))}
    np.testing.assert_allclose(_f32(tm.forward(tp, tt)),
                               _f32(rm.forward(rp, jt)), **tol)
    rl, rcache = rm.prefill(rp, jt)
    tl, tcache = tm.prefill(tp, tt)
    np.testing.assert_allclose(_f32(tl), _f32(rl), **tol)
    assert len(tcache) == len(rcache)
    for (rk, rv), (tk, tv) in zip(rcache, tcache):
        assert tuple(tk.shape) == rk.shape and tk.dtype == tp["embed"].dtype
        np.testing.assert_allclose(_f32(tk), _f32(rk), **tol)
        np.testing.assert_allclose(_f32(tv), _f32(rv), **tol)
    rcache, tcache = ref_grow(rm, rcache, S + 3), _grow(tm, tcache, S + 3)
    rtok = jnp.argmax(rl, -1).astype(jnp.int32)
    for step in range(3):
        ttok = torch.from_numpy(np.asarray(rtok).astype(np.int64))
        rl, rcache = rm.decode_step(rp, rtok, rcache, jnp.int32(S + step))
        tl, tcache = tm.decode_step(tp, ttok, tcache, S + step)
        np.testing.assert_allclose(_f32(tl), _f32(rl), **tol)
        for (rk, _), (tk, _) in zip(rcache, tcache):
            np.testing.assert_allclose(_f32(tk), _f32(rk), **tol)
        rtok = jnp.argmax(rl, -1).astype(jnp.int32)


def test_long_prompt_takes_chunked_attention(monkeypatch):
    """Above _FULL_ATTN_LIMIT query x key the port takes chunked_attention,
    as the reference does; both sides agree there in float32."""
    monkeypatch.setattr(transformer, "_FULL_ATTN_LIMIT", 16 * 16)
    import repro.models.transformer as rtransformer
    monkeypatch.setattr(rtransformer, "_FULL_ATTN_LIMIT", 16 * 16)
    calls = []
    real = transformer.chunked_attention
    monkeypatch.setattr(transformer, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rm, rp, tm, tp = _models("phi4-mini-3.8b", "float32")
    toks = np.random.default_rng(6).integers(0, 256, (1, 24)).astype(np.int32)
    rl, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    assert calls, "chunked_attention was not taken"
    np.testing.assert_allclose(_f32(tl), _f32(rl), **TOL["float32"])
