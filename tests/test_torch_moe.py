"""The port's MoE layer and MoE models against the JAX package's.

Inputs are made with numpy from a seed; the reference's parameters are
carried into the port by `params_from_numpy`, bit for bit. Tolerances:

* float32: one MoE layer at rtol = atol = 1e-5 (the primitives' tolerance
  in test_torch_models.py); whole smoke models (forward, prefill logits
  and caches, decode) at 1e-4, with equal top-k experts and equal keep
  masks in every layer -- routing is discrete, so it must agree exactly.
* bfloat16: rtol = 2e-2, atol = 1e-2, the dense models' tolerance.

Routing is read from each layer's input: both packages' `moe_ffn_apply`
are wrapped to record it, and the reference's routing is recomputed from
that input with its own operations (`repro/models/moe.py:55-70`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as rcommon
import repro.models.moe as rmoe
import repro.models.transformer as rtransformer
from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.serve.engine import _grow as ref_grow
import repro_torch.models.common as tcommon
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttransformer
from repro_torch.configs import get_config
from repro_torch.models import get_model, params_from_numpy
from repro_torch.serve.engine import _grow

MOE = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}
LAYER_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2e-2, atol=1e-2)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(arch, dtype, **change):
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        rc = dataclasses.replace(rc, param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, param_dtype=torch.float32)
    return dataclasses.replace(rc, **change), dataclasses.replace(tc, **change)


def _models(arch, dtype):
    rc, tc = _configs(arch, dtype)
    rm, tm = ref_model(rc), get_model(tc)
    rp = rm.init(jax.random.key(0))
    return rm, rp, tm, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _ref_routing(cfg, p, x):
    """The reference's top-k experts and keep mask for x (B, S, d), by its
    own operations (moe.py:55-70; S = 1 keeps every choice)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    gates = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, gi = jax.lax.top_k(gates, K)
    if S == 1:
        return np.asarray(gi), np.ones((B, K), bool)
    TK = S * K
    C = max(1, int(S * K * cfg.capacity_factor / E))
    flat_e = gi.reshape(B, TK)
    order = jnp.argsort(flat_e, axis=-1)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    rows = jnp.broadcast_to(jnp.arange(B)[:, None], (B, TK))
    counts = jnp.zeros((B, E), jnp.int32).at[rows, sorted_e].add(1)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos = (jnp.arange(TK, dtype=jnp.int32)[None]
           - jnp.take_along_axis(starts, sorted_e, axis=-1))
    keep = jnp.zeros((B, TK), bool).at[rows, order].set(pos < C)
    return np.asarray(gi), np.asarray(keep).reshape(B, S, K)


def _port_routing(cfg, p, x):
    B, S, _ = x.shape
    _, gi = tmoe.route(cfg, p, x)
    if S == 1:
        return gi.numpy(), np.ones((B, cfg.top_k), bool)
    order, _, keep, _ = tmoe.dispatch_plan(gi, tmoe.capacity(cfg, S))
    by_entry = torch.zeros_like(keep).scatter_(-1, order, keep)
    return gi.numpy(), by_entry.view(B, S, cfg.top_k).numpy()


@pytest.fixture
def routing(monkeypatch):
    """Record every MoE layer's routing in both packages, call by call."""
    log = {"ref": [], "port": []}

    def wrap(module, side, routing_of):
        real = module.moe_ffn_apply

        def recorded(cfg, p, x):
            log[side].append(routing_of(cfg, p, x))
            return real(cfg, p, x)
        monkeypatch.setattr(module, "moe_ffn_apply", recorded)

    wrap(rtransformer, "ref", _ref_routing)
    wrap(ttransformer, "port", _port_routing)
    return log


def _same_routing(log):
    assert len(log["port"]) == len(log["ref"]) > 0
    for (tg, tk), (rg, rk) in zip(log["port"], log["ref"]):
        np.testing.assert_array_equal(tg, rg)
        np.testing.assert_array_equal(tk, rk)
    log["ref"].clear(), log["port"].clear()


# ---------------------------------------------------------------------------
# parameters and capacity


@pytest.mark.parametrize("arch", MOE)
def test_moe_param_defs_match(arch):
    want = jax.tree.leaves(
        ref_model(ref_config(arch, smoke=True)).param_defs(),
        is_leaf=lambda x: isinstance(x, rcommon.ParamDef))
    got = jax.tree.leaves(get_model(get_config(arch, smoke=True)).param_defs(),
                          is_leaf=lambda x: isinstance(x, tcommon.ParamDef))
    assert [(d.shape, d.axes, d.init, d.scale) for d in got] == \
        [(d.shape, d.axes, d.init, d.scale) for d in want]
    assert [d.dtype is torch.float32 for d in got] == \
        [d.dtype == jnp.float32 for d in want]
    assert any(d.dtype is torch.float32 for d in got)         # the routers


@pytest.mark.parametrize("S,C", [(512, 42), (513, 42), (2304, 192), (1, 1)])
def test_capacity_at_full_width(S, C):
    cfg = get_config("qwen2-moe-a2.7b")
    assert tmoe.capacity(cfg, S) == C == \
        max(1, int(S * cfg.top_k * cfg.capacity_factor / cfg.num_experts))


def test_full_width_parameter_count():
    """qwen2-moe-a2.7b at full width: 14,315,587,584 parameters."""
    defs = get_model(get_config("qwen2-moe-a2.7b")).param_defs()
    leaves = jax.tree.leaves(defs, is_leaf=lambda x: isinstance(
        x, tcommon.ParamDef))
    assert sum(int(np.prod(d.shape)) for d in leaves) == 14_315_587_584


# ---------------------------------------------------------------------------
# one MoE layer


def _layer(arch, dtype, router=None, **change):
    rc, tc = _configs(arch, dtype, **change)
    rp = ref_model(rc).init(jax.random.key(0))["layers"][rc.first_k_dense]
    rp = rp["moe"]
    if router is not None:
        rp = dict(rp, router=jnp.asarray(router(rp["router"].shape)))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, rp, tc, tp


def _layer_inputs(rc, tc, B, S, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, rc.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(rc.param_dtype), \
        torch.from_numpy(x).to(tc.param_dtype)


def _check_layer(rc, rp, tc, tp, B, S, dtype):
    xj, xt = _layer_inputs(rc, tc, B, S)
    want = rmoe.moe_ffn_apply(rc, rp, xj)
    got = tmoe.moe_ffn_apply(tc, tp, xt)
    assert got.dtype == tc.param_dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **LAYER_TOL[dtype])
    rg, rk = _ref_routing(rc, rp, xj)
    tg, tk = _port_routing(tc, tp, xt)
    np.testing.assert_array_equal(tg, rg)
    np.testing.assert_array_equal(tk, rk)
    return rk


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S", [1, 24])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_apply_matches(arch, S, dtype):
    rc, rp, tc, tp = _layer(arch, dtype)
    _check_layer(rc, rp, tc, tp, 3, S, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", MOE)
def test_router_ties_pick_the_lower_experts(arch, dtype):
    """A router of zeros makes every gate tie: both packages pick experts
    0..K-1 for every token, and, on S > 1, every token then queues for the
    same K experts, so all but the first C of each are dropped."""
    rc, rp, tc, tp = _layer(arch, dtype, router=np.zeros)
    for S in (1, 24):
        keep = _check_layer(rc, rp, tc, tp, 2, S, dtype)
        _, gi = tmoe.route(tc, tp, _layer_inputs(rc, tc, 2, S)[1])
        assert (gi == torch.arange(tc.top_k)).all()
        if S > 1:
            C = tmoe.capacity(tc, S)
            assert keep.sum() == 2 * tc.top_k * C < keep.size
            assert keep[:, :C].all() and not keep[:, C:].any()


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", MOE)
def test_forced_drops_match(arch, dtype):
    """A capacity factor of 0.3 drops most entries (C = 1 or 2 slots an
    expert); the port drops the same ones (the later tokens of an expert)
    and computes the same output."""
    rc, rp, tc, tp = _layer(arch, dtype, capacity_factor=0.3)
    keep = _check_layer(rc, rp, tc, tp, 2, 24, dtype)
    assert 0 < keep.sum() < keep.size // 2


def test_layer_gives_the_same_bits_twice():
    rc, rp, tc, tp = _layer("qwen2-moe-a2.7b", "bfloat16")
    _, xt = _layer_inputs(rc, tc, 3, 24)
    for S in (1, 24):
        a = tmoe.moe_ffn_apply(tc, tp, xt[:, :S])
        b = tmoe.moe_ffn_apply(tc, tp, xt[:, :S].clone())
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# whole MoE smoke models: forward, prefill, decode


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", MOE)
def test_moe_model_matches_reference(arch, dtype, routing):
    rm, rp, tm, tp = _models(arch, dtype)
    tol, S = TOL[dtype], 20
    toks = np.random.default_rng(5).integers(
        0, rm.cfg.vocab_size, (2, S)).astype(np.int32)
    jt, tt = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks.astype(np.int64))}
    np.testing.assert_allclose(_f32(tm.forward(tp, tt)),
                               _f32(rm.forward(rp, jt)), **tol)
    n_moe = sum(rm.cfg.is_moe_layer(l) for l in range(rm.cfg.num_layers))
    assert len(routing["port"]) == n_moe
    if dtype == "float32":
        dropped = sum(int((~k).sum()) for _, k in routing["port"])
        assert dropped > 0, "no token was dropped: capacity untested"
        _same_routing(routing)
    rl, rcache = rm.prefill(rp, jt)
    tl, tcache = tm.prefill(tp, tt)
    np.testing.assert_allclose(_f32(tl), _f32(rl), **tol)
    for (rk, rv), (tk, tv) in zip(rcache, tcache):
        assert tuple(tk.shape) == rk.shape
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
    if dtype == "float32":
        _same_routing(routing)


def test_moe_abstract_caches_are_dense():
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    caches = get_model(cfg).abstract_caches(3, 40)
    assert len(caches) == cfg.num_layers
    for k, v in caches:
        assert tuple(k.shape) == (3, 40, cfg.num_kv_heads, cfg.hd)
        assert k.dtype == cfg.param_dtype and k.device.type == "meta"
