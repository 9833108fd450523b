"""Shared helpers of the port's model tests: one architecture on both
packages with the reference's weights carried across, and the same batch
for each (tokens, plus the vlm family's vision embeddings or whisper's
frames), made with numpy from a seed.

Tolerances, as in test_torch_models.py: float32 at rtol = atol = 1e-4 (the
two frameworks sum matrix products in other orders); bfloat16 at rtol =
2e-2, atol = 1e-2, a few units in the last place of bf16's 8-bit mantissa.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.models import get_model, params_from_numpy

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def models(arch, dtype, **replace):
    """(reference model, its params, port model, the same params)."""
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        rc = dataclasses.replace(rc, param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, param_dtype=torch.float32)
    rc = dataclasses.replace(rc, **replace)
    tc = dataclasses.replace(tc, **replace)
    rm, tm = ref_model(rc), get_model(tc)
    rp = rm.init(jax.random.key(0))
    return rm, rp, tm, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def batches(cfg, B, S, seed, frames=30):
    """The same prefill batch for both packages, (reference's, port's),
    for the reference's config `cfg`."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks.astype(np.int64))}
    extra = {}
    if cfg.family == "vlm":
        extra["vision_embeds"] = (B, cfg.num_vision_tokens, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (B, frames, cfg.d_model)
    for name, shape in extra.items():
        a = rng.standard_normal(shape).astype(np.float32)
        jb[name] = jnp.asarray(a, cfg.param_dtype)
        tb[name] = torch.from_numpy(a).to(_torch_dtype(cfg.param_dtype))
    return jb, tb


def _torch_dtype(jax_dtype):
    return {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}[jnp.dtype(jax_dtype)]


def token_pair(rtok):
    """The reference's greedy tokens as the port's input."""
    return torch.from_numpy(np.asarray(rtok).astype(np.int64))


def assert_caches_close(tcaches, rcaches, tol):
    """Every tensor of every layer's cache or state: equal shape and dtype
    name, values within `tol`."""
    assert len(tcaches) == len(rcaches)
    for tl, rl in zip(tcaches, rcaches):
        assert len(tl) == len(rl)
        for t, r in zip(tl, rl):
            assert tuple(t.shape) == r.shape
            assert str(t.dtype).replace("torch.", "") == str(r.dtype)
            np.testing.assert_allclose(f32(t), f32(r), **tol)


def check_model(arch, dtype, S, B=2, steps=2, **replace):
    """forward, prefill (logits and every cache or state) and `steps`
    decode steps after each package's `_grow`, the port against the
    reference on the same weights and inputs, within TOL[dtype]. Returns
    the models for further checks."""
    from repro.serve.engine import _grow as ref_grow
    from repro_torch.serve.engine import _grow
    rm, rp, tm, tp = models(arch, dtype, **replace)
    tol = TOL[dtype]
    jb, tb = batches(rm.cfg, B, S, seed=5)
    np.testing.assert_allclose(f32(tm.forward(tp, tb)),
                               f32(rm.forward(rp, jb)), **tol)
    rl, rcache = rm.prefill(rp, jb)
    tl, tcache = tm.prefill(tp, tb)
    np.testing.assert_allclose(f32(tl), f32(rl), **tol)
    assert_caches_close(tcache, rcache, tol)
    rcache = ref_grow(rm, rcache, S + steps)
    tcache = _grow(tm, tcache, S + steps)
    assert_caches_close(tcache, rcache, tol)
    rtok = jnp.argmax(rl, -1).astype(jnp.int32)
    for step in range(steps):
        rl, rcache = rm.decode_step(rp, rtok, rcache, jnp.int32(S + step))
        tl, tcache = tm.decode_step(tp, token_pair(rtok), tcache, S + step)
        np.testing.assert_allclose(f32(tl), f32(rl), **tol)
        assert_caches_close(tcache, rcache, tol)
        rtok = jnp.argmax(rl, -1).astype(jnp.int32)
    return rm, rp, tm, tp


def check_abstract_caches(arch, B, max_seq):
    """abstract_caches: the reference's shapes and dtypes, layer by
    layer."""
    rm, tm = ref_model(ref_config(arch, smoke=True)), \
        get_model(get_config(arch, smoke=True))
    want = rm.abstract_caches(B, max_seq)
    got = tm.abstract_caches(B, max_seq)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in g] == [(s.shape, str(s.dtype)) for s in w]
        assert all(t.device.type == "meta" for t in g)


def check_param_defs(arch):
    """param_defs: the reference's leaves, in its order."""
    import repro.models.common as rcommon
    import repro_torch.models.common as tcommon
    want = jax.tree.leaves(
        ref_model(ref_config(arch, smoke=True)).param_defs(),
        is_leaf=lambda x: isinstance(x, rcommon.ParamDef))
    got = jax.tree.leaves(get_model(get_config(arch, smoke=True))
                          .param_defs(),
                          is_leaf=lambda x: isinstance(x, tcommon.ParamDef))
    assert [(d.shape, d.axes, d.init, d.scale) for d in got] == \
        [(d.shape, d.axes, d.init, d.scale) for d in want]
