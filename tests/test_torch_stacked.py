"""The stacked layer layout (`repro_torch.models.transformer`) against the
JAX package's: `stacked_param_defs`, `params_to_stacked` /
`stacked_to_params`, `loss_fn_scanned` and `layer_fwdbwd_probe`.

The port loops over `stack[i]` with `checkpoint_layer` where the
reference scans the stack under `jax.checkpoint`. On the smoke configs of
qwen2-moe-a2.7b, kimi-k2-1t-a32b (`first_k_dense` 1: one layer stays
unstacked) and qwen2-vl-72b (M-RoPE), with the reference's float32
weights carried across: the scanned loss and its gradients, and the
layer probe's gradients, within rtol = atol = 1e-4 of JAX's (each
gradient leaf's max |diff| within 1e-4 of its max |g_ref|, the training
tests' rule). The port's scanned loss is bit-equal to its own `loss_fn`
(the same layers in the same order), and the round trip through the
stacked layout is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as rcommon
from repro.models import transformer as rtfm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves
from repro_torch.train.trainer import value_and_grad

import _torch_parity as parity

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "qwen2-vl-72b"]
REL = 1e-4
f32 = parity.f32


def _paths(tree, prefix=""):
    """{path: leaf} of a port tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _jax_paths(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                    for k in path): v for path, v in leaves}


def _batch(cfg, B=2, S=16, seed=21):
    jb, tb = parity.batches(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels.astype(np.int64))
    return jb, tb


def _close_grads(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = f32(got[k]), f32(want[k])
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= REL * max(np.abs(w).max(), 1e-30), k


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_param_defs_equal_reference(arch):
    rm, _, tm, _ = parity.models(arch, "float32")
    want = _jax_paths(rtfm.stacked_param_defs(rm.cfg))   # ParamDef leaves
    got = _paths(tfm.stacked_param_defs(tm.cfg))
    assert got.keys() == want.keys()
    for k, d in want.items():
        g = got[k]
        assert (g.shape, g.axes, g.init, g.scale) == \
            (d.shape, d.axes, d.init, d.scale), k
    n_tail = tm.cfg.num_layers - tm.cfg.first_k_dense
    assert all(d.shape[0] == n_tail and d.axes[0] is None
               for k, d in got.items() if k.startswith("/stack/"))


@pytest.mark.parametrize("arch", ARCHS)
def test_scanned_loss_and_grads_match_reference(arch):
    rm, rp, tm, tp = parity.models(arch, "float32")
    jb, tb = _batch(rm.cfg)
    rsp = rtfm.params_to_stacked(rm.cfg, rp)
    tsp = tfm.params_to_stacked(tm.cfg, tp)
    rloss, rgrads = jax.value_and_grad(
        lambda p: rtfm.loss_fn_scanned(rm.cfg, p, jb))(rsp)
    tloss, tgrads = value_and_grad(
        lambda p, b: tfm.loss_fn_scanned(tm.cfg, p, b), tsp, tb)
    assert abs(float(tloss) - float(rloss)) <= REL * abs(float(rloss))
    _close_grads(_paths(tgrads), _jax_paths(rgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_probe_grads_match_reference(arch):
    rm, rp, tm, tp = parity.models(arch, "float32")
    cfg = rm.cfg
    layer = cfg.first_k_dense
    B, S = 2, 8
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    else:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    rg_p, rg_x = rtfm.layer_fwdbwd_probe(cfg, layer)(
        rp["layers"][layer], jnp.asarray(x), jnp.asarray(pos))
    tg_p, tg_x = tfm.layer_fwdbwd_probe(tm.cfg, layer)(
        tp["layers"][layer], torch.from_numpy(x), torch.from_numpy(pos))
    _close_grads(_paths(tg_p), _jax_paths(rg_p))
    _close_grads({"x": tg_x}, {"x": rg_x})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scanned_loss_bit_equal_to_loss_fn(arch, dtype):
    rm, _, tm, tp = parity.models(arch, dtype)
    _, tb = _batch(rm.cfg)
    want = tm.loss_fn(tp, tb)
    got = tfm.loss_fn_scanned(tm.cfg, tfm.params_to_stacked(tm.cfg, tp), tb)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_is_exact(arch):
    _, _, tm, tp = parity.models(arch, "bfloat16")
    sp = tfm.params_to_stacked(tm.cfg, tp)
    n_tail = tm.cfg.num_layers - tm.cfg.first_k_dense
    assert all(t.shape[0] == n_tail for t in tree_leaves(sp["stack"]))
    assert len(sp["head_layers"]) == tm.cfg.first_k_dense
    back = tfm.stacked_to_params(tm.cfg, sp)
    a, b = _paths(tp), _paths(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_heterogeneous_tail_refused():
    cfg = dataclasses.replace(parity.models("qwen2-moe-a2.7b", "float32")[2]
                              .cfg, num_layers=4, moe_every=2)
    with pytest.raises(ValueError, match="homogeneous"):
        tfm.stacked_param_defs(cfg)
