"""Train and serve step assembly on PyTorch, and the sharding of
parameters and optimizer state.

The port of `repro.train.trainer`. `make_train_step` and
`make_decode_step` give the functions a driver calls; they run eagerly
(the reference's are jitted). With DTensor parameters
(`repro_torch.parallel`) the step runs sharded: `grad_shardings` pins each
gradient to its parameter's placements, and `train_state_shardings` gives
the placements of parameters and optimizer state.
"""
from __future__ import annotations

import torch

from ..models.common import (is_dtensor, tree_leaves, tree_map,
                             tree_zip_map)
from ..models.registry import ModelApi
from ..parallel.sharding import (NamedSharding, PartitionSpec, ShardingRules,
                                 params_sharding)
from .optim import Optimizer, _factored

__all__ = ["make_train_step", "value_and_grad", "make_decode_step",
           "make_prefill", "train_state_shardings", "opt_state_sharding"]


def value_and_grad(loss_of, params, batch):
    """(loss, grads): the gradients of `loss_of(params, batch)` as a tree of
    `params`' structure, taken with `torch.autograd.grad` over detached
    copies of the leaves, so no `.grad` is left on the caller's tensors."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_of(leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    it = iter(grads)
    loss = loss.detach()
    if is_dtensor(loss):
        loss = loss.full_tensor()
    return loss, tree_map(lambda _: next(it), params)


def _pin(g, s: NamedSharding):
    """The gradient g with its parameter's placements (the reference's
    `with_sharding_constraint`)."""
    if not is_dtensor(g):
        raise TypeError("grad_shardings needs DTensor parameters")
    return g.redistribute(s.mesh, s.placements)


def _microbatch(x, i: int, n: int):
    """Rows i*B/n .. (i+1)*B/n - 1 of x, the reference's split. A DTensor
    keeps x's placements where they divide the microbatch's rows, and is
    replicated on the mesh dims where they do not."""
    Bm = x.shape[0] // n
    if not is_dtensor(x):
        return x.reshape((n, Bm) + tuple(x.shape[1:]))[i]
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = x.device_mesh, list(x.placements)
    shards = 1
    for d, q in enumerate(pl):
        if q == Shard(0):
            shards *= mesh.size(d)
    if Bm % shards:
        pl = [Replicate() if q == Shard(0) else q for q in pl]
    return x[i * Bm:(i + 1) * Bm].redistribute(mesh, pl)


def make_train_step(model: ModelApi, opt: Optimizer, *,
                    microbatches: int = 1, remat: bool = True,
                    loss_override=None, accum_dtype=torch.float32,
                    grad_shardings=None):
    """(params, opt_state, batch) -> (loss, new_params, new_opt_state).

    With microbatches > 1 the batch's leading dim is split and the
    gradients accumulate in `accum_dtype` across the microbatches, one
    after another; the optimizer gets their mean cast to bfloat16, as the
    reference's does (whatever the parameter dtype), and the accumulator is
    freed before the update. `loss_override(params, batch)` substitutes
    the model's loss. `grad_shardings` (the parameters' NamedShardings)
    pins every gradient, the accumulator and the new parameters to the
    parameters' placements (the reference's jit pins the last with its
    out_shardings): DTensor would otherwise leave them in whatever layout
    the last operation gave (partial sums, say).
    """
    def loss_of(params, batch):
        if loss_override is not None:
            return loss_override(params, batch)
        return model.loss_fn(params, batch, remat=remat)

    def pin(tree):
        if grad_shardings is None:
            return tree
        return tree_zip_map(_pin, tree, grad_shardings)

    if microbatches == 1:
        def step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_of, params, batch)
            new_params, new_state = opt.update(pin(grads), opt_state, params)
            return loss, pin(new_params), new_state
        return step

    def step(params, opt_state, batch):
        gsum = pin(tree_map(lambda p: torch.zeros_like(
            p, dtype=accum_dtype, memory_format=torch.contiguous_format),
            params))
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for i in range(microbatches):
            loss, grads = value_and_grad(
                loss_of, params,
                {k: _microbatch(v, i, microbatches) for k, v in batch.items()})
            gsum = _accumulate(gsum, pin(grads))
            loss_sum = loss_sum + loss
            del grads
        grads = tree_map(
            lambda g: (g / microbatches).to(torch.bfloat16), gsum)
        del gsum
        new_params, new_state = opt.update(grads, opt_state, params)
        return loss_sum / microbatches, pin(new_params), new_state
    return step


def _accumulate(acc, grads):
    """acc + grads.astype(acc's dtype), the reference's sum, leaf by leaf,
    written into the accumulator (the step's own tensors). A gradient the
    accumulator's dtype holds exactly is widened inside the add (one
    kernel); a wider one is rounded to it first, as the reference rounds
    it."""
    def add(a, g):
        if torch.promote_types(a.dtype, g.dtype) != a.dtype:
            g = g.to(a.dtype)
        return a.add_(g)
    return tree_zip_map(add, acc, grads)


def make_decode_step(model: ModelApi):
    def step(params, token, caches, position):
        return model.decode_step(params, token, caches, position)
    return step


def make_prefill(model: ModelApi):
    def step(params, batch):
        return model.prefill(params, batch)
    return step


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------

def opt_state_sharding(rules: ShardingRules, opt: Optimizer,
                       abstract_params, axes_tree):
    """NamedShardings for the optimizer state (factored stats drop an
    axis)."""
    mesh = rules.mesh
    name = opt.cfg.name
    replicated = NamedSharding(mesh, PartitionSpec())
    if name == "adamw":
        per_param = tree_zip_map(
            lambda p, ax: NamedSharding(mesh, rules.spec_for(p.shape, ax)),
            abstract_params, axes_tree)
        return {"m": per_param, "v": per_param, "count": replicated}
    if name == "adafactor":
        def leaf(p, ax):
            shape = tuple(p.shape)
            if _factored(opt.cfg, shape):
                return {"vr": NamedSharding(
                            mesh, rules.spec_for(shape[:-1], ax[:-1])),
                        "vc": NamedSharding(
                            mesh, rules.spec_for(shape[:-2] + shape[-1:],
                                                 ax[:-2] + ax[-1:]))}
            return {"v": NamedSharding(mesh, rules.spec_for(shape, ax))}

        stats = tree_zip_map(leaf, abstract_params, axes_tree)
        return {"stats": stats, "count": replicated}
    if name == "sgd":
        return {"count": replicated}
    raise ValueError(name)


def train_state_shardings(rules: ShardingRules, model: ModelApi,
                          opt: Optimizer):
    """(param_shardings, opt_state_shardings, abstract_params,
    abstract_opt_state): the abstract trees are meta tensors."""
    ap = model.abstract()
    ax = model.axes()
    ps = params_sharding(rules, ap, ax)
    abstract_opt = opt.init(ap)
    os_ = opt_state_sharding(rules, opt, ap, ax)
    return ps, os_, ap, abstract_opt
