"""Train and serve step assembly on PyTorch.

The port of `repro.train.trainer`'s step functions. `make_train_step` and
`make_decode_step` give the functions a driver calls; they run eagerly
(the reference's are jitted). The sharding half of the reference
(`grad_shardings`, `opt_state_sharding`, `train_state_shardings`) waits
for ROADMAP queue 1, item 9, and raises here.
"""
from __future__ import annotations

import torch

from ..models.common import tree_leaves, tree_map, tree_zip_map
from ..models.registry import ModelApi
from .optim import Optimizer

__all__ = ["make_train_step", "value_and_grad", "make_decode_step",
           "make_prefill", "train_state_shardings", "opt_state_sharding"]

_SHARDING = "sharding is ROADMAP queue 1, item 9"


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
    return loss.detach(), tree_map(lambda _: next(it), params)


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
    the model's loss.
    """
    if grad_shardings is not None:
        raise NotImplementedError(_SHARDING)

    def loss_of(params, batch):
        if loss_override is not None:
            return loss_override(params, batch)
        return model.loss_fn(params, batch, remat=remat)

    if microbatches == 1:
        def step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_of, params, batch)
            new_params, new_state = opt.update(grads, opt_state, params)
            return loss, new_params, new_state
        return step

    def step(params, opt_state, batch):
        def split(x):
            return x.reshape((microbatches, x.shape[0] // microbatches)
                             + tuple(x.shape[1:]))
        mb = {k: split(v) for k, v in batch.items()}
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                              device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for i in range(microbatches):
            loss, grads = value_and_grad(loss_of, params,
                                          {k: v[i] for k, v in mb.items()})
            gsum = _accumulate(gsum, grads)
            loss_sum = loss_sum + loss
            del grads
        grads = tree_map(
            lambda g: (g / microbatches).to(torch.bfloat16), gsum)
        del gsum
        new_params, new_state = opt.update(grads, opt_state, params)
        return loss_sum / microbatches, new_params, new_state
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


def opt_state_sharding(*args, **kwargs):
    raise NotImplementedError(_SHARDING)


def train_state_shardings(*args, **kwargs):
    raise NotImplementedError(_SHARDING)
