"""Optimizers on PyTorch: AdamW (dtype-configurable moments), Adafactor and
SGD.

The port of `repro.train.optim`. Optimizer-state memory decides the
optimizer for a large model: float32 Adam moments take 8 bytes a
parameter, Adafactor's factored second moment a row and a column a
matrix.

API: opt = make_optimizer(cfg); state = opt.init(params);
     new_params, new_state = opt.update(grads, state, params)
Each is a pure function on trees (dicts, lists) of tensors: the caller's
tensors are never written. The update runs in float32 whatever the
storage dtype, each operation in the reference's order; `count` is an
int32 0-d tensor and the bias corrections are `b ** count` in float32.
`state_axes` maps the parameters' logical axes to the state's, as the
reference's (Adafactor's factored statistics drop an axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.common import tree_leaves, tree_map, tree_zip_map

__all__ = ["OptimizerConfig", "Optimizer", "make_optimizer"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"           # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    moment_dtype: Any = torch.float32   # bf16 halves Adam memory
    # adafactor
    factored_min_dim: int = 128
    clip_threshold: float = 1.0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimizerConfig
    init: Callable
    update: Callable
    state_axes: Callable   # param logical axes -> state logical axes tree


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _split(params, out, n: int) -> list:
    """A tree of per-leaf n-tuples (on `params`' structure) as n trees."""
    return [tree_zip_map(lambda _, t, i=i: t[i], params, out)
            for i in range(n)]


def _adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        b1c = 1 - cfg.b1 ** c.to(_F32)
        b2c = 1 - cfg.b2 ** c.to(_F32)

        def leaf(p, g, m, v):
            g = g.to(_F32)
            m32 = cfg.b1 * m.to(_F32) + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.to(_F32) + (1 - cfg.b2) * g * g
            upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
            upd = upd + cfg.weight_decay * p.to(_F32)
            newp = p.to(_F32) - cfg.lr * upd
            return (newp.to(p.dtype), m32.to(cfg.moment_dtype),
                    v32.to(cfg.moment_dtype))

        out = tree_zip_map(leaf, params, grads, state["m"], state["v"])
        newp, newm, newv = _split(params, out, 3)
        return newp, {"m": newm, "v": newv, "count": c}

    def state_axes(param_axes):
        return {"m": param_axes, "v": param_axes, "count": None}

    return Optimizer(cfg, init, update, state_axes)


def _factored(cfg: OptimizerConfig, shape) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


def _adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Adafactor without momentum (beta1=None), factored second moment."""
    def init(params):
        def leaf(p):
            shape, dev = tuple(p.shape), p.device
            if _factored(cfg, shape):
                return {"vr": torch.zeros(shape[:-1], dtype=_F32,
                                          device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          dtype=_F32, device=dev)}
            return {"v": torch.zeros(shape, dtype=_F32, device=dev)}
        return {"stats": tree_map(leaf, params), "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        beta2 = 1.0 - c.to(_F32) ** -0.8

        def leaf(p, g, st):
            g = g.to(_F32)
            g2 = g * g + 1e-30
            if "vr" in st:
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(-2)
                del g2
                denom = vr.mean(-1, keepdim=True)
                vhat = (vr[..., None] * vc[..., None, :]
                        / torch.clamp_min(denom[..., None], 1e-30))
                upd = g / torch.sqrt(torch.clamp_min(vhat, 1e-30))
                del vhat
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                del g2
                upd = g / torch.sqrt(torch.clamp_min(v, 1e-30))
                new_st = {"v": v}
            del g
            # relative RMS clipping (Adafactor eq. 6)
            rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
            upd = upd / torch.clamp_min(rms / cfg.clip_threshold, 1.0)
            newp = (p.to(_F32) - cfg.lr * upd - cfg.lr * cfg.weight_decay
                    * p.to(_F32))
            return newp.to(p.dtype), new_st

        out = tree_zip_map(leaf, params, grads, state["stats"])
        newp, news = _split(params, out, 2)
        return newp, {"stats": news, "count": c}

    def state_axes(param_axes):
        def leaf_axes(axes, p):
            if _factored(cfg, p.shape):
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}
        # needs params for shapes; resolved in the trainer where both exist
        return leaf_axes

    return Optimizer(cfg, init, update, state_axes)


def _sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params):
        newp = tree_zip_map(
            lambda p, g: (p.to(_F32) - cfg.lr * g.to(_F32)).to(p.dtype),
            params, grads)
        return newp, {"count": state["count"] + 1}

    return Optimizer(cfg, init, update, lambda axes: {"count": None})


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": _adamw, "adafactor": _adafactor, "sgd": _sgd}[cfg.name](cfg)
