"""Mixture-of-Experts FFN on PyTorch: shared experts + routed top-k,
sort-based dispatch.

The port of `repro.models.moe` for kimi-k2 (384 routed / top-8 / 1 shared,
first layer dense) and qwen2-moe (60 routed / top-4 / 4 shared), on one
card. Tokens are routed within their row of the batch, as in the
reference: a stable sort by expert gives each (token, choice) a slot in its
expert's capacity buffer, entries past the capacity C are dropped (the
later tokens of an expert first), and the expert products run over the
(E, B*C) slot buffer. A one-token step (S = 1) gathers each token's top-k
experts' weights instead and never drops.

Where PyTorch would otherwise differ from `jnp`:

* top-k keeps the lower expert first among equal gates (`lax.top_k`'s
  rule), through a stable descending sort;
* the combine adds each token's K weighted outputs in a fixed order, the
  reference's (ascending expert id), one rounding in the activation dtype
  per add, with no atomics: the same inputs give the same bits on every
  call;
* casts follow the reference: the router product, softmax and the
  renormalisation in float32, the gates then cast to the activation dtype;
  the expert products in the parameter dtype.

On DTensor activations (a launcher mesh, `repro_torch.parallel`) the
routed experts run in a local region, the counterpart of the reference's
`shard_map` combine: each rank takes its rows (on the data-parallel axes
when they divide the batch), the router whole and its "model" slice of the
experts' f, runs the per-row dispatch above on plain tensors (DTensor has
no rule for the stable sort, the slot writes or the gathers) and the
expert products, and the tensor-parallel sum is taken once, on token space
(B, S, d), after the slot -> token combine, as the reference's psum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (DP_AXES, ArchConfig, ParamDef, Region, constrain,
                     is_dtensor)

__all__ = ["moe_ffn_defs", "moe_ffn_apply", "capacity", "route",
           "dispatch_plan"]


def moe_ffn_defs(cfg: ArchConfig) -> dict:
    d, E, fe = cfg.d_model, cfg.num_experts, cfg.d_expert or cfg.d_ff
    out = {
        "router": ParamDef((d, E), ("embed", None), dtype=torch.float32),
        "w1": ParamDef((E, d, fe), ("expert", "embed", "mlp")),
        "w3": ParamDef((E, d, fe), ("expert", "embed", "mlp")),
        "w2": ParamDef((E, fe, d), ("expert", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        fs = fe * cfg.num_shared_experts
        out["shared"] = {
            "w1": ParamDef((d, fs), ("embed", "mlp")),
            "w3": ParamDef((d, fs), ("embed", "mlp")),
            "w2": ParamDef((fs, d), ("mlp", "embed")),
        }
    return out


def capacity(cfg: ArchConfig, S: int) -> int:
    """Slots an expert has in one row of S tokens."""
    return max(1, int(S * cfg.top_k * cfg.capacity_factor / cfg.num_experts))


def route(cfg: ArchConfig, p, x):
    """x (..., d) -> the top-k gates (..., K) in x's dtype, renormalised,
    and their experts (..., K), the larger gate first and the lower expert
    first among equal gates."""
    logits = x.to(torch.float32) @ p["router"]
    gates = torch.softmax(logits, dim=-1)
    gw, gi = torch.sort(gates, dim=-1, descending=True, stable=True)
    gw, gi = gw[..., :cfg.top_k], gi[..., :cfg.top_k]
    gw = gw / torch.clamp_min(gw.sum(-1, keepdim=True), 1e-9)
    return gw.to(x.dtype), gi


def dispatch_plan(gi, C: int):
    """The sort-within-group plan for top-k choices gi (B, S, K) and C
    slots an expert: `order`, the stable sort of the row's (token, choice)
    entries by expert; `sorted_e`, their experts in that order; `keep`, the
    entries within their expert's first C; `slot`, each kept entry's slot
    (0 for a dropped one). All (B, S*K)."""
    B = gi.shape[0]
    flat_e = gi.reshape(B, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    # an entry's slot is its rank among the row's entries of its expert
    starts = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(flat_e.shape[1], device=gi.device)[None] - starts
    keep = pos < C
    return order, sorted_e, keep, torch.where(keep, pos, 0)


def _dispatch_batched(cfg: ArchConfig, p, x):
    """Route every row's tokens within the row. x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    TK = S * K
    C = capacity(cfg, S)
    dev = x.device

    gw, gi = route(cfg, p, x)                                  # (B, S, K)
    order, sorted_e, keep, slot = dispatch_plan(gi, C)
    tok_of = order // K                                        # (B, TK)
    rows = torch.arange(B, device=dev)[:, None].expand(B, TK)

    # the (E, B, C) slot buffer, one spare row at its end: dropped entries
    # land there, so each kept slot is written once, by its own entry
    at = (sorted_e * B + rows) * C + slot                      # (B, TK)
    dest = torch.where(keep, at, E * B * C)
    buf = x.new_zeros((E * B * C + 1, d))
    buf[dest.reshape(-1)] = x[rows, tok_of].reshape(TK * B, d)
    xe = buf[:-1].view(E, B * C, d)
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    out_e = torch.bmm(h, p["w2"]).view(E * B * C, d)
    gathered = torch.where(keep[..., None], out_e[at], 0)      # (B, TK, d)
    wflat = gw.reshape(B, TK).gather(-1, order)
    contrib = gathered * wflat[..., None]

    # each token's K contributions in sorted order (ascending expert), added
    # one after another as the reference's scatter-add does
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(TK, device=dev).expand(B, TK))
    mine = rank.view(B, S, K).sort(-1).values.view(B, TK)
    g = contrib.gather(1, mine[..., None].expand(B, TK, d)).view(B, S, K, d)
    y = g[:, :, 0]
    for k in range(1, K):
        y = y + g[:, :, k]
    return y


def _decode_gather(cfg: ArchConfig, p, x):
    """One-token decode path: gather the top-k experts' weights per token
    instead of dispatching tokens to experts. x: (B, 1, d)."""
    B, _, d = x.shape
    x0 = x[:, 0]
    gw, gi = route(cfg, p, x0)                                 # (B, K)
    w1g, w3g, w2g = p["w1"][gi], p["w3"][gi], p["w2"][gi]      # (B, K, ., .)
    xb = x0[:, None, None, :]                                  # (B, 1, 1, d)
    h = F.silu(torch.matmul(xb, w1g)) * torch.matmul(xb, w3g)  # (B, K, 1, f)
    hw = (h[:, :, 0] * gw[..., None]).reshape(B, 1, -1)       # (B, 1, K*f)
    y = torch.bmm(hw, w2g.reshape(B, -1, d))                   # (B, 1, d)
    return y


def _local_region(cfg: ArchConfig, p, x, fn):
    """fn(cfg, p, x) -> (B, S, d) on each rank's plain tensors, for the
    DTensor x on its mesh (`common.Region`): rows on the data-parallel
    axes when they divide B, the router whole, w1 and w3 split on "model"
    along f, w2 on "model" along f; fn's result, a partial sum over
    "model", is summed on token space. x and the router take partial
    gradients over "model" (every expert output feeds them)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    r = Region(x.device_mesh, x.shape[0], True)
    xl = r.enter(x, Shard(0), Replicate(), Shard(0), Partial())
    pl = {"router": r.enter(p["router"], Replicate(), Replicate(),
                            Partial(), Partial())}
    for name, f_dim in (("w1", 2), ("w3", 2), ("w2", 1)):
        pl[name] = r.enter(p[name], Replicate(), Shard(f_dim), Partial(),
                           Shard(f_dim))
    y = r.leave(fn(cfg, pl, xl), Shard(0), Partial())
    return y.redistribute(r.mesh, r.placements(Shard(0), Replicate()))


def moe_ffn_apply(cfg: ArchConfig, p, x):
    """x: (B, S, d). Routing groups are the rows of the batch; S == 1 takes
    the decode weight-gather path. A DTensor x runs the routed experts in
    `_local_region`."""
    fn = _decode_gather if x.shape[1] == 1 else _dispatch_batched
    if is_dtensor(x):
        y = constrain(_local_region(cfg, p, x, fn), DP_AXES, None, None)
    else:
        # the routed experts take x through one node, as `_local_region`
        # does, so x's gradient adds its parts in the same order either way
        y = fn(cfg, p, x.view_as(x))
    if "shared" in p:
        sh = p["shared"]
        y = y + (F.silu(x @ sh["w1"]) * (x @ sh["w3"])) @ sh["w2"]
    return y
