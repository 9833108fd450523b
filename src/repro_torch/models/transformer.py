"""Decoder-only transformer backbone on PyTorch: dense, MoE and VLM.

The port of `repro.models.transformer` for chatglm3-6b, phi4-mini-3.8b,
mistral-nemo-12b, gemma3-4b (5:1 local:global windows), qwen2-moe-a2.7b,
kimi-k2-1t-a32b (MoE layers from `moe.py`) and the qwen2-vl-72b backbone
(M-RoPE and a stub vision prefix). Layers are per-layer parameter dicts
applied in a Python loop, as in the reference, each under
`checkpoint_layer` where the reference has `jax.checkpoint` (`forward`'s
`remat`); `loss_fn` is the reference's. The stacked layout
(`stacked_param_defs`) holds the homogeneous layer tail as one tensor a
leaf with a leading layer dim; `forward_scanned` loops over it where the
reference scans it.

Decode never writes into the caches it is given: each new key and value
goes into a new cache, as the reference's `dynamic_update_slice` builds a
new array, and a write that would run past the end starts earlier, as
there.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import (DP_AXES, ArchConfig, ParamDef, Region, apply_mrope,
                     apply_rope, attention, checkpoint_layer,
                     chunked_attention, constrain, embed_lookup, ffn,
                     is_dtensor, rms_norm, softmax_xent, tp_divides, tp_size,
                     tree_leaves, tree_map, tree_zip_map, unshard_fsdp)
from .moe import moe_ffn_apply, moe_ffn_defs

# attention score materialization is capped; larger S*K uses the chunked
# (online-softmax) path, as in the reference
_FULL_ATTN_LIMIT = 2048 * 2048


def _attn_defs(cfg: ArchConfig) -> dict:
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, H * hd), ("embed", "heads")),
        "wk": ParamDef((d, G * hd), ("embed", "kv_heads")),
        "wv": ParamDef((d, G * hd), ("embed", "kv_heads")),
        "wo": ParamDef((H * hd, d), ("heads", "embed")),
    }


def _ffn_defs(cfg: ArchConfig, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.act == "swiglu":
        return {
            "w1": ParamDef((d, d_ff), ("embed", "mlp")),
            "w3": ParamDef((d, d_ff), ("embed", "mlp")),
            "w2": ParamDef((d_ff, d), ("mlp", "embed")),
        }
    return {
        "w1": ParamDef((d, d_ff), ("embed", "mlp")),
        "w2": ParamDef((d_ff, d), ("mlp", "embed")),
    }


def layer_defs(cfg: ArchConfig, layer: int) -> dict:
    out = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": _attn_defs(cfg),
    }
    if cfg.is_moe_layer(layer):
        out["moe"] = moe_ffn_defs(cfg)
    else:
        out["ffn"] = _ffn_defs(cfg, cfg.d_ff)
    return out


def param_defs(cfg: ArchConfig) -> dict:
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=1.0),
        "layers": [layer_defs(cfg, l) for l in range(cfg.num_layers)],
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# stacked layout: the homogeneous layer tail as one tensor a leaf, with a
# leading layer dim (the reference scans it; the dry-run trains MoE giants
# and >= 48-layer models in it)
# ---------------------------------------------------------------------------

def _stack_defs(d, n):
    return tree_map(lambda pd: ParamDef((n,) + pd.shape, (None,) + pd.axes,
                                        init=pd.init, scale=pd.scale,
                                        dtype=pd.dtype), d)


def stacked_param_defs(cfg: ArchConfig) -> dict:
    """first_k_dense layers stay one by one; the homogeneous tail is
    stacked. Requires every remaining layer to share structure."""
    kinds = [cfg.is_moe_layer(l) for l in range(cfg.first_k_dense,
                                                cfg.num_layers)]
    if not all(k == kinds[0] for k in kinds):
        raise ValueError("stacked layout needs a homogeneous layer tail")
    n_tail = cfg.num_layers - cfg.first_k_dense
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=1.0),
        "head_layers": [layer_defs(cfg, l) for l in range(cfg.first_k_dense)],
        "stack": _stack_defs(layer_defs(cfg, cfg.first_k_dense), n_tail),
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None, :] \
        .expand(B, S)


def _mrope_positions(cfg: ArchConfig, B: int, S: int, device):
    """Stub M-RoPE ids (3, B, S): the vision prefix gets a (t=0, h, w)
    grid, text advances all three streams together (qwen2-vl convention,
    frontend stubbed)."""
    P = cfg.num_vision_tokens
    side = max(1, int(P ** 0.5))
    idx = torch.arange(S, device=device)
    vision = idx < P
    text = idx - P + 1
    t_ids = torch.where(vision, 0, text)
    h_ids = torch.where(vision, idx // side, text)
    w_ids = torch.where(vision, idx % side, text)
    pos3 = torch.stack([t_ids, h_ids, w_ids]).to(torch.int32)
    return pos3[:, None, :].expand(3, B, S)


def _rotate(cfg: ArchConfig, q, k, positions):
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k


def _layer_window(cfg: ArchConfig, layer: int) -> int:
    """Effective sliding window for this layer (0 = full attention)."""
    if cfg.global_every > 0:  # gemma3 local:global pattern
        return 0 if cfg.is_global_layer(layer) else cfg.window
    return cfg.window


def _write(cache, x, at: int):
    """A new cache: `cache` (B, W, ...) with x (B, S, ...) written at
    position `at` along dim 1; `cache` itself is left as it was. The start
    is taken as `dynamic_update_slice_in_dim` takes it: a negative one
    counts from the end, then it is clamped to [0, W - S], so a write that
    would run past the end lands on the last S rows."""
    W, S = cache.shape[1], x.shape[1]
    at = int(at)
    at = min(max(at + W if at < 0 else at, 0), W - S)
    out = cache.clone()
    out[:, at:at + S] = x.to(cache.dtype)
    return out


def _self_attn(cfg: ArchConfig, p, x, positions, *, layer: int, q_offset=0,
               kv_cache=None):
    """Returns (out, new_kv). kv_cache: (k, v) with layout (B, Sk, G, hd).

    Decode caches shorter than the timeline are *shift* caches (local
    windowed layers): the oldest key drops off the front and keys live at
    absolute positions q_offset-W+1..q_offset (k_offset masks the unfilled
    prefix). Any other cache is a full timeline written at q_offset.
    """
    B, S, _ = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, G, hd)
    v = (x @ p["wv"]).reshape(B, S, G, hd)
    q, k = _rotate(cfg, q, k, positions)
    window = _layer_window(cfg, layer)
    k_offset = 0
    if kv_cache is not None:
        ck, cv = kv_cache
        W = ck.shape[1]
        if S == 1 and window > 0 and W <= window:
            # shift cache: holds exactly the last W roped keys in order
            ck = torch.cat([ck[:, 1:], k.to(ck.dtype)], dim=1)
            cv = torch.cat([cv[:, 1:], v.to(cv.dtype)], dim=1)
            k_offset = int(q_offset) - W + 1
        else:
            # full cache: write at q_offset (preallocated timeline)
            ck = _write(ck, k, q_offset)
            cv = _write(cv, v, q_offset)
        k, v = ck, cv
        new_cache = (ck, cv)
    else:
        new_cache = (k, v)
    attn_fn = attention if q.shape[1] * k.shape[1] <= _FULL_ATTN_LIMIT \
        else chunked_attention
    out = attn_fn(q, k.to(q.dtype), v.to(q.dtype), causal=True,
                  window=window, q_offset=q_offset, k_offset=k_offset,
                  logit_softcap=cfg.logit_softcap)
    return out @ p["wo"], new_cache


def _attn(cfg: ArchConfig, p, x, positions, *, layer: int, q_offset=0,
          kv_cache=None):
    """`_self_attn`; on DTensor activations in a local region: each rank's
    rows, and its "model" share of the heads where that axis divides the
    kv heads (wq, wk, wv split by columns, wo by rows, the caches on their
    head dim; the heads' outputs summed on token space), else every head
    on every rank. Positions are the same for every row."""
    if not is_dtensor(x):
        return _self_attn(cfg, p, x, positions, layer=layer,
                          q_offset=q_offset, kv_cache=kv_cache)
    from torch.distributed.tensor import Partial, Replicate, Shard
    tp = tp_size(x.device_mesh)
    r = Region(x.device_mesh, x.shape[0], cfg.num_kv_heads % tp == 0)
    xl = r.enter(x, Shard(0), Replicate(), Shard(0), Partial())
    pl = {k: r.enter(p[k], Replicate(), Shard(1), Partial(), Shard(1))
          for k in ("wq", "wk", "wv")}
    pl["wo"] = r.enter(p["wo"], Replicate(), Shard(0), Partial(), Shard(0))
    cache = None if kv_cache is None else tuple(
        r.enter(c, Shard(0), Shard(2), Shard(0), Shard(2)) for c in kv_cache)
    local = cfg
    if r.tp:
        local = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                    num_kv_heads=cfg.num_kv_heads // tp,
                                    head_dim=cfg.hd)
    out, new = _self_attn(local, pl, xl, positions[..., :xl.shape[0], :],
                          layer=layer, q_offset=q_offset, kv_cache=cache)
    out = r.leave(out, Shard(0), Partial())
    return (out.redistribute(r.mesh, r.placements(Shard(0), Replicate())),
            tuple(r.leave(c, Shard(0), Shard(2)) for c in new))


def _ffn(cfg: ArchConfig, p, hin):
    """The layer's FFN; a dense one on DTensor activations in a local
    region: each rank's rows, its "model" share of d_ff where that axis
    divides it (w1 and w3 by columns, w2 by rows, summed on token
    space)."""
    if "moe" in p:
        return moe_ffn_apply(cfg, p["moe"], hin)
    f = p["ffn"]
    if not is_dtensor(hin):
        return ffn(hin, f["w1"], f.get("w3"), f["w2"], cfg.act)
    from torch.distributed.tensor import Partial, Replicate, Shard
    r = Region(hin.device_mesh, hin.shape[0],
               cfg.d_ff % tp_size(hin.device_mesh) == 0)
    xl = r.enter(hin, Shard(0), Replicate(), Shard(0), Partial())
    wl = {k: r.enter(f[k], Replicate(), Shard(1), Partial(), Shard(1))
          for k in ("w1", "w3") if k in f}
    wl["w2"] = r.enter(f["w2"], Replicate(), Shard(0), Partial(), Shard(0))
    y = r.leave(ffn(xl, wl["w1"], wl.get("w3"), wl["w2"], cfg.act),
                Shard(0), Partial())
    return y.redistribute(r.mesh, r.placements(Shard(0), Replicate()))


def _block(cfg: ArchConfig, p, x, positions, *, layer: int, q_offset=0,
           kv_cache=None):
    p = unshard_fsdp(p)
    h, new_cache = _attn(cfg, p["attn"], rms_norm(x, p["ln1"]), positions,
                         layer=layer, q_offset=q_offset, kv_cache=kv_cache)
    x = x + h
    x = x + _ffn(cfg, p, rms_norm(x, p["ln2"]))
    return x, new_cache


def _embed_inputs(cfg: ArchConfig, params, batch):
    x = embed_lookup(unshard_fsdp(params["embed"]), batch["tokens"]) \
        .to(cfg.param_dtype)
    x = constrain(x, DP_AXES, None, None)
    if cfg.num_vision_tokens > 0:
        P = cfg.num_vision_tokens
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, P:]], dim=1)
    return x


def _seq_positions(cfg: ArchConfig, B: int, S: int, device):
    return (_mrope_positions(cfg, B, S, device) if cfg.mrope_sections
            else _positions(B, S, device))


def _logits(params, x):
    """The final `x.f32 @ unembed.f32`, as the reference computes it: the
    unembed is cast to float32 on every call (no copy is kept)."""
    return x.to(torch.float32) @ unshard_fsdp(params["unembed"]).to(
        torch.float32)


def forward(cfg: ArchConfig, params, batch, *, remat: bool = True):
    """Full-sequence forward -> logits (B, S, V) in f32. With `remat`, each
    layer's activations are recomputed in the backward pass."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = _seq_positions(cfg, B, S, x.device)
    for l, p in enumerate(params["layers"]):
        if remat:
            x = checkpoint_layer(
                lambda p_, x_, pos_, _l=l: _block(cfg, p_, x_, pos_,
                                                  layer=_l)[0],
                p, x, positions)
        else:
            x, _ = _block(cfg, p, x, positions, layer=l)
    x = rms_norm(x, unshard_fsdp(params["ln_f"]))
    return constrain(_logits(params, x), DP_AXES, None, "model")


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True):
    logits = forward(cfg, params, batch, remat=remat)
    return softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)


def forward_scanned(cfg: ArchConfig, params, batch, *, remat: bool = True):
    """`forward` on the stacked layout: the head layers one by one, then
    layer i of the tail from `stack[i]` (every leaf's i-th slice), each
    under `checkpoint_layer` with `remat`, where the reference scans the
    stack under `jax.checkpoint`. Every tail layer runs as layer
    first_k_dense, as in the reference."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = _seq_positions(cfg, B, S, x.device)
    for l, p in enumerate(params["head_layers"]):
        x, _ = _block(cfg, p, x, positions, layer=l)
    rep = cfg.first_k_dense  # representative layer index for the tail

    def body(p_, x_):
        return _block(cfg, p_, x_, positions, layer=rep)[0]

    for i in range(cfg.num_layers - cfg.first_k_dense):
        p = tree_map(lambda t: t[i], params["stack"])
        x = checkpoint_layer(body, p, x) if remat else body(p, x)
    x = rms_norm(x, unshard_fsdp(params["ln_f"]))
    return constrain(_logits(params, x), DP_AXES, None, "model")


def loss_fn_scanned(cfg: ArchConfig, params, batch, *, remat: bool = True):
    logits = forward_scanned(cfg, params, batch, remat=remat)
    return softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)


def layer_fwdbwd_probe(cfg: ArchConfig, layer: int):
    """(params, x, positions) -> the gradients of sum(block(x) ** 2) in
    float32 with respect to (params, x), for ONE layer: the reference
    compiles it to recover a scanned program's per-layer cost."""
    def fn(p, x, positions):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xg = x.detach().requires_grad_(True)
        out = (_block(cfg, leaves, xg, positions, layer=layer)[0]
               .to(torch.float32) ** 2).sum()
        flat = tree_leaves(leaves) + [xg]
        grads = torch.autograd.grad(out, flat, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(flat, grads)]
        it = iter(grads[:-1])
        return tree_map(lambda _: next(it), p), grads[-1]
    return fn


def params_to_stacked(cfg: ArchConfig, params):
    """Per-layer layout -> stacked layout (a copy of the tail's leaves)."""
    tail = params["layers"][cfg.first_k_dense:]
    stack = tree_zip_map(lambda *ts: torch.stack(ts), *tail)
    return {"embed": params["embed"],
            "head_layers": params["layers"][:cfg.first_k_dense],
            "stack": stack, "ln_f": params["ln_f"],
            "unembed": params["unembed"]}


def stacked_to_params(cfg: ArchConfig, sp):
    """Stacked layout -> per-layer layout (views of the stack's rows)."""
    n = cfg.num_layers - cfg.first_k_dense
    tail = [tree_map(lambda x: x[i], sp["stack"]) for i in range(n)]
    return {"embed": sp["embed"],
            "layers": list(sp["head_layers"]) + tail,
            "ln_f": sp["ln_f"], "unembed": sp["unembed"]}


def prefill(cfg: ArchConfig, params, batch):
    """Forward + return per-layer KV caches and last-position logits.

    Windowed (local) layers keep only their last W keys as a shift cache,
    left-padded with zeros when the prompt is shorter than W."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = _seq_positions(cfg, B, S, x.device)
    tp_on_heads = tp_divides(cfg.num_kv_heads)
    caches = []
    for l, p in enumerate(params["layers"]):
        x, kv = _block(cfg, p, x, positions, layer=l)
        W = _layer_window(cfg, l)
        if W and S >= W:
            kv = (kv[0][:, S - W:], kv[1][:, S - W:])
        elif W:
            kv = (F.pad(kv[0], (0, 0, 0, 0, W - S, 0)),
                  F.pad(kv[1], (0, 0, 0, 0, W - S, 0)))
        else:
            # pin each full-timeline cache to its serving layout at once:
            # kv heads over TP where they divide it, else the sequence
            tp = (None, "model") if tp_on_heads else ("model", None)
            kv = tuple(constrain(c, DP_AXES, *tp, None) for c in kv)
        caches.append(kv)
    x = rms_norm(x[:, -1:], unshard_fsdp(params["ln_f"]))
    return _logits(params, x)[:, 0], caches


def decode_step(cfg: ArchConfig, params, token, caches, position):
    """One decode step against preallocated KV caches.

    token: (B,) int; caches: list of (k, v) each (B, S_max, G, hd), left
    as they are; position: the current write index (an int). The vlm
    family rotates all three M-RoPE streams by `position`, as the
    reference does. Returns (logits (B, V), new caches).
    """
    B = token.shape[0]
    position = int(position)
    x = embed_lookup(unshard_fsdp(params["embed"]), token)[:, None] \
        .to(cfg.param_dtype)
    shape = (3, B, 1) if cfg.mrope_sections else (B, 1)
    positions = torch.full(shape, position, dtype=torch.int32,
                           device=x.device)
    new_caches = []
    for l, p in enumerate(params["layers"]):
        p = unshard_fsdp(p)
        h, kv = _attn(cfg, p["attn"], rms_norm(x, p["ln1"]), positions,
                      layer=l, q_offset=position, kv_cache=caches[l])
        x = x + h
        x = x + _ffn(cfg, p, rms_norm(x, p["ln2"]))
        new_caches.append(kv)
    x = rms_norm(x, unshard_fsdp(params["ln_f"]))
    return _logits(params, x)[:, 0], new_caches
