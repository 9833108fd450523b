"""RecurrentGemma / Griffin (arXiv:2402.19427) on PyTorch: RG-LRU + local
attention, 1:2.

The port of `repro.models.rglru`. The layer pattern repeats (recurrent,
recurrent, local-attn). The recurrent block is: input proj -> short
temporal conv -> RG-LRU gated linear recurrence -> gated output proj.
RG-LRU:

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)           (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence with `associative_scan` (the reference's
`jax.lax.associative_scan` tree, so the same products in the same order);
decode keeps an O(1) state per layer. Local attention layers use a sliding
window (2048) and a shift cache of the last W keys. Every decode step
returns new states and caches and leaves the ones it is given unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (DP_AXES, ArchConfig, ParamDef, apply_rope,
                     associative_scan, attention, checkpoint_layer,
                     chunked_attention, constrain, embed_lookup, ffn,
                     is_dtensor, rows_region,
                     linear_recurrence, rms_norm, softmax_xent, softplus)
from .transformer import _logits, _positions, _write

__all__ = ["param_defs", "prefill", "decode_step", "forward", "loss_fn",
           "init_caches"]

_C = 8.0
_FULL_ATTN_LIMIT = 2048 * 2048


def _rec_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    w = cfg.rglru_conv_width
    return {
        "ln": ParamDef((d,), ("embed",), init="ones"),
        "wx": ParamDef((d, d), ("embed", "mlp")),
        "wy": ParamDef((d, d), ("embed", "mlp")),     # gate branch
        "conv": ParamDef((w, d), (None, "mlp")),
        "wr": ParamDef((d, d), ("embed", "mlp")),
        "wi": ParamDef((d, d), ("embed", "mlp")),
        "lam": ParamDef((d,), ("mlp",), init="normal", scale=0.5),
        "wout": ParamDef((d, d), ("mlp", "embed")),
    }


def _attn_defs(cfg: ArchConfig) -> dict:
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "ln": ParamDef((d,), ("embed",), init="ones"),
        "wq": ParamDef((d, H * hd), ("embed", "heads")),
        "wk": ParamDef((d, G * hd), ("embed", "kv_heads")),
        "wv": ParamDef((d, G * hd), ("embed", "kv_heads")),
        "wo": ParamDef((H * hd, d), ("heads", "embed")),
    }


def _ffn_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "ln": ParamDef((d,), ("embed",), init="ones"),
        "w1": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
        "w3": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
        "w2": ParamDef((cfg.d_ff, d), ("mlp", "embed")),
    }


def param_defs(cfg: ArchConfig) -> dict:
    layers = []
    for l in range(cfg.num_layers):
        blk = {"ffn": _ffn_defs(cfg)}
        if cfg.is_attn_layer(l):
            blk["attn"] = _attn_defs(cfg)
        else:
            blk["rec"] = _rec_defs(cfg)
        layers.append(blk)
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=1.0),
        "layers": layers,
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


# --------------------------- RG-LRU block ---------------------------------

def _rglru_gates(p, xn):
    r = torch.sigmoid((xn @ p["wr"]).to(torch.float32))
    i = torch.sigmoid((xn @ p["wi"]).to(torch.float32))
    log_a = -_C * softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i
    return a, gated


def _conv1d(p, x, state=None):
    """Short causal temporal conv. x: (B, S, d). state: (B, w-1, d) or None."""
    w = p["conv"].shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, w - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, k:k + x.shape[1]] * p["conv"][k] for k in range(w))
    new_state = xp[:, -(w - 1):] if w > 1 else None
    return out, new_state


def _rec_block(cfg: ArchConfig, p, x, state=None):
    """Returns (out, (h_last, conv_state))."""
    xn = rms_norm(x, p["ln"])
    u = xn @ p["wx"]
    gate = F.gelu(xn @ p["wy"], approximate="tanh")   # jax.nn.gelu's default
    conv_state = state[1] if state is not None else None
    u, new_conv = _conv1d(p, u, conv_state)
    a, gated = _rglru_gates(p, xn)
    b = gated * u.to(torch.float32)
    if x.shape[1] == 1 and state is not None:  # decode fast path
        h_prev = state[0]
        h = a[:, 0] * h_prev + b[:, 0]
        hs = h[:, None]
        h_last = h
    else:
        if state is not None:
            # seed the scan with the carried state via a virtual step
            b = torch.cat([b[:, :1] + (a[:, 0] * state[0])[:, None],
                           b[:, 1:]], dim=1)
        _, hs = associative_scan(linear_recurrence, (a, b), dim=1)[0:2]
        h_last = hs[:, -1]
    out = (hs.to(x.dtype) * gate) @ p["wout"]
    return out, (h_last, new_conv)


def _attn_block(cfg: ArchConfig, p, x, positions, q_offset=0, kv_cache=None):
    B, S, _ = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    xn = rms_norm(x, p["ln"])
    q = (xn @ p["wq"]).reshape(B, S, H, hd)
    k = (xn @ p["wk"]).reshape(B, S, G, hd)
    v = (xn @ p["wv"]).reshape(B, S, G, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        ck, cv = kv_cache
        ck = _write(ck, k, q_offset)
        cv = _write(cv, v, q_offset)
        k, v = ck, cv
        new_cache = (ck, cv)
    else:
        new_cache = (k, v)
    fn = attention if q.shape[1] * k.shape[1] <= _FULL_ATTN_LIMIT \
        else chunked_attention
    out = fn(q, k.to(q.dtype), v.to(q.dtype), causal=True,
             window=cfg.window, q_offset=q_offset)
    return out @ p["wo"], new_cache


def _attn_decode_windowed(cfg: ArchConfig, p, x, position: int, kv_cache):
    """One-token decode against a W-sized *shift* cache (oldest key drops
    off the front every step, into a new cache). Keys live at absolute
    positions position-W+1 .. position; negative positions are masked
    inside attention()."""
    B = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    xn = rms_norm(x, p["ln"])
    q = (xn @ p["wq"]).reshape(B, 1, H, hd)
    k = (xn @ p["wk"]).reshape(B, 1, G, hd)
    v = (xn @ p["wv"]).reshape(B, 1, G, hd)
    positions = torch.full((B, 1), position, dtype=torch.int32,
                           device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = kv_cache
    W = ck.shape[1]
    ck = torch.cat([ck[:, 1:], k.to(ck.dtype)], dim=1)
    cv = torch.cat([cv[:, 1:], v.to(cv.dtype)], dim=1)
    k_offset = position - W + 1
    out = attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                    window=cfg.window, q_offset=position, k_offset=k_offset)
    return out @ p["wo"], (ck, cv)


def _layer(cfg, l, p, x, positions, q_offset=0, cache=None):
    """One layer; on DTensor activations each rank runs its rows
    (`rows_region`)."""
    if is_dtensor(x):
        return rows_region(
            lambda p_, x_, pos_, c_: _layer(cfg, l, p_, x_, pos_, q_offset,
                                            c_), p, x, positions, cache)
    if "attn" in p:
        h, new_cache = _attn_block(cfg, p["attn"], x, positions,
                                   q_offset=q_offset, kv_cache=cache)
    else:
        h, new_cache = _rec_block(cfg, p["rec"], x, state=cache)
    x = x + h
    f = p["ffn"]
    x = x + ffn(rms_norm(x, f["ln"]), f["w1"], f["w3"], f["w2"], "swiglu")
    return x, new_cache


def forward(cfg: ArchConfig, params, batch, *, remat: bool = True):
    """Full-sequence forward -> logits (B, S, V) in f32. With `remat`, each
    layer's activations are recomputed in the backward pass."""
    x = embed_lookup(params["embed"], batch["tokens"]).to(cfg.param_dtype)
    x = constrain(x, DP_AXES, None, None)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for l, p in enumerate(params["layers"]):
        if remat:
            x = checkpoint_layer(
                lambda p_, x_, _l=l: _layer(cfg, _l, p_, x_, positions)[0],
                p, x)
        else:
            x, _ = _layer(cfg, l, p, x, positions)
    x = rms_norm(x, params["ln_f"])
    return constrain(_logits(params, x), DP_AXES, None, "model")


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True):
    logits = forward(cfg, params, batch, remat=remat)
    return softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)


def init_caches(cfg: ArchConfig, B: int, max_seq: int, dtype, device=None):
    """Attention layers: windowed KV cache (capped at cfg.window — the whole
    point of local attention); recurrent layers: (h, conv) state."""
    caches = []
    G, hd, d = cfg.num_kv_heads, cfg.hd, cfg.d_model
    w = cfg.rglru_conv_width
    kv_len = min(max_seq, cfg.window) if cfg.window else max_seq
    for l in range(cfg.num_layers):
        if cfg.is_attn_layer(l):
            caches.append((
                torch.zeros((B, kv_len, G, hd), dtype=dtype, device=device),
                torch.zeros((B, kv_len, G, hd), dtype=dtype, device=device)))
        else:
            caches.append((
                torch.zeros((B, d), dtype=torch.float32, device=device),
                torch.zeros((B, w - 1, d), dtype=dtype, device=device)))
    return caches


def prefill(cfg: ArchConfig, params, batch):
    x = embed_lookup(params["embed"], batch["tokens"]).to(cfg.param_dtype)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    caches = []
    W = cfg.window or S
    for l, p in enumerate(params["layers"]):
        x, c = _layer(cfg, l, p, x, positions)
        if "attn" in p:
            # keep only the last W keys as a shift cache (left-pad if short;
            # padded slots sit at negative absolute positions -> masked)
            ck, cv = c
            take = min(S, W)
            ck = ck[:, S - take:]
            cv = cv[:, S - take:]
            if take < W:
                ck = F.pad(ck, (0, 0, 0, 0, W - take, 0))
                cv = F.pad(cv, (0, 0, 0, 0, W - take, 0))
            c = (ck.to(cfg.param_dtype), cv.to(cfg.param_dtype))
        caches.append(c)
    x = rms_norm(x[:, -1:], params["ln_f"])
    return _logits(params, x)[:, 0], caches


def decode_step(cfg: ArchConfig, params, token, caches, position):
    """Window-capped decode: attention caches are shift caches of size W,
    recurrent layers carry (h, conv). Returns (logits (B, V), new caches);
    the caches given are left as they are."""
    position = int(position)
    x = embed_lookup(params["embed"], token)[:, None].to(cfg.param_dtype)
    new_caches = []
    for l, p in enumerate(params["layers"]):
        x, c = _decode_layer(cfg, p, x, position, caches[l])
        new_caches.append(c)
    x = rms_norm(x, params["ln_f"])
    return _logits(params, x)[:, 0], new_caches


def _decode_layer(cfg: ArchConfig, p, x, position: int, cache):
    """One layer of a decode step; on DTensor activations each rank runs
    its rows (`rows_region`)."""
    if is_dtensor(x):
        return rows_region(
            lambda p_, x_, c_: _decode_layer(cfg, p_, x_, position, c_),
            p, x, cache)
    if "attn" in p:
        # shift cache: always holds the last W keys in order
        h, c = _attn_decode_windowed(cfg, p["attn"], x, position, cache)
    else:
        h, c = _rec_block(cfg, p["rec"], x, state=cache)
    x = x + h
    f = p["ffn"]
    x = x + ffn(rms_norm(x, f["ln"]), f["w1"], f["w3"], f["w2"], "swiglu")
    return x, c
