"""xLSTM (arXiv:2405.04517) on PyTorch: alternating mLSTM / sLSTM blocks.

The port of `repro.models.xlstm`. xlstm-125m: 12 layers, d=768, 4 heads,
no separate FFN (d_ff=0) — the blocks carry their own gated up/down
projections.

  * mLSTM's full-sequence form is the paper's chunkwise-parallel form
    (chunks of 256: a decay-masked attention inside a chunk, the (C, n, m)
    state carried across chunks by a Python loop where the reference has
    `lax.scan`); decode uses the O(1)-state recurrent form.
  * sLSTM is a stabilized elementwise linear recurrence, run with
    `associative_scan` (the reference's tree) and decoded step by step.

Prefill is the reference's "stateless stress prefill": the forward pass's
last logits and a fresh decode state, which does not see the prompt.
Every decode step returns new states and leaves the ones given unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (DP_AXES, ArchConfig, ParamDef, associative_scan,
                     checkpoint_layer, constrain, embed_lookup, is_dtensor,
                     linear_recurrence, log_sigmoid, rms_norm, rows_region,
                     softmax_xent)
from .transformer import _logits

__all__ = ["param_defs", "prefill", "decode_step", "forward", "loss_fn",
           "init_state"]


def _mlstm_defs(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    return {
        "ln": ParamDef((d,), ("embed",), init="ones"),
        "wq": ParamDef((d, d), ("embed", "heads")),
        "wk": ParamDef((d, d), ("embed", "heads")),
        "wv": ParamDef((d, d), ("embed", "heads")),
        "wi": ParamDef((d, H), ("embed", None)),   # input gate (per head)
        "wf": ParamDef((d, H), ("embed", None)),   # forget gate (per head)
        "wo": ParamDef((d, d), ("heads", "embed")),
        "wog": ParamDef((d, d), ("embed", "heads")),  # output gate proj
    }


def _slstm_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "ln": ParamDef((d,), ("embed",), init="ones"),
        "wz": ParamDef((d, d), ("embed", "mlp")),
        "wi": ParamDef((d, d), ("embed", "mlp")),
        "wf": ParamDef((d, d), ("embed", "mlp")),
        "wo": ParamDef((d, d), ("embed", "mlp")),
        "wdown": ParamDef((d, d), ("mlp", "embed")),
    }


def param_defs(cfg: ArchConfig) -> dict:
    layers = []
    for l in range(cfg.num_layers):
        if l % 2 == 0:
            layers.append({"kind_mlstm": _mlstm_defs(cfg)})
        else:
            layers.append({"kind_slstm": _slstm_defs(cfg)})
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=1.0),
        "layers": layers,
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


# --------------------------- mLSTM ----------------------------------------

_MLSTM_CHUNK = 256


def _running_max(x):
    """The running max along dim 1. Where a gradient is taken, the way
    `jax.lax.cummax` differentiates it: a scan of `maximum` over the
    reference's tree, whose backward splits the cotangent evenly between
    equal operands (torch.cummax's gives all of it to one index). The
    values are the same either way."""
    if not x.requires_grad:
        return torch.cummax(x, dim=1).values
    return associative_scan(lambda l, r: (torch.maximum(l[0], r[0]),),
                            (x,), dim=1)[0]


def _mlstm_chunk(C, n, m, qb, kb, vb, fb, ib):
    """One chunk of the chunkwise-parallel form: intra-chunk decay-masked
    attention plus the carried state's contribution, and the state at the
    chunk's end. C: (B,H,hd,hd), n: (B,H,hd), m: (B,H); qb/kb/vb: (B,L,H,hd);
    fb/ib: (B,L,H). The m = -1e30 start runs through the same inf
    arithmetic as the reference (no clamping)."""
    L = qb.shape[1]
    f32 = torch.float32
    b = torch.cumsum(fb, dim=1)                 # (B, L, H) inclusive
    Ft = b[:, -1]                               # (B, H) chunk decay total
    # stabilizers
    runmax = _running_max(ib - b)                        # (B, L, H)
    m_i = torch.maximum(b + m[:, None], b + runmax)      # (B, L, H)
    # intra-chunk: D_ij = b_i - b_j + i_j - m_i  (j <= i)
    Dm = (b[:, :, None] - b[:, None, :] + ib[:, None, :]
          - m_i[:, :, None])                             # (B, L, L, H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=qb.device))
    Dexp = torch.where(causal[None, :, :, None], torch.exp(Dm), 0.0)
    scores = torch.einsum("blhd,bshd->blsh", qb, kb).to(f32) * Dexp
    inter_scale = torch.exp(b + m[:, None] - m_i)        # (B, L, H)
    num = torch.einsum("blsh,bshd->blhd", scores, vb.to(f32))
    num = num + inter_scale[..., None] * torch.einsum(
        "blhd,bhdv->blhv", qb.to(f32), C)
    # n_i = sum_j Dexp_ij k_j + inter_scale * n_prev
    n_i = torch.einsum("blsh,bshd->blhd", Dexp, kb.to(f32)) \
        + inter_scale[..., None] * n[:, None]
    den = torch.maximum(torch.abs(torch.einsum("blhd,blhd->blh",
                                               qb.to(f32), n_i)),
                        torch.exp(-m_i))
    h = num / den[..., None]
    # state update to end of chunk
    m_new = Ft + torch.maximum(m, torch.amax(ib - b, dim=1))
    w_j = torch.exp(Ft[:, None] - b + ib - m_new[:, None])   # (B, L, H)
    C_new = torch.exp(Ft + m - m_new)[..., None, None] * C + torch.einsum(
        "blh,blhd,blhv->bhdv", w_j, kb.to(f32), vb.to(f32))
    n_new = torch.exp(Ft + m - m_new)[..., None] * n + torch.einsum(
        "blh,blhd->bhd", w_j, kb.to(f32))
    return (C_new, n_new, m_new), h


def _mlstm_parallel(cfg: ArchConfig, p, x):
    """Chunkwise-parallel form (the xLSTM paper's training mode): linear in
    S with quadratic chunks. x: (B, S, d)."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    L = min(_MLSTM_CHUNK, S)
    pad = (-S) % L
    xn = rms_norm(x, p["ln"])
    q = (xn @ p["wq"]).reshape(B, S, H, hd)
    k = (xn @ p["wk"]).reshape(B, S, H, hd) / math.sqrt(hd)
    v = (xn @ p["wv"]).reshape(B, S, H, hd)
    logf = log_sigmoid((xn @ p["wf"]).to(torch.float32))  # (B,S,H)
    logi = (xn @ p["wi"]).to(torch.float32)
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
    dev = x.device
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, S + pad, L):
        sl = slice(c0, c0 + L)
        (C, n, m), h = _mlstm_chunk(C, n, m, q[:, sl], k[:, sl], v[:, sl],
                                    logf[:, sl], logi[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :S]
    h = h.to(x.dtype).reshape(B, S, d)
    og = torch.sigmoid(xn @ p["wog"])
    return (h * og) @ p["wo"]


def _mlstm_decode(cfg: ArchConfig, p, x, state):
    """Recurrent form. x: (B, 1, d); state = (C, n, m) with
    C: (B, H, hd, hd), n: (B, H, hd), m: (B, H)."""
    B, _, d = x.shape
    H = cfg.num_heads
    hd = d // H
    f32 = torch.float32
    C, n, m = state
    xn = rms_norm(x[:, 0], p["ln"])
    q = (xn @ p["wq"]).reshape(B, H, hd)
    k = (xn @ p["wk"]).reshape(B, H, hd) / math.sqrt(hd)
    v = (xn @ p["wv"]).reshape(B, H, hd)
    logf = log_sigmoid((xn @ p["wf"]).to(f32))  # (B,H)
    logi = (xn @ p["wi"]).to(f32)
    m_new = torch.maximum(logf + m, logi)
    fg = torch.exp(logf + m - m_new)[..., None]
    ig = torch.exp(logi - m_new)[..., None]
    Cf = C.to(f32)
    nf = n.to(f32)
    C_new = fg[..., None] * Cf + (ig * v.to(f32))[..., :, None] \
        * k.to(f32)[..., None, :]
    n_new = fg * nf + ig * k.to(f32)
    num = torch.einsum("bhvk,bhk->bhv", C_new, q.to(f32))
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new,
                                               q.to(f32))),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(x.dtype).reshape(B, d)
    og = torch.sigmoid(xn @ p["wog"])
    out = ((h * og) @ p["wo"])[:, None]
    return out, (C_new.to(C.dtype), n_new.to(n.dtype), m_new)


# --------------------------- sLSTM ----------------------------------------

def _slstm_scan(cfg: ArchConfig, p, x):
    """Full-sequence form: stabilized elementwise linear recurrence via
    associative_scan. x: (B, S, d)."""
    f32 = torch.float32
    xn = rms_norm(x, p["ln"])
    z = torch.tanh(xn @ p["wz"]).to(f32)
    logi = (xn @ p["wi"]).to(f32)
    logf = log_sigmoid((xn @ p["wf"]).to(f32))
    o = torch.sigmoid(xn @ p["wo"])
    # c_t = f c_{t-1} + i z ; n_t = f n_{t-1} + i   (stabilized by m_t)
    a = torch.exp(logf)  # safe: log_sigmoid <= 0 -> a in (0, 1]
    i = torch.exp(torch.clamp_max(logi, 10.0))
    # scan c_t and n_t apart, as the reference does: both share the decay
    _, c_t = associative_scan(linear_recurrence, (a, i * z), dim=1)[0:2]
    _, n_t = associative_scan(linear_recurrence, (a, i), dim=1)[0:2]
    h = (c_t / torch.clamp_min(n_t, 1e-6)).to(x.dtype)
    return (h * o) @ p["wdown"]


def _slstm_decode(cfg: ArchConfig, p, x, state):
    """state = (c, n): (B, d) each."""
    f32 = torch.float32
    c, n = state
    xn = rms_norm(x[:, 0], p["ln"])
    z = torch.tanh(xn @ p["wz"]).to(f32)
    i = torch.exp(torch.clamp_max((xn @ p["wi"]).to(f32), 10.0))
    f = torch.sigmoid((xn @ p["wf"]).to(f32))
    o = torch.sigmoid(xn @ p["wo"])
    c_new = f * c + i * z
    n_new = f * n + i
    h = (c_new / torch.clamp_min(n_new, 1e-6)).to(x.dtype)
    return ((h * o) @ p["wdown"])[:, None], (c_new, n_new)


# --------------------------- model ----------------------------------------

def _apply_layer(cfg, p, x):
    """One layer; on DTensor activations each rank runs its rows
    (`rows_region`)."""
    if is_dtensor(x):
        return rows_region(lambda p_, x_: _apply_layer(cfg, p_, x_), p, x)
    if "kind_mlstm" in p:
        return x + _mlstm_parallel(cfg, p["kind_mlstm"], x)
    return x + _slstm_scan(cfg, p["kind_slstm"], x)


def forward(cfg: ArchConfig, params, batch, *, remat: bool = True):
    """Full-sequence forward -> logits (B, S, V) in f32. With `remat`, each
    layer's activations are recomputed in the backward pass."""
    x = embed_lookup(params["embed"], batch["tokens"]).to(cfg.param_dtype)
    x = constrain(x, DP_AXES, None, None)
    for p in params["layers"]:
        if remat:
            x = checkpoint_layer(lambda p_, x_: _apply_layer(cfg, p_, x_),
                                 p, x)
        else:
            x = _apply_layer(cfg, p, x)
    x = rms_norm(x, params["ln_f"])
    return constrain(_logits(params, x), DP_AXES, None, "model")


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True):
    logits = forward(cfg, params, batch, remat=remat)
    return softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)


def init_state(cfg: ArchConfig, B: int, dtype, device=None):
    """Per-layer recurrent decode state."""
    H = cfg.num_heads
    hd = cfg.d_model // H
    states = []
    for l in range(cfg.num_layers):
        if l % 2 == 0:
            states.append((
                torch.zeros((B, H, hd, hd), dtype=dtype, device=device),
                torch.zeros((B, H, hd), dtype=dtype, device=device),
                torch.full((B, H), -1e30, dtype=torch.float32,
                           device=device)))
        else:
            states.append((
                torch.zeros((B, cfg.d_model), dtype=torch.float32,
                            device=device),
                torch.zeros((B, cfg.d_model), dtype=torch.float32,
                            device=device)))
    return states


def prefill(cfg: ArchConfig, params, batch):
    """Stateless stress prefill, as the reference's: forward for logits +
    a fresh decode state (which does not see the prompt)."""
    logits = forward(cfg, params, batch, remat=False)
    tokens = batch["tokens"]
    return logits[:, -1], init_state(cfg, tokens.shape[0], cfg.param_dtype,
                                     tokens.device)


def decode_step(cfg: ArchConfig, params, token, states, position):
    """One token through every layer's recurrent form. Returns
    (logits (B, V), new states); the states given are left as they are."""
    x = embed_lookup(params["embed"], token)[:, None].to(cfg.param_dtype)
    new_states = []
    for p, st in zip(params["layers"], states):
        x, st2 = _decode_layer(cfg, p, x, st)
        new_states.append(st2)
    x = rms_norm(x, params["ln_f"])
    return _logits(params, x)[:, 0], new_states


def _decode_layer(cfg: ArchConfig, p, x, state):
    """One layer's recurrent step; on DTensor activations each rank runs
    its rows (`rows_region`)."""
    if is_dtensor(x):
        return rows_region(lambda p_, x_, s_: _decode_layer(cfg, p_, x_, s_),
                           p, x, state)
    if "kind_mlstm" in p:
        h, st2 = _mlstm_decode(cfg, p["kind_mlstm"], x, state)
    else:
        h, st2 = _slstm_decode(cfg, p["kind_slstm"], x, state)
    return x + h, st2
