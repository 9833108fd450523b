"""Whisper-large-v3 backbone (arXiv:2212.04356) on PyTorch: an
encoder-decoder transformer.

The port of `repro.models.whisper`. The conv frontend is a stub, as in the
reference: `prefill_inputs()` feeds precomputed frame embeddings
(B, S_enc, d) to the encoder, through a learned projection. Encoder:
bidirectional self-attention + GELU FFN. Decoder: causal self-attention
(RoPE standing in for Whisper's learned positions) + cross-attention into
the encoder output + GELU FFN.

decode_step takes preallocated self-attention caches and the fixed
cross-attention caches computed once by prefill from the encoder output;
it returns new self caches and leaves the ones it is given unchanged.
"""
from __future__ import annotations

import torch

from .common import (DP_AXES, ArchConfig, ParamDef, apply_rope, attention,
                     checkpoint_layer, chunked_attention, constrain,
                     embed_lookup, ffn, is_dtensor, rms_norm, rows_region,
                     softmax_xent)
from .transformer import _logits, _write

__all__ = ["param_defs", "prefill", "decode_step", "forward", "loss_fn",
           "encode"]

_FULL_ATTN_LIMIT = 2048 * 2048


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
        "w2": ParamDef((cfg.d_ff, d), ("mlp", "embed")),
    }


def param_defs(cfg: ArchConfig) -> dict:
    enc_layer = lambda: {"attn": _attn_defs(cfg), "ffn": _ffn_defs(cfg)}
    dec_layer = lambda: {"attn": _attn_defs(cfg), "cross": _attn_defs(cfg),
                         "ffn": _ffn_defs(cfg)}
    return {
        # conv frontend is a stub; a learned input projection stands in for it
        "frame_proj": ParamDef((cfg.d_model, cfg.d_model), ("embed", "mlp")),
        "enc_pos": ParamDef((8192, cfg.d_model), (None, "embed")),
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=1.0),
        "encoder": [enc_layer() for _ in range(cfg.encoder_layers)],
        "decoder": [dec_layer() for _ in range(cfg.num_layers)],
        "ln_enc": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


def _mha(cfg, p, x, kv_x, *, causal, q_offset=0, kv_cache=None,
         write_cache=False):
    """Decoder self-attention (causal=True) carries RoPE. With a cache and
    `write_cache`, the new keys go into a new copy of the self cache at
    q_offset; with a cache alone, it is the fixed cross-attention cache."""
    B, S, _ = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if causal:
        qpos = (torch.arange(S, dtype=torch.int32, device=x.device)
                + q_offset)[None].expand(B, S)
        q = apply_rope(q, qpos, cfg.rope_theta)
    if kv_cache is not None and not write_cache:
        k, v = kv_cache  # fixed cross-attention cache
    else:
        Sk = kv_x.shape[1]
        k = (kv_x @ p["wk"]).reshape(B, Sk, G, hd)
        v = (kv_x @ p["wv"]).reshape(B, Sk, G, hd)
        if causal:
            kpos = (torch.arange(Sk, dtype=torch.int32, device=x.device)
                    + q_offset)[None].expand(B, Sk)
            k = apply_rope(k, kpos, cfg.rope_theta)
        if kv_cache is not None:  # decode self-attention: write slot
            ck, cv = kv_cache
            k = _write(ck, k, q_offset)
            v = _write(cv, v, q_offset)
    fn = attention if S * k.shape[1] <= _FULL_ATTN_LIMIT \
        else chunked_attention
    out = fn(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
             q_offset=q_offset)
    return out @ p["wo"], (k, v)


def encode(cfg: ArchConfig, params, frames):
    """frames: (B, S_enc, d) stub embeddings -> encoder states. On DTensor
    frames each rank encodes its rows (`rows_region`)."""
    if is_dtensor(frames):
        enc = {k: params[k] for k in ("frame_proj", "enc_pos", "encoder",
                                      "ln_enc")}
        return rows_region(lambda p_, f_: encode(cfg, p_, f_), enc, frames)
    x = frames.to(cfg.param_dtype) @ params["frame_proj"]
    x = x + params["enc_pos"][:x.shape[1]].to(x.dtype)[None]
    for p in params["encoder"]:
        h, _ = _mha(cfg, p["attn"], rms_norm(x, p["attn"]["ln"]),
                    rms_norm(x, p["attn"]["ln"]), causal=False)
        x = x + h
        x = x + ffn(rms_norm(x, p["ffn"]["ln"]), p["ffn"]["w1"], None,
                    p["ffn"]["w2"], "gelu")
    return rms_norm(x, params["ln_enc"])


def _decoder_block(cfg, p, x, enc, q_offset=0, self_cache=None,
                   cross_cache=None):
    if is_dtensor(x):   # each rank its rows (`rows_region`)
        return rows_region(
            lambda p_, x_, e_, s_, c_: _decoder_block(cfg, p_, x_, e_,
                                                      q_offset, s_, c_),
            p, x, enc, self_cache, cross_cache)
    if enc is not None:
        # the block takes the encoder states through one node, as the
        # region does, so their gradient adds its parts in the same order
        enc = enc.view_as(enc)
    h, new_self = _mha(cfg, p["attn"], rms_norm(x, p["attn"]["ln"]),
                       rms_norm(x, p["attn"]["ln"]), causal=True,
                       q_offset=q_offset, kv_cache=self_cache,
                       write_cache=self_cache is not None)
    x = x + h
    if cross_cache is not None:
        h, _ = _mha(cfg, p["cross"], rms_norm(x, p["cross"]["ln"]), None,
                    causal=False, kv_cache=cross_cache)
    else:
        h, cross_cache = _mha(cfg, p["cross"], rms_norm(x, p["cross"]["ln"]),
                              enc, causal=False)
    x = x + h
    x = x + ffn(rms_norm(x, p["ffn"]["ln"]), p["ffn"]["w1"], None,
                p["ffn"]["w2"], "gelu")
    return x, new_self, cross_cache


def forward(cfg: ArchConfig, params, batch, *, remat: bool = True):
    """Full forward: frames (B, S_enc, d) + tokens (B, S_dec) -> logits
    (B, S_dec, V) in f32. With `remat`, each decoder layer's activations
    are recomputed in the backward pass (the encoder's are kept, as in the
    reference)."""
    enc = encode(cfg, params, batch["frames"])
    x = embed_lookup(params["embed"], batch["tokens"]).to(cfg.param_dtype)
    for p in params["decoder"]:
        if remat:
            x = checkpoint_layer(
                lambda p_, x_, e_: _decoder_block(cfg, p_, x_, e_)[0],
                p, x, enc)
        else:
            x, _, _ = _decoder_block(cfg, p, x, enc)
    x = rms_norm(x, params["ln_f"])
    return constrain(_logits(params, x), DP_AXES, None, "model")


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True):
    logits = forward(cfg, params, batch, remat=remat)
    return softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)


def prefill(cfg: ArchConfig, params, batch):
    """Encode + run the decoder prompt, returning (logits, caches) where
    caches = list of (self_k, self_v, cross_k, cross_v)."""
    enc = encode(cfg, params, batch["frames"])
    x = embed_lookup(params["embed"], batch["tokens"]).to(cfg.param_dtype)
    caches = []
    for p in params["decoder"]:
        x, self_kv, cross_kv = _decoder_block(cfg, p, x, enc)
        caches.append((self_kv[0], self_kv[1], cross_kv[0], cross_kv[1]))
    x = rms_norm(x[:, -1:], params["ln_f"])
    return _logits(params, x)[:, 0], caches


def decode_step(cfg: ArchConfig, params, token, caches, position):
    """caches: list of (self_k, self_v, cross_k, cross_v); self caches are
    preallocated (B, S_max, G, hd) and left as they are. Returns
    (logits (B, V), new caches)."""
    position = int(position)
    x = embed_lookup(params["embed"], token)[:, None].to(cfg.param_dtype)
    new_caches = []
    for p, (sk, sv, ck, cv) in zip(params["decoder"], caches):
        x, (sk2, sv2), _ = _decoder_block(cfg, p, x, None, q_offset=position,
                                          self_cache=(sk, sv),
                                          cross_cache=(ck, cv))
        new_caches.append((sk2, sv2, ck, cv))
    x = rms_norm(x, params["ln_f"])
    return _logits(params, x)[:, 0], new_caches
