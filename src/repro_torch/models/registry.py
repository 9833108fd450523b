"""Unified model API on PyTorch: one ModelApi per architecture family.

The port of `repro.models.registry`. Every family exposes:
  param_defs / init                     — parameters
  abstract / axes                       — meta tensors of the parameters
                                          and their logical axes
  loss_fn(params, batch, remat=True)    — training loss (per-layer remat)
  forward(params, batch, remat=False)   — full-sequence logits
  prefill(params, batch) -> (logits, caches)
  decode_step(params, token, caches, position) — new caches; the caches
                                          given are left unchanged
  train_inputs(batch_size, seq_len)     — the training batch's shapes
  prefill_inputs(batch_size, seq_len)   — the prefill batch's shapes
  abstract_caches(batch_size, max_seq)  — the decode state's shapes

All six families are ported, for serving and for training
(`repro_torch.train`); `abstract` and `axes` feed the sharding rules
(`repro_torch.parallel`) and the dry-run (`repro_torch.launch`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import resolve_device
from . import rglru, transformer, whisper, xlstm
from .common import ArchConfig, abstract_params, axes_tree, init_params

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "xlstm": xlstm,
    "hybrid": rglru,
    "encdec": whisper,
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    mod: Any

    # ---- parameters -------------------------------------------------------
    def param_defs(self):
        return self.mod.param_defs(self.cfg)

    def init(self, seed_or_generator, device=None):
        """Random parameters from a seed (on `device`, the card unless the
        caller names one) or from a torch.Generator (on its device)."""
        if isinstance(seed_or_generator, torch.Generator):
            gen = seed_or_generator
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(seed_or_generator))
        return init_params(self.param_defs(), gen, self.cfg.param_dtype,
                           device)

    def abstract(self):
        """Meta tensors of the parameter tree (shapes and dtypes)."""
        return abstract_params(self.param_defs(), self.cfg.param_dtype)

    def axes(self):
        """The parameter tree's logical axes, one tuple a leaf."""
        return axes_tree(self.param_defs())

    # ---- steps ------------------------------------------------------------
    def loss_fn(self, params, batch, remat: bool = True):
        return self.mod.loss_fn(self.cfg, params, batch, remat=remat)

    def forward(self, params, batch, remat: bool = False):
        return self.mod.forward(self.cfg, params, batch, remat=remat)

    def prefill(self, params, batch):
        return self.mod.prefill(self.cfg, params, batch)

    def decode_step(self, params, token, caches, position):
        return self.mod.decode_step(self.cfg, params, token, caches, position)

    # ---- inputs ------------------------------------------------------------
    def train_inputs(self, batch_size: int, seq_len: int):
        """Meta tensors of a training batch: tokens and labels, and the vlm
        family's vision embeddings or whisper's min(seq_len, 4096) frames
        (the stub frontends)."""
        cfg = self.cfg
        specs = {"tokens": _meta((batch_size, seq_len), torch.int32),
                 "labels": _meta((batch_size, seq_len), torch.int32)}
        if cfg.family == "vlm":
            specs["vision_embeds"] = _meta(
                (batch_size, cfg.num_vision_tokens, cfg.d_model),
                cfg.param_dtype)
        if cfg.family == "encdec":
            specs["frames"] = _meta(
                (batch_size, min(seq_len, 4096), cfg.d_model),
                cfg.param_dtype)
        return specs

    def prefill_inputs(self, batch_size: int, seq_len: int):
        """Meta tensors of a prefill batch: tokens, and the vlm family's
        vision embeddings or whisper's 1500 frames (the stub frontends)."""
        cfg = self.cfg
        specs = {"tokens": _meta((batch_size, seq_len), torch.int32)}
        if cfg.family == "vlm":
            specs["vision_embeds"] = _meta(
                (batch_size, cfg.num_vision_tokens, cfg.d_model),
                cfg.param_dtype)
        if cfg.family == "encdec":
            specs["frames"] = _meta((batch_size, 1500, cfg.d_model),
                                    cfg.param_dtype)
        return specs

    # ---- decode cache specs -------------------------------------------------
    def abstract_caches(self, batch_size: int, max_seq: int):
        """Meta tensors of the decode state at a given cache length, with
        the reference's shapes and dtypes: windowed layers hold
        min(max_seq, window) keys, the others max_seq; recurrent layers
        their states; whisper's cross caches the 1500 encoder frames."""
        cfg = self.cfg
        dt = cfg.param_dtype
        G, hd, d = cfg.num_kv_heads, cfg.hd, cfg.d_model

        def kv(length):
            s = _meta((batch_size, length, G, hd), dt)
            return (s, s)

        caches = []
        if cfg.family == "xlstm":
            H = cfg.num_heads
            hd2 = d // H
            for l in range(cfg.num_layers):
                if l % 2 == 0:
                    caches.append((_meta((batch_size, H, hd2, hd2), dt),
                                   _meta((batch_size, H, hd2), dt),
                                   _meta((batch_size, H), torch.float32)))
                else:
                    caches.append((_meta((batch_size, d), torch.float32),
                                   _meta((batch_size, d), torch.float32)))
        elif cfg.family == "hybrid":
            w = cfg.rglru_conv_width
            kv_len = min(max_seq, cfg.window) if cfg.window else max_seq
            for l in range(cfg.num_layers):
                if cfg.is_attn_layer(l):
                    caches.append(kv(kv_len))
                else:
                    caches.append((_meta((batch_size, d), torch.float32),
                                   _meta((batch_size, w - 1, d), dt)))
        elif cfg.family == "encdec":
            for _ in range(cfg.num_layers):
                sk, sv = kv(max_seq)
                ck, cv = kv(1500)
                caches.append((sk, sv, ck, cv))
        else:
            for l in range(cfg.num_layers):
                if cfg.window and (cfg.global_every <= 0
                                   or not cfg.is_global_layer(l)):
                    caches.append(kv(min(max_seq, cfg.window)))
                else:
                    caches.append(kv(max_seq))
        return caches


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def get_model(cfg: ArchConfig) -> ModelApi:
    return ModelApi(cfg, _FAMILY_MODULES[cfg.family])
