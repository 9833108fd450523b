"""Unified model API on PyTorch: one ModelApi per architecture family.

The port of `repro.models.registry`. Every family exposes:
  param_defs / init                     — parameters
  forward(params, batch)                — full-sequence logits
  prefill(params, batch) -> (logits, caches)
  decode_step(params, token, caches, position)
  abstract_caches(batch_size, max_seq)  — the decode state's shapes

The dense and moe families are ported; the others raise (ROADMAP queue
1, item 7). Training (`loss_fn`) is item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import resolve_device
from . import transformer
from .common import ArchConfig, init_params

_FAMILY_MODULES = {"dense": transformer, "moe": transformer}
_NOT_PORTED = {
    "vlm": "the vlm family (M-RoPE) is ROADMAP queue 1, item 7",
    "xlstm": "the xlstm family is ROADMAP queue 1, item 7",
    "hybrid": "the hybrid (rglru) family is ROADMAP queue 1, item 7",
    "encdec": "the encdec (whisper) family is ROADMAP queue 1, item 7",
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

    # ---- steps ------------------------------------------------------------
    def forward(self, params, batch):
        return self.mod.forward(self.cfg, params, batch)

    def prefill(self, params, batch):
        return self.mod.prefill(self.cfg, params, batch)

    def decode_step(self, params, token, caches, position):
        return self.mod.decode_step(self.cfg, params, token, caches, position)

    # ---- decode cache specs -------------------------------------------------
    def abstract_caches(self, batch_size: int, max_seq: int):
        """Meta tensors of the decode state at a given cache length: windowed
        layers hold min(max_seq, window) keys, the others max_seq."""
        cfg = self.cfg
        G, hd = cfg.num_kv_heads, cfg.hd

        def kv(length):
            s = torch.empty((batch_size, length, G, hd),
                            dtype=cfg.param_dtype, device="meta")
            return (s, s)

        caches = []
        for l in range(cfg.num_layers):
            if cfg.window and (cfg.global_every <= 0
                               or not cfg.is_global_layer(l)):
                caches.append(kv(min(max_seq, cfg.window)))
            else:
                caches.append(kv(max_seq))
        return caches


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.family])
    return ModelApi(cfg, _FAMILY_MODULES[cfg.family])
