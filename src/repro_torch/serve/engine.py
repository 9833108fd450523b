"""Batched serving engine with an egress-billed prefix cache, on PyTorch.

The port of `repro.serve.engine`: decoded prefixes' KV blocks are objects
in cloud storage (billed per GET + per byte when re-fetched); a local
EgressCache with a dollar-aware policy decides which prefix KVs stay
resident. `audit()` measures the engine's realized dollar-regret against
the exact offline reference.

The engine runs prefill and greedy decode eagerly on its device (the card
unless the caller passes `device="cpu"`). Each stored prefix blob holds
one row of every layer's first cache tensor (its K cache, or a recurrent
layer's first state) in the reference's layout, dtype and byte order, so
the bill, which depends only on byte lengths and the access order, is the
reference's. Like the reference, the engine prefills tokens alone, so the
vlm and encdec families, which also need vision embeddings or frames,
raise `KeyError` there. Fleet mode (`fleet_nodes > 0`) partitions the
prefix cache across hash-sharded hosts (`repro_torch.fleet`), as the
reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import resolve_device
from repro_torch.egress.cache import EgressCache
from repro_torch.egress.store import ObjectStore
from repro_torch.fleet import Fleet
from repro_torch.models.registry import ModelApi
from repro_torch.online import DollarGovernor, MetricsRegistry, WindowedAuditor

__all__ = ["ServeEngine", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 8
    output: Optional[np.ndarray] = None


def _prefix_key(tokens: np.ndarray) -> str:
    return "prefix/" + hashlib.sha1(tokens.tobytes()).hexdigest()[:16]


class ServeEngine:
    def __init__(self, model: ModelApi, params,
                 store: Optional[ObjectStore] = None,
                 prefix_cache_bytes: float = 1 << 24,
                 policy: str = "gdsf", govern: bool = False,
                 governor_window: int = 64, hysteresis: float = 0.05,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None, events=None, fleet_nodes: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters lie on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.model = model
        self.params = params
        self.store = store or ObjectStore("gcs_internet")
        self.metrics = metrics or MetricsRegistry()
        # observability: one tracer threads through engine -> cache -> store
        # so request/cache.get/store.get spans nest; the decision event log
        # rides on the cache
        self.tracer = tracer
        self.events = events
        if tracer is not None:
            self.store.set_tracer(tracer)
        # fleet mode: partition the prefix cache across `fleet_nodes`
        # hash-sharded hosts, each with its own billing meter and shadow
        # panel, governed by quorum swaps over gossip; the single-host cache
        # and governor are replaced wholesale
        assert not (govern and fleet_nodes), \
            "govern= and fleet_nodes= are mutually exclusive governors"
        self.fleet: Optional[Fleet] = None
        self.cache: Optional[EgressCache] = None
        if fleet_nodes:
            self.fleet = Fleet(
                store=self.store, n_nodes=fleet_nodes,
                capacity_bytes=prefix_cache_bytes / fleet_nodes,
                policy=policy, window_span=4.0 * governor_window,
                max_skew=float(governor_window),
                gossip_every=governor_window,
                events=events, metrics=self.metrics)
        else:
            self.cache = EgressCache(self.store, prefix_cache_bytes, policy,
                                     consumer="serve_prefix_cache",
                                     metrics=self.metrics, tracer=tracer,
                                     events=events)
        self.governor: Optional[DollarGovernor] = None
        if govern:
            auditor = WindowedAuditor(prefix_cache_bytes,
                                      window=4 * governor_window,
                                      metrics=self.metrics)
            self.governor = DollarGovernor(
                self.cache, window=governor_window, hysteresis=hysteresis,
                auditor=auditor, metrics=self.metrics)

    # ------------------------------------------------------------------
    def _prefill_batch(self, prompts: np.ndarray):
        """Run prefill; persist each row's prefix KV to the object store so
        identical prefixes can be re-fetched (billed) or served from the
        local egress cache."""
        tokens = torch.as_tensor(prompts.astype(np.int64), device=self.device)
        logits, caches = self.model.prefill(self.params, {"tokens": tokens})
        for b in range(prompts.shape[0]):
            key = _prefix_key(prompts[b])
            if not self.store.contains(key):
                # the bytes of one row of every layer's first cache tensor
                # (its K cache, or its first state), layer after layer
                row = torch.cat([kv[0][b].reshape(-1).view(torch.uint8)
                                 for kv in caches])
                self.store.put(key, row.cpu().numpy().tobytes())
        return logits, caches

    def _span(self, name: str, **attrs):
        """Engine-level span, or a nullcontext when tracing is off."""
        if not self.tracer:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat="serve", **attrs)

    def serve(self, requests: list[Request]) -> list[Request]:
        """Batch requests of equal prompt length and decode greedily."""
        with self._span("serve.batch", requests=len(requests)):
            self._serve(requests)
        self.metrics.inc("serve.requests", len(requests))
        return requests

    def _serve(self, requests: list[Request]) -> None:
        by_len: dict[int, list[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        for _, group in sorted(by_len.items()):
            prompts = np.stack([r.prompt for r in group])
            # prefix-cache touch: hit = KV stays local, miss = billed fetch
            for r in group:
                key = _prefix_key(r.prompt)
                if self.store.contains(key):
                    with self._span("serve.request", rid=r.rid):
                        if self.fleet is not None:
                            self.fleet.access(key)
                        else:
                            self.cache.get(key)
            with self._span("serve.prefill", batch=len(group)):
                logits, caches = self._prefill_batch(prompts)
            S = prompts.shape[1]
            max_new = max(r.max_new_tokens for r in group)
            caches = _grow(self.model, caches, S + max_new)
            tok = torch.argmax(logits, -1)
            outs = [tok]
            with self._span("serve.decode", batch=len(group), steps=max_new):
                for step in range(max_new - 1):
                    logits, caches = self.model.decode_step(
                        self.params, tok, caches, S + step)
                    tok = torch.argmax(logits, -1)
                    outs.append(tok)
            gen = torch.stack(outs, 1).to(torch.int32).cpu().numpy()
            for i, r in enumerate(group):
                r.output = gen[i][:r.max_new_tokens]

    def audit(self):
        """Exact offline audit: per-host dict in fleet mode (each host's
        own partition trace), single audit otherwise."""
        if self.fleet is not None:
            return self.fleet.audits()
        return self.cache.audit()

    def governance_snapshot(self) -> dict:
        """Metrics + governor + obs state, the JSON-exportable view."""
        snap = dict(metrics=self.metrics.snapshot(),
                    store=self.store.meter.snapshot(),
                    consumers=self.store.consumer_snapshot())
        if self.governor is not None:
            snap["governor"] = self.governor.snapshot()
        if self.fleet is not None:
            snap["fleet"] = self.fleet.snapshot()
        if self.events is not None:
            snap["events"] = self.events.snapshot()
        if self.tracer:
            snap["spans"] = self.tracer.to_dicts()
        return snap


def _grow(model: ModelApi, caches, max_len: int):
    """Pad the prefill caches to `max_len` keys on the right, as the
    reference does: every cache of the dense, moe and vlm families
    (windowed ones too), whisper's self caches (its cross caches stay at
    the encoder's length); the recurrent families' states as they are."""
    family = model.cfg.family

    def pad(t):
        n = max_len - t.shape[1]
        return F.pad(t, (0, 0, 0, 0, 0, n)) if n > 0 else t

    if family in ("dense", "moe", "vlm"):
        return [(pad(k), pad(v)) for k, v in caches]
    if family == "encdec":
        return [(pad(sk), pad(sv), ck, cv) for sk, sv, ck, cv in caches]
    return caches
