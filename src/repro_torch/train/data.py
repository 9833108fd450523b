"""Deterministic token data pipeline with egress-cached shard fetch.

Shards are synthetic token arrays registered lazily in the ObjectStore
(regenerable from their key — no RAM cost) and fetched through an
EgressCache, so every training run produces a billed access trace the
paper's offline reference can audit (examples/train_100m.py does exactly
that). Pipeline state (shard cursor, step) is part of the checkpoint, so
restarts resume bit-identically.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.egress.cache import EgressCache
from repro_torch.egress.store import ObjectStore

__all__ = ["ShardedTokenDataset", "DataPipeline"]


def _shard_tokens(key: str, shard_tokens: int, vocab: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=shard_tokens, dtype=np.int32)


@dataclasses.dataclass
class ShardedTokenDataset:
    store: ObjectStore
    num_shards: int
    shard_tokens: int
    vocab: int
    prefix: str = "data/shard"

    def register(self):
        for i in range(self.num_shards):
            key = f"{self.prefix}-{i:05d}.npy"
            nbytes = self.shard_tokens * 4
            self.store.register_lazy(
                key, nbytes,
                lambda k=key: _shard_tokens(k, self.shard_tokens,
                                            self.vocab).tobytes())
        return self

    def shard_key(self, i: int) -> str:
        return f"{self.prefix}-{i % self.num_shards:05d}.npy"


class DataPipeline:
    """Batch iterator reading shards through the egress cache."""

    def __init__(self, dataset: ShardedTokenDataset, cache: EgressCache,
                 batch_size: int, seq_len: int):
        self.ds = dataset
        self.cache = cache
        self.batch = batch_size
        self.seq = seq_len
        self.cursor = 0        # global token cursor (checkpointed)

    # ---- checkpointable state ------------------------------------------
    def state(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, state: dict):
        self.cursor = int(state["cursor"])

    # ---- iteration --------------------------------------------------------
    def next_batch(self) -> dict:
        need = self.batch * self.seq
        out = np.empty(need, np.int32)
        got = 0
        while got < need:
            shard_i = self.cursor // self.ds.shard_tokens
            off = self.cursor % self.ds.shard_tokens
            raw = self.cache.get(self.ds.shard_key(shard_i))
            arr = np.frombuffer(raw, np.int32)
            take = min(need - got, len(arr) - off)
            out[got:got + take] = arr[off:off + take]
            got += take
            self.cursor += take
        tok = out.reshape(self.batch, self.seq)
        return {"tokens": tok, "labels": tok}