"""Frozen copies of the trace generators, list prices and policy weights
the cells use.

Copied from the port (`repro_torch.core.trace.twemcache_like`,
`wiki_cdn_like`, `_zipf_ids`; `repro_torch.core.pricing.PRICE_VECTORS`,
`miss_costs`; `repro_torch.core.policies_torch.POLICY_WEIGHTS`) so that a
later change to the program does not move the benchmark's yardstick.
`test_portbench_frozen.py` holds them equal to the program's today. numpy
only.
"""
from __future__ import annotations

import numpy as np

__all__ = ["GENERATORS", "PRICE_VECTORS", "POLICY_WEIGHTS", "miss_costs",
           "policy_weights", "twemcache_like", "wiki_cdn_like"]


def _zipf_ids(rng: np.random.Generator, n_objects: int, n_requests: int,
              alpha: float) -> np.ndarray:
    ranks = np.arange(1, n_objects + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(n_objects, size=n_requests, p=p).astype(np.int32)


def twemcache_like(n_objects: int, n_requests: int, seed: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Twitter twemcache cluster-52 stand-in: Zipf(1.0) popularity,
    lognormal sizes with an access-weighted mean of 243 B. (ids, sizes)."""
    rng = np.random.default_rng(seed)
    ids = _zipf_ids(rng, n_objects, n_requests, alpha=1.0)
    sizes = rng.lognormal(np.log(200.0), 0.8, size=n_objects)
    sizes = np.clip(sizes, 16.0, 16 * 1024.0)
    sizes *= 243.0 / sizes[ids].mean()
    return ids, np.maximum(sizes, 1.0)


def wiki_cdn_like(n_objects: int, n_requests: int, seed: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Wikipedia CDN stand-in: Pareto(1.0) sizes with a mean of 37 KB, a
    popular core of the smaller 45 % of objects and a one-hit-wonder tail
    of up to a third of the requests. (ids, sizes)."""
    rng = np.random.default_rng(seed)
    sizes = (rng.pareto(1.0, size=n_objects) + 1.0) * 2048.0
    sizes = np.clip(sizes, 256.0, 94e6)
    order = np.argsort(sizes)
    n_core = int(n_objects * 0.45)
    core_ids = order[:n_core]
    tail_ids = order[n_core:]
    n_tail_req = min(len(tail_ids), n_requests // 3)
    core_req = _zipf_ids(rng, n_core, n_requests - n_tail_req, alpha=0.85)
    parts = [core_ids[core_req].astype(np.int32),
             rng.choice(tail_ids, size=n_tail_req,
                        replace=False).astype(np.int32)]
    ids = np.concatenate(parts)
    rng.shuffle(ids)
    sizes = sizes * (37e3 / sizes[ids].mean())
    sizes = np.clip(sizes, 64.0, 94e6)
    return ids, np.maximum(sizes, 1.0)


GENERATORS = {"twemcache_like": twemcache_like,
              "wiki_cdn_like": wiki_cdn_like}

_GB = 1e9
# name -> (GET fee in $ a request, egress in $ a byte): the paper's list
# prices (June 2026)
PRICE_VECTORS = {
    "s3_internet": (0.40e-6, 0.09 / _GB),
    "s3_cross_region": (0.40e-6, 0.02 / _GB),
    "gcs_internet": (0.04e-6, 0.12 / _GB),
    "azure_internet": (0.04e-6, 0.087 / _GB),
}


def miss_costs(sizes: np.ndarray, price: str) -> np.ndarray:
    """Eq. (1), c_i = f + s_i * e, float64, for the named price vector."""
    fee, egress = PRICE_VECTORS[price]
    return fee + np.asarray(sizes, dtype=np.float64) * egress + 0.0


# name -> (w_t, w_f, w_gd, w_gdsf, w_bel, w_cb), the score weights of
# `reference.py`'s model
POLICY_WEIGHTS = {
    "lru": (1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "lfu": (1e-12, 1.0, 0.0, 0.0, 0.0, 0.0),
    "gds": (0.0, 0.0, 1.0, 0.0, 0.0, 0.0),
    "gdsf": (0.0, 0.0, 0.0, 1.0, 0.0, 0.0),
    "belady": (0.0, 0.0, 0.0, 0.0, 1.0, 0.0),
    "cost_belady": (0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
}


def policy_weights(policies) -> np.ndarray:
    """(Q, 6) float64 weights of a panel of policy names."""
    return np.array([POLICY_WEIGHTS[p] for p in policies], dtype=np.float64)
