"""Synthetic regime-shift scenarios for evaluating the dollar-governor.

The canonical scenario flips the price vector across s* mid-trace while
the access pattern stays stationary (built from the same ingredients as
`core/trace.py`'s stand-ins: a hot set of small objects, a round-robin
working set of big objects with slow rotation, and periodic one-hit scan
bursts — the wiki-CDN pollution motif):

  * phase A, fee-dominated (s* >> all sizes): every miss costs ~f, so
    dollars = f x misses and the best policy maximizes hits — recency
    (LRU) wins, because scan bursts are cheap to re-fetch but deadly to
    frequency-blind retention of the big working set.
  * phase B, egress-dominated (s* << all sizes): a miss costs ~s*e, so
    the bill is byte-weighted and the best policy protects the big
    objects from scan bursts — GDSF wins (scan keys never outrank a
    reused big's freq x density score), while LRU re-fetches ~the whole
    big working set after every burst.

No fixed policy wins both phases; a governor that tracks the windowed
shadow panel should. `run_fixed` / `run_governed` replay the scenario on
fresh stores so realized dollars are comparable in hindsight.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.pricing import PriceVector
from repro_torch.egress.cache import ONLINE_POLICIES, EgressCache
from repro_torch.egress.store import ObjectStore
from .governor import DollarGovernor
from .window import WindowedAuditor

__all__ = ["RegimeShiftScenario", "regime_shift_scenario", "run_fixed",
           "run_governed", "FEE_HEAVY", "EGRESS_HEAVY"]

# s* = f/e = 1e7 B: every object below is fee-dominated
FEE_HEAVY = PriceVector("fee_heavy", get_fee=1e-5, egress_per_byte=1e-12)
# s* = 10 B: every object is egress-dominated
EGRESS_HEAVY = PriceVector("egress_heavy", get_fee=1e-9, egress_per_byte=1e-10)


@dataclasses.dataclass(frozen=True)
class RegimeShiftScenario:
    keys: list                 # request stream (object keys)
    sizes: dict                # key -> bytes
    flip_at: int               # request index where the price flips
    price_a: PriceVector
    price_b: PriceVector
    capacity_bytes: float

    @property
    def num_requests(self) -> int:
        return len(self.keys)

    def make_store(self) -> ObjectStore:
        store = ObjectStore(self.price_a)
        for k, s in self.sizes.items():
            store.put(k, bytes(s))
        return store


def regime_shift_scenario(n_phase: int = 3000, seed: int = 0,
                          small_bytes: int = 1024, big_bytes: int = 1 << 16,
                          n_hot_small: int = 30, hot_drift: int = 15,
                          n_big_active: int = 6,
                          rotate_every: int = 600, block: int = 450,
                          burst_len: int = 200) -> RegimeShiftScenario:
    """Two equal phases of the stationary mix; price flips at `n_phase`.

    Each `block` of requests is a steady segment (hot smalls and active
    bigs alternating) followed by `burst_len` fresh one-hit scan keys.
    Every `rotate_every` big accesses the oldest active big retires and a
    fresh one enters; `hot_drift` > 0 slides the hot-small window by that
    many objects per block (recency-driven churn that frequency-anchored
    retention tracks late).
    """
    rng = np.random.default_rng(seed)
    sizes: dict = {}
    hot_base = 0
    active = list(range(n_big_active))
    next_big = n_big_active
    big_accesses = 0
    big_rr = 0
    scan_id = 0
    keys: list = []
    total = 2 * n_phase
    while len(keys) < total:
        steady = block - burst_len
        for j in range(steady):
            if len(keys) >= total:
                break
            if j % 2 == 0:
                h = hot_base + int(rng.integers(n_hot_small))
                keys.append(f"hot{h}")
                sizes.setdefault(f"hot{h}", small_bytes)
            else:
                b = active[big_rr % n_big_active]
                big_rr += 1
                big_accesses += 1
                keys.append(f"big{b}")
                sizes.setdefault(f"big{b}", big_bytes)
                if rotate_every and big_accesses % rotate_every == 0:
                    active.pop(0)
                    active.append(next_big)
                    next_big += 1
        for _ in range(burst_len):
            if len(keys) >= total:
                break
            keys.append(f"scan{scan_id}")
            sizes[f"scan{scan_id}"] = small_bytes
            scan_id += 1
        hot_base += hot_drift
    capacity = n_big_active * big_bytes + int(1.2 * n_hot_small * small_bytes)
    return RegimeShiftScenario(keys=keys, sizes=sizes, flip_at=n_phase,
                               price_a=FEE_HEAVY, price_b=EGRESS_HEAVY,
                               capacity_bytes=float(capacity))


def _replay(sc: RegimeShiftScenario, cache: EgressCache,
            store: ObjectStore) -> None:
    for t, key in enumerate(sc.keys):
        if t == sc.flip_at:
            store.set_price(sc.price_b)
        cache.get(key)


def run_fixed(sc: RegimeShiftScenario, policy: str) -> dict:
    """Realized dollars of one fixed policy over the full scenario."""
    store = sc.make_store()
    cache = EgressCache(store, sc.capacity_bytes, policy,
                        consumer=f"fixed_{policy}")
    _replay(sc, cache, store)
    return dict(policy=policy, dollars=cache.meter.dollars,
                hits=cache.hits, misses=cache.misses,
                hit_rate=cache.hit_rate)


def run_governed(sc: RegimeShiftScenario, start_policy: str = "lfu",
                 policies: tuple = ONLINE_POLICIES, window: int = 400,
                 hysteresis: float = 0.1,
                 auditor_window: Optional[int] = None,
                 metrics=None) -> tuple[dict, DollarGovernor]:
    """Realized dollars under the governor (fresh store, same scenario)."""
    store = sc.make_store()
    cache = EgressCache(store, sc.capacity_bytes, start_policy,
                        consumer="governed", metrics=metrics)
    auditor = (WindowedAuditor(sc.capacity_bytes, window=auditor_window,
                               metrics=metrics)
               if auditor_window else None)
    gov = DollarGovernor(cache, policies=policies, window=window,
                         hysteresis=hysteresis, auditor=auditor,
                         metrics=metrics)
    _replay(sc, cache, store)
    result = dict(policy="governed", dollars=cache.meter.dollars,
                  hits=cache.hits, misses=cache.misses,
                  hit_rate=cache.hit_rate,
                  final_policy=cache.policy,
                  swaps=[(s.clock, s.old_policy, s.new_policy)
                         for s in gov.swaps])
    return result, gov
