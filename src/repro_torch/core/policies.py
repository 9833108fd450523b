"""Online cache replacement policies, scored in dollars.

Reference (host/Python) implementations of the policies the paper measures:
LRU, LFU, GreedyDual-Size (GDS), GDSF, Belady (hit-rate oracle) and a
cost-aware Belady heuristic. All are prior work (Cao & Irani 1997; Belady
1966); the paper measures them against the exact dollar optimum.

Every policy is scored identically: each miss of object i adds `cost[i]`
dollars (eq. 1); objects occupy `sizes[i]` bytes of a capacity-B cache.
The batched replay in `policies_torch.py` is validated step-for-step
against these.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

import numpy as np

from .trace import Trace, next_use_indices

__all__ = ["PolicyResult", "simulate", "POLICIES", "total_cost_no_cache"]


@dataclasses.dataclass
class PolicyResult:
    policy: str
    dollars: float         # total billed cost of all misses
    misses: int
    hits: int
    evictions: int

    @property
    def requests(self) -> int:
        return self.misses + self.hits


def total_cost_no_cache(trace: Trace, costs: np.ndarray) -> float:
    return float(costs[trace.ids].sum())


class _PriorityCache:
    """Size-aware cache with a lazy-deletion heap keyed by a priority fn.

    Evicts the *smallest* (priority, last_touch, id) first — the explicit
    last-touch tiebreak keeps eviction order deterministic and identical to
    the batched replay in `policies_torch.py`. Supports GreedyDual's aging L via
    `inflation`.
    """

    def __init__(self, capacity: float):
        self.capacity = capacity
        self.used = 0.0
        self.prio: dict[int, tuple[float, int]] = {}  # i -> (priority, touch)
        self.heap: list[tuple[float, int, int]] = []
        self.inflation = 0.0  # GreedyDual "L"

    def __contains__(self, i: int) -> bool:
        return i in self.prio

    def touch(self, i: int, priority: float, t: int) -> None:
        self.prio[i] = (priority, t)
        heapq.heappush(self.heap, (priority, t, i))

    def evict_until_fits(self, need: float, sizes: np.ndarray) -> int:
        evictions = 0
        while self.used + need > self.capacity and self.prio:
            p, tt, i = heapq.heappop(self.heap)
            if self.prio.get(i) != (p, tt):
                continue  # stale heap entry
            del self.prio[i]
            self.used -= sizes[i]
            self.inflation = p  # GreedyDual aging: L := priority of victim
            evictions += 1
        return evictions

    def insert(self, i: int, priority: float, t: int, sizes: np.ndarray) -> None:
        self.prio[i] = (priority, t)
        self.used += sizes[i]
        heapq.heappush(self.heap, (priority, t, i))


def _simulate_priority(trace: Trace, costs: np.ndarray, capacity: float,
                       priority_fn: Callable, name: str,
                       use_inflation: bool) -> PolicyResult:
    """Generic priority-policy simulator.

    priority_fn(t, i, freq, inflation) -> float; eviction removes min priority.
    """
    sizes = trace.sizes
    cache = _PriorityCache(capacity)
    freq = np.zeros(trace.num_objects, dtype=np.int64)
    dollars = 0.0
    misses = hits = evictions = 0
    for t, i in enumerate(trace.ids):
        freq[i] += 1
        infl = cache.inflation if use_inflation else 0.0
        if i in cache:
            hits += 1
            cache.touch(int(i), priority_fn(t, int(i), freq, infl), t)
            continue
        misses += 1
        dollars += float(costs[i])
        if sizes[i] > capacity:
            continue  # uncacheable object: fetch-through
        evictions += cache.evict_until_fits(sizes[i], sizes)
        infl = cache.inflation if use_inflation else 0.0
        cache.insert(int(i), priority_fn(t, int(i), freq, infl), t, sizes)
    return PolicyResult(name, dollars, misses, hits, evictions)


def lru(trace: Trace, costs: np.ndarray, capacity: float) -> PolicyResult:
    return _simulate_priority(
        trace, costs, capacity,
        lambda t, i, freq, infl: float(t), "lru", use_inflation=False)


def lfu(trace: Trace, costs: np.ndarray, capacity: float) -> PolicyResult:
    # ties broken by last touch (earliest evicted) via the cache's heap key
    return _simulate_priority(
        trace, costs, capacity,
        lambda t, i, freq, infl: float(freq[i]), "lfu", use_inflation=False)


def gds(trace: Trace, costs: np.ndarray, capacity: float) -> PolicyResult:
    """GreedyDual-Size: H = L + c_i / s_i (Cao & Irani 1997)."""
    return _simulate_priority(
        trace, costs, capacity,
        lambda t, i, freq, infl: infl + costs[i] / trace.sizes[i],
        "gds", use_inflation=True)


def gdsf(trace: Trace, costs: np.ndarray, capacity: float) -> PolicyResult:
    """GDS-Frequency: H = L + f_i * c_i / s_i."""
    return _simulate_priority(
        trace, costs, capacity,
        lambda t, i, freq, infl: infl + freq[i] * costs[i] / trace.sizes[i],
        "gdsf", use_inflation=True)


def _simulate_oracle(trace: Trace, costs: np.ndarray, capacity: float,
                     value_fn: Callable, name: str) -> PolicyResult:
    """Belady-style oracle: evict the cached object with the *largest*
    value_fn(next_use, i) — for Belady that is simply the farthest next use;
    for cost-aware Belady it discounts by the dollars at stake.

    Matches the paper's eq. (2) model: the fetched object always occupies a
    slot while being served (no bypass), so eviction-to-fit is mandatory.
    """
    sizes = trace.sizes
    nxt_req = next_use_indices(trace.ids, trace.num_objects)
    cached: dict[int, int] = {}   # object -> its next use time (T = never)
    touch: dict[int, int] = {}    # object -> last touch step (tiebreak)
    used = 0.0
    dollars = 0.0
    misses = hits = evictions = 0
    for t, i in enumerate(trace.ids):
        i = int(i)
        if i in cached:
            hits += 1
            cached[i] = int(nxt_req[t])
            touch[i] = t
            continue
        misses += 1
        dollars += float(costs[i])
        if sizes[i] > capacity:
            continue  # uncacheable object: fetch-through
        while used + sizes[i] > capacity and cached:
            # evict max value; ties -> earliest-touched (matches the batched replay)
            victim = max(cached, key=lambda j: (value_fn(cached[j], j, t),
                                                -touch[j]))
            del cached[victim]
            del touch[victim]
            used -= sizes[victim]
            evictions += 1
        cached[i] = int(nxt_req[t])
        touch[i] = t
        used += sizes[i]
    return PolicyResult(name, dollars, misses, hits, evictions)


def belady(trace: Trace, costs: np.ndarray, capacity: float) -> PolicyResult:
    """Classic Belady: evict farthest-in-future (hit-rate oracle, $-scored)."""
    return _simulate_oracle(trace, costs, capacity,
                            lambda nu, i, t: float(nu), "belady")


def cost_belady(trace: Trace, costs: np.ndarray, capacity: float) -> PolicyResult:
    """Cost-aware Belady heuristic: evict the object whose retention saves the
    fewest dollars per byte-step — value = c_i / (s_i * steps_until_reuse);
    evict the largest badness = s_i * (nu - t_now) / c_i first."""
    T = trace.num_requests

    def badness(nu: int, i: int, t: int) -> float:
        if nu >= T:
            return float("inf")  # never reused: always the best victim
        gap = max(nu - t, 1)
        return trace.sizes[i] * gap / max(costs[i], 1e-30)

    return _simulate_oracle(trace, costs, capacity, badness, "cost_belady")


POLICIES: dict[str, Callable[[Trace, np.ndarray, float], PolicyResult]] = {
    "lru": lru,
    "lfu": lfu,
    "gds": gds,
    "gdsf": gdsf,
    "belady": belady,
    "cost_belady": cost_belady,
}


def simulate(policy: str, trace: Trace, costs: np.ndarray,
             capacity: float) -> PolicyResult:
    return POLICIES[policy](trace, costs, capacity)
