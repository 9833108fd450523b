"""Shadow-policy panel: counterfactual dollars for every online policy.

Each `ShadowCache` is a metadata-only replica of `EgressCache`'s priority
machinery (same LRU/LFU/GDS/GDSF formulas as `core/policies.py`, same
lazy-deletion heap and last-touch tiebreak) that holds sizes instead of
bytes. The panel subscribes to the live cache's `AccessEvent` stream and
replays every request against all shadows simultaneously, accruing the
dollars each policy WOULD have billed — without ever touching the
`ObjectStore`, so shadowing bills $0 of extra egress (asserted via
per-consumer meters in tests).

Miss costs come from the event (`AccessEvent.miss_cost`, priced at access
time), so a mid-stream price flip (`ObjectStore.set_price`) is reflected
in every shadow's counterfactual bill exactly as in the live one.
"""
from __future__ import annotations

import heapq

from repro_torch.egress.cache import ONLINE_POLICIES, AccessEvent

__all__ = ["ShadowCache", "ShadowPanel"]


class ShadowCache:
    """Metadata-only cache simulation: keys, sizes, priorities — no bytes."""

    def __init__(self, policy: str, capacity_bytes: float):
        assert policy in ONLINE_POLICIES, policy
        self.policy = policy
        self.capacity = float(capacity_bytes)
        self.used = 0.0
        self._sizes: dict[str, int] = {}          # resident keys -> bytes
        self._prio: dict[str, tuple[float, int]] = {}
        self._heap: list[tuple[float, int, str]] = []
        self._freq: dict[str, int] = {}
        self._inflation = 0.0
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.dollars = 0.0       # counterfactual: what this policy would bill

    def _priority(self, key: str, nbytes: int, miss_cost: float) -> float:
        dens = miss_cost / max(nbytes, 1)
        if self.policy == "lru":
            return float(self._clock)
        if self.policy == "lfu":
            return float(self._freq[key])
        if self.policy == "gds":
            return self._inflation + dens
        return self._inflation + self._freq[key] * dens  # gdsf

    def _touch(self, key: str, nbytes: int, miss_cost: float):
        pr = self._priority(key, nbytes, miss_cost)
        self._prio[key] = (pr, self._clock)
        heapq.heappush(self._heap, (pr, self._clock, key))

    def _evict_until_fits(self, need: float):
        while self.used + need > self.capacity and self._prio:
            pr, tt, key = heapq.heappop(self._heap)
            if self._prio.get(key) != (pr, tt):
                continue
            del self._prio[key]
            self.used -= self._sizes.pop(key)
            if self.policy in ("gds", "gdsf"):
                self._inflation = pr

    def access(self, key: str, nbytes: int, miss_cost: float) -> bool:
        """Replay one request; returns True on a (counterfactual) hit."""
        self._clock += 1
        freq = self._freq.get(key, 0) + 1
        self._freq[key] = freq
        if key in self._sizes:
            self.hits += 1
            # hit fast path: LRU/LFU priorities are just the clock / count —
            # skip the policy dispatch chain and the density division that
            # `_priority` would redo per hit (bench_policy_throughput
            # asserts the panel's ns/access against the generic path)
            policy = self.policy
            if policy == "lru":
                pr = float(self._clock)
            elif policy == "lfu":
                pr = float(freq)
            else:
                pr = self._priority(key, nbytes, miss_cost)
            self._prio[key] = (pr, self._clock)
            heapq.heappush(self._heap, (pr, self._clock, key))
            return True
        self.misses += 1
        self.dollars += miss_cost
        if nbytes <= self.capacity:
            self._evict_until_fits(nbytes)
            self._sizes[key] = nbytes
            self.used += nbytes
            self._touch(key, nbytes, miss_cost)
        return False

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ShadowPanel:
    """One shadow cache per policy, all driven by the same event stream."""

    def __init__(self, capacity_bytes: float,
                 policies: tuple[str, ...] = ONLINE_POLICIES):
        self.shadows = {p: ShadowCache(p, capacity_bytes) for p in policies}

    def on_event(self, ev: AccessEvent) -> None:
        for sh in self.shadows.values():
            sh.access(ev.key, ev.nbytes, ev.miss_cost)

    @property
    def policies(self) -> tuple[str, ...]:
        return tuple(self.shadows)

    def dollars(self) -> dict[str, float]:
        return {p: sh.dollars for p, sh in self.shadows.items()}

    def snapshot(self) -> dict:
        return {p: dict(dollars=sh.dollars, hits=sh.hits, misses=sh.misses,
                        hit_rate=sh.hit_rate, used=sh.used)
                for p, sh in self.shadows.items()}
