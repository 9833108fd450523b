"""Online egress cache: the paper's policies as a deployable component.

Sits between compute and the ObjectStore. Pluggable policy (LRU / LFU /
GDS / GDSF — the online subset of core/policies.py), byte-capacity budget,
billing-faithful accounting, and an `audit()` that replays the observed
access trace against the exact offline dollar-optimum (core/opt_exact,
cost-FOO) — the framework-native use of the paper's reference.

Governance surface (DESIGN.md §8): every access emits an `AccessEvent` to
registered listeners (the shadow panel / windowed audit / metrics of
`repro.online` subscribe here without touching the billed path);
`set_policy` hot-swaps the replacement policy in place, preserving cache
contents so a swap never re-bills; an optional admission controller can
veto insertions (fetch-through, the s*-aware bypass of eq. 3).

Observability surface (DESIGN.md §9), all duck-typed so this layer never
imports `repro.obs`: `tracer` gets one `cache.get` span per access (the
billed `store.get` span nests inside it on a miss); `events` gets one
decision event per hit/miss/admit/reject/evict/policy_swap with its
dollar delta; `metrics.observe_hist` (when present) gets log-bucketed
object-size (centered on s*) and per-GET-dollar histograms. All three
default to None and cost one branch when absent.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Optional, Protocol

import numpy as np

from repro_torch.core import (Trace, cost_foo, exact_opt_uniform,
                        exact_opt_uniform_sweep, heterogeneity, regret)
from .store import ObjectStore

__all__ = ["EgressCache", "AuditReport", "AccessEvent", "AdmissionController",
           "ONLINE_POLICIES"]

ONLINE_POLICIES = ("lru", "lfu", "gds", "gdsf")

_cache_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class AccessEvent:
    """One cache access, as seen by governance listeners (shadow panel,
    windowed audit, metrics). Carries everything a metadata-only replica
    needs — no object bytes, no store traffic.

    `event_time` is the access's position on the *event-time* axis (a fleet
    replaying a partitioned trace stamps the global trace index here, so
    windows align across hosts despite skewed arrival); it defaults to the
    cache-local clock when the caller doesn't provide one."""
    key: str
    nbytes: int
    hit: bool
    miss_cost: float   # c = f + s*e at the price in effect NOW
    policy: str
    clock: int
    event_time: float = -1.0   # filled with float(clock) when not supplied


class AdmissionController(Protocol):
    def admit(self, key: str, nbytes: int, freq: int) -> bool:
        """True = insert into the cache; False = serve fetch-through."""
        ...


@dataclasses.dataclass
class AuditReport:
    policy: str
    observed_dollars: float
    opt_dollars_lower: float     # exact (uniform) or cost-FOO lower bound
    opt_dollars_upper: float
    dollar_regret: float         # vs the lower bound (conservative)
    heterogeneity: float
    crossover_bytes: float
    mean_object_bytes: float
    requests: int
    hit_rate: float
    # exact OPT-dollars per budget when a grid was requested (uniform sizes):
    opt_by_budget: Optional[dict[int, float]] = None

    def summary(self) -> str:
        return (f"[egress audit] policy={self.policy} "
                f"$={self.observed_dollars:.6f} "
                f"OPT in [{self.opt_dollars_lower:.6f}, "
                f"{self.opt_dollars_upper:.6f}] "
                f"regret={self.dollar_regret:.3f} H={self.heterogeneity:.3f} "
                f"s*={self.crossover_bytes:.0f}B "
                f"mean_obj={self.mean_object_bytes:.0f}B "
                f"hit_rate={self.hit_rate:.3f}")


class EgressCache:
    """Byte-budgeted local cache over an ObjectStore, dollar-aware.

    Bills through its OWN consumer meter (`store.meter_for(consumer)`), so
    `audit()` scores exactly the misses this cache caused — other consumers
    sharing the store (warm-up puts, sibling caches) never pollute it.
    """

    def __init__(self, store: ObjectStore, capacity_bytes: float,
                 policy: str = "gdsf", consumer: Optional[str] = None,
                 admission: Optional[AdmissionController] = None,
                 metrics=None, tracer=None, events=None):
        assert policy in ONLINE_POLICIES, policy
        self.store = store
        self.capacity = float(capacity_bytes)
        self.policy = policy
        self.consumer = consumer or f"egress_cache_{next(_cache_counter)}"
        self.meter = store.meter_for(self.consumer)
        self.admission = admission
        self.metrics = metrics           # duck-typed: .inc(name, value=1)
        self.tracer = tracer             # duck-typed: .span(name, cat, **a)
        self.events = events             # duck-typed: .record(kind, ...)
        # precomputed publishing surface (hot path stays branch-cheap)
        self._observe_hist = getattr(metrics, "observe_hist", None)
        self._m_hits = f"egress.{self.consumer}.hits"
        self._m_misses = f"egress.{self.consumer}.misses"
        self._m_bytes = f"egress.{self.consumer}.bytes_fetched"
        self._m_size_hist = f"egress.{self.consumer}.object_bytes"
        self._m_dollar_hist = f"egress.{self.consumer}.get_dollars"
        # size buckets centered on s* at attach time (octaves of 2; the s*
        # boundary itself is a bucket bound, so counts at/below it are the
        # fee-dominated accesses)
        sstar = store.price.crossover_bytes
        self._size_bounds = [sstar * 2.0 ** k for k in range(-8, 9)]
        self.used = 0.0
        self._data: dict[str, bytes] = {}
        self._prio: dict[str, tuple[float, int]] = {}
        self._heap: list[tuple[float, int, str]] = []
        self._freq: dict[str, int] = {}
        self._inflation = 0.0
        self._clock = 0
        self._listeners: list[Callable[[AccessEvent], None]] = []
        # access log for offline audit
        self._trace_keys: list[str] = []
        self.hits = 0
        self.misses = 0
        self.policy_swaps = 0
        self.bypasses = 0

    # ------------------------------------------------------------------
    def add_listener(self, fn: Callable[[AccessEvent], None]) -> None:
        self._listeners.append(fn)

    def _miss_cost(self, nbytes: int) -> float:
        # scalar fast path; reads store.price on every call so a mid-stream
        # `set_price` reprices immediately (bit-equal to miss_cost(nbytes))
        return self.store.price.miss_cost_scalar(nbytes)

    def _priority(self, key: str, nbytes: int) -> float:
        dens = self._miss_cost(nbytes) / max(nbytes, 1)
        if self.policy == "lru":
            return float(self._clock)
        if self.policy == "lfu":
            return float(self._freq[key])
        if self.policy == "gds":
            return self._inflation + dens
        return self._inflation + self._freq[key] * dens  # gdsf

    def _touch(self, key: str, nbytes: int):
        pr = self._priority(key, nbytes)
        self._prio[key] = (pr, self._clock)
        heapq.heappush(self._heap, (pr, self._clock, key))

    def _evict_until_fits(self, need: float):
        while self.used + need > self.capacity and self._prio:
            pr, tt, key = heapq.heappop(self._heap)
            if self._prio.get(key) != (pr, tt):
                continue
            del self._prio[key]
            data = self._data.pop(key)
            self.used -= len(data)
            if self.policy in ("gds", "gdsf"):
                self._inflation = pr
            if self.events is not None:
                # bills nothing now; at stake = the re-fetch cost if touched
                self.events.record("evict", key, len(data), 0.0,
                                   self._miss_cost(len(data)), self._clock,
                                   self.policy)

    # ------------------------------------------------------------------
    def set_policy(self, policy: str) -> None:
        """Hot-swap the replacement policy, preserving cache contents.

        Priorities of resident objects are recomputed under the new policy
        and the heap rebuilt; nothing is evicted or refetched, so the swap
        itself bills $0 (asserted in tests/test_serve_billing.py)."""
        assert policy in ONLINE_POLICIES, policy
        if policy == self.policy:
            return
        self.policy = policy
        self._inflation = 0.0
        self._heap = []
        for key, data in self._data.items():
            pr = self._priority(key, len(data))
            touch = self._prio[key][1]
            self._prio[key] = (pr, touch)
            heapq.heappush(self._heap, (pr, touch, key))
        self.policy_swaps += 1
        if self.metrics is not None:
            self.metrics.inc(f"egress.{self.consumer}.policy_swaps")
        if self.events is not None:
            self.events.record("policy_swap", "", 0, 0.0, 0.0, self._clock,
                               policy)

    # ------------------------------------------------------------------
    def get(self, key: str, event_time: Optional[float] = None) -> bytes:
        t = self.tracer
        if not t:
            return self._lookup(key, event_time)
        sp = t.begin("cache.get", "cache")
        try:
            h0 = self.hits
            data = self._lookup(key, event_time)
            sp.attrs = {"key": key, "bytes": len(data),
                        "hit": self.hits > h0, "policy": self.policy}
            return data
        finally:
            t.end(sp)

    def _lookup(self, key: str, event_time: Optional[float] = None) -> bytes:
        self._clock += 1
        self._trace_keys.append(key)
        self._freq[key] = self._freq.get(key, 0) + 1
        if key in self._data:
            self.hits += 1
            data = self._data[key]
            self._touch(key, len(data))
            self._emit(key, len(data), True, event_time)
            return data
        self.misses += 1
        data = self.store.get(key, consumer=self.consumer)   # billed fetch
        nbytes = len(data)
        admit = nbytes <= self.capacity
        if admit and self.admission is not None:
            admit = self.admission.admit(key, nbytes, self._freq[key])
            if not admit:
                self.bypasses += 1
        if admit:
            self._evict_until_fits(nbytes)
            self._data[key] = data
            self.used += nbytes
            self._touch(key, nbytes)
        self._emit(key, nbytes, False, event_time)
        if self.events is not None:
            self.events.record("admit" if admit else "reject", key, nbytes,
                               0.0, self._miss_cost(nbytes), self._clock,
                               self.policy)
        return data

    def _emit(self, key: str, nbytes: int, hit: bool,
              event_time: Optional[float] = None) -> None:
        mc = None
        if self.metrics is not None:
            self.metrics.inc(self._m_hits if hit else self._m_misses)
            if not hit:
                self.metrics.inc(self._m_bytes, nbytes)
            if self._observe_hist is not None:
                self._observe_hist(self._m_size_hist, nbytes,
                                   bounds=self._size_bounds)
                if not hit:
                    mc = self._miss_cost(nbytes)
                    self._observe_hist(self._m_dollar_hist, mc)
        if self.events is not None or self._listeners:
            if mc is None:
                mc = self._miss_cost(nbytes)
            if self.events is not None:
                self.events.record("hit" if hit else "miss", key, nbytes,
                                   0.0 if hit else mc, mc, self._clock,
                                   self.policy)
            if self._listeners:
                ev = AccessEvent(key, nbytes, hit, mc, self.policy,
                                 self._clock,
                                 float(self._clock) if event_time is None
                                 else float(event_time))
                for fn in self._listeners:
                    fn(ev)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    # ------------------------------------------------------------------
    def audit(self, budget_pages: Optional[int] = None,
              budget_grid=None) -> AuditReport:
        """Replay the observed trace against the exact offline reference.

        `budget_grid` (uniform sizes only): exact OPT-dollars for every
        budget in the grid from ONE warm-started parametric SSP run
        (`exact_opt_uniform_sweep`, DESIGN.md §5.2), reported in
        `opt_by_budget`; the bracket itself still refers to this cache's
        own budget. Observed dollars come from this cache's consumer meter
        — traffic other consumers billed on the shared store is excluded.
        """
        keys = self._trace_keys
        uniq = {k: i for i, k in enumerate(dict.fromkeys(keys))}
        ids = np.array([uniq[k] for k in keys], np.int32)
        sizes = np.zeros(len(uniq))
        for k, i in uniq.items():
            sizes[i] = self.store.size_of(k)
        costs = self.store.price.miss_cost(sizes)
        tr = Trace(ids=ids, sizes=sizes, name="egress_audit")
        uniform = len(set(sizes.tolist())) == 1
        opt_by_budget = None
        if uniform:
            B = budget_pages or max(1, int(self.capacity // sizes[0]))
            if budget_grid is not None:
                grid = np.unique(np.append(np.asarray(budget_grid, np.int64),
                                           B))
                sweep = exact_opt_uniform_sweep(ids, costs, grid)
                opt_by_budget = {int(b): float(d)
                                 for b, d in zip(sweep.budgets, sweep.dollars)}
                lower = upper = opt_by_budget[int(B)]
            else:
                o = exact_opt_uniform(ids, costs, B)
                lower = upper = o.dollars
        else:
            r = cost_foo(tr, costs, self.capacity)
            lower, upper = r.lower, r.upper
        # this cache's own bill — NOT the store-wide meter
        observed = float(self.meter.dollars)
        return AuditReport(
            policy=self.policy, observed_dollars=observed,
            opt_dollars_lower=lower, opt_dollars_upper=upper,
            dollar_regret=regret(observed, lower),
            heterogeneity=heterogeneity(ids, costs),
            crossover_bytes=self.store.price.crossover_bytes,
            mean_object_bytes=float(sizes[ids].mean()),
            requests=len(keys), hit_rate=self.hit_rate,
            opt_by_budget=opt_by_budget)
