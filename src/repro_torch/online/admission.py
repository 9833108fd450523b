"""s*-aware admission: the crossover (eq. 3) as a live bypass/keep rule.

The crossover s* = f/e splits the object universe by what a miss costs:

  * s <= s*  — fee-dominated. The full GET fee is saved by any future hit
    and the object occupies almost nothing; always worth keeping.
  * s > s*   — egress-dominated. The saving scales with bytes, but so does
    the occupancy; a giant single-touch object (the wiki-CDN one-hit-wonder
    tail, DESIGN.md §7) evicts an entire working set for nothing. Such
    objects are only admitted on REUSE (second touch within the frequency
    horizon), and never when one object would consume more than
    `large_object_frac` of the cache.

The price is read through a callable so a mid-stream repricing
(`ObjectStore.set_price`) moves the admission line in real time.
"""
from __future__ import annotations

from typing import Callable, Union

from repro_torch.core.pricing import PriceVector
from repro_torch.egress.store import ObjectStore

__all__ = ["SStarAdmission"]


class SStarAdmission:
    """Plugs into `EgressCache(admission=...)` (see AdmissionController)."""

    def __init__(self, price: Union[PriceVector, Callable[[], PriceVector],
                                    ObjectStore],
                 capacity_bytes: float, large_object_frac: float = 0.5,
                 probation_above_sstar: bool = True):
        if isinstance(price, ObjectStore):
            self._price = lambda: price.price
        elif isinstance(price, PriceVector):
            self._price = lambda: price
        else:
            self._price = price
        self.capacity = float(capacity_bytes)
        self.large_object_frac = float(large_object_frac)
        self.probation_above_sstar = probation_above_sstar
        self.admitted = 0
        self.bypassed = 0

    @property
    def crossover_bytes(self) -> float:
        return self._price().crossover_bytes

    def admit(self, key: str, nbytes: int, freq: int) -> bool:
        decision = self._decide(nbytes, freq)
        if decision:
            self.admitted += 1
        else:
            self.bypassed += 1
        return decision

    def _decide(self, nbytes: int, freq: int) -> bool:
        if nbytes <= self.crossover_bytes:
            return True                       # fee-dominated: always keep
        if nbytes > self.large_object_frac * self.capacity:
            return False                      # would displace the working set
        if self.probation_above_sstar:
            return freq >= 2                  # egress-dominated: keep on reuse
        return True
