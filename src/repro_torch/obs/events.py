"""Decision event log: every cache decision, with its dollar delta.

`EgressCache` publishes one `DecisionEvent` per decision — hit / miss /
admit / reject / evict / policy_swap — through a duck-typed publisher
(anything with `.record(kind, ...)`; the egress layer never imports this
module). `EventLog` is the concrete publisher: a bounded ring buffer
(`collections.deque(maxlen=...)`) plus per-kind counts and dollar totals
that survive ring eviction. The ring holds plain tuples (a `DecisionEvent`
is materialized lazily on read) and the totals are O(1) running sums
accumulated in the same order, with the same naive IEEE-754 addition, as
`BillingMeter` accrues its own dollars — so the lifetime `miss` total is
bit-equal to what the meter billed, with bounded memory.

Dollar semantics (DESIGN.md §9):
  * `dollar_delta`   — dollars actually billed by this event: the miss
    cost on a `miss`, 0.0 for every other kind (hits, evictions and
    swaps bill nothing *now*).
  * `dollars_at_stake` — the object's miss cost c = f + s*e at the
    decision: what a `hit` saved, what a `reject`/`evict` re-exposes on
    the next touch, what an `admit` shields. Uniform across kinds so
    event streams can be integrated either way.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import pathlib
from typing import Optional

__all__ = ["DecisionEvent", "EventLog", "EVENT_KINDS"]


EVENT_KINDS = ("hit", "miss", "admit", "reject", "evict", "policy_swap")


@dataclasses.dataclass(frozen=True, slots=True)
class DecisionEvent:
    kind: str
    key: str
    nbytes: int
    dollar_delta: float       # billed by this event (miss cost on a miss)
    dollars_at_stake: float   # the object's miss cost at decision time
    clock: int                # cache clock at the decision
    policy: str               # policy in effect (new policy on policy_swap)


class EventLog:
    """Ring-buffered decision log with lifetime per-kind accounting."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        # ring of raw field tuples; DecisionEvent is built lazily on read
        self._ring: collections.deque[tuple] = collections.deque(
            maxlen=self.capacity)
        self.counts: dict[str, int] = {k: 0 for k in EVENT_KINDS}
        self._dollar_delta: dict[str, float] = {}
        self._at_stake: dict[str, float] = {}
        self.recorded = 0

    # ---- publishing (the duck-typed surface EgressCache calls) ------------
    def record(self, kind: str, key: str, nbytes: int, dollar_delta: float,
               dollars_at_stake: float, clock: int, policy: str) -> None:
        self._ring.append((kind, key, nbytes, dollar_delta,
                           dollars_at_stake, clock, policy))
        counts = self.counts
        counts[kind] = counts.get(kind, 0) + 1
        dd = self._dollar_delta
        dd[kind] = dd.get(kind, 0.0) + dollar_delta
        ds = self._at_stake
        ds[kind] = ds.get(kind, 0.0) + dollars_at_stake
        self.recorded += 1

    # ---- reading ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._ring)

    def events(self, kind: Optional[str] = None) -> list[DecisionEvent]:
        if kind is None:
            return [DecisionEvent(*t) for t in self._ring]
        return [DecisionEvent(*t) for t in self._ring if t[0] == kind]

    def dollars_billed(self, kind: Optional[str] = None) -> float:
        """Lifetime billed dollars (all events ever recorded, not just the
        ring window). Accumulated in meter order with meter arithmetic, so
        `dollars_billed("miss")` equals the consumer's `BillingMeter`
        total exactly."""
        if kind is not None:
            return self._dollar_delta.get(kind, 0.0)
        return math.fsum(self._dollar_delta.values())

    def dollars_at_stake(self, kind: str) -> float:
        return self._at_stake.get(kind, 0.0)

    def snapshot(self) -> dict:
        fields = ("kind", "key", "nbytes", "dollar_delta",
                  "dollars_at_stake", "clock", "policy")
        return dict(
            capacity=self.capacity,
            recorded=self.recorded,
            dropped=self.dropped,
            counts=dict(self.counts),
            dollars_billed=dict(self._dollar_delta),
            dollars_at_stake=dict(self._at_stake),
            window=[dict(zip(fields, t)) for t in self._ring],
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def write_json(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path
