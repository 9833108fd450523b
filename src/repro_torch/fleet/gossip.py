"""In-process gossip fabric with injectable faults (DESIGN.md §10).

`SimNetwork` is a deterministic message switch between named participants:
`send(src, dst, frame)` enqueues an opaque wire frame, `deliver()` advances
one round and returns everything due. Faults are injected per frame from a
seeded RNG, so every failure scenario replays exactly:

  * drop       — the frame silently disappears (probability per frame)
  * duplicate  — the frame is enqueued twice
  * reorder    — the frame's delivery order within its round is randomized
                 instead of FIFO
  * delay      — delivery is postponed up to `max_delay` extra rounds

`GossipState` is each participant's merged view of the fleet's window
evidence: a map (host, window_id) -> highest-seq `WindowDelta`. Merging is
idempotent and commutative — duplicates and reordering cannot change the
converged state, and drops heal because every round re-broadcasts full
state (anti-entropy). Convergence is therefore "all participants share the
same digest", which the fleet's `flush()` drives to a fixpoint and the
fault-injection tests assert under drop+duplicate+reorder together.

Fleet-wide per-policy dollar totals are `fsum`s over the merged deltas, so
every converged participant computes the identical total.
"""
from __future__ import annotations

import heapq
import math
import random

from .wire import WindowDelta

__all__ = ["SimNetwork", "GossipState"]


class SimNetwork:
    """Deterministic fault-injecting switch for wire frames."""

    def __init__(self, seed: int = 0, drop: float = 0.0,
                 duplicate: float = 0.0, reorder: float = 0.0,
                 max_delay: int = 0):
        assert 0.0 <= drop < 1.0 and 0.0 <= duplicate <= 1.0
        assert 0.0 <= reorder <= 1.0 and max_delay >= 0
        self.rng = random.Random(seed)
        self.drop = drop
        self.duplicate = duplicate
        self.reorder = reorder
        self.max_delay = int(max_delay)
        self.round = 0
        self._heap: list[tuple] = []   # (due_round, order_key, n, src, dst, frame)
        self._n = 0
        self.sent = 0
        self.delivered = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.delayed = 0

    def send(self, src: str, dst: str, frame: bytes) -> None:
        self.sent += 1
        if self.drop and self.rng.random() < self.drop:
            self.dropped += 1
            return
        copies = 1
        if self.duplicate and self.rng.random() < self.duplicate:
            self.duplicated += 1
            copies = 2
        for _ in range(copies):
            self._enqueue(src, dst, frame)

    def _enqueue(self, src: str, dst: str, frame: bytes) -> None:
        due = self.round + 1
        if self.max_delay:
            extra = self.rng.randint(0, self.max_delay)
            if extra:
                self.delayed += 1
                due += extra
        if self.reorder and self.rng.random() < self.reorder:
            self.reordered += 1
            order_key = self.rng.random()      # jumps the FIFO queue
        else:
            order_key = 1.0 + self._n          # FIFO within the round
        heapq.heappush(self._heap, (due, order_key, self._n, src, dst, frame))
        self._n += 1

    def deliver(self) -> list[tuple[str, str, bytes]]:
        """Advance one round; returns due frames as (dst, src, frame)."""
        self.round += 1
        out = []
        while self._heap and self._heap[0][0] <= self.round:
            _, _, _, src, dst, frame = heapq.heappop(self._heap)
            out.append((dst, src, frame))
            self.delivered += 1
        return out

    @property
    def in_flight(self) -> int:
        return len(self._heap)

    def snapshot(self) -> dict:
        return dict(round=self.round, sent=self.sent,
                    delivered=self.delivered, dropped=self.dropped,
                    duplicated=self.duplicated, reordered=self.reordered,
                    delayed=self.delayed, in_flight=self.in_flight,
                    faults=dict(drop=self.drop, duplicate=self.duplicate,
                                reorder=self.reorder,
                                max_delay=self.max_delay))


class GossipState:
    """Merged window evidence: (host, window_id) -> highest-seq delta."""

    def __init__(self):
        self.deltas: dict[tuple[str, int], WindowDelta] = {}
        self.merges = 0          # merges that changed the state
        self.stale = 0           # duplicates / lower-seq arrivals ignored

    def merge(self, delta: WindowDelta) -> bool:
        """Idempotent, commutative merge; True iff the state changed."""
        k = (delta.host, delta.window_id)
        cur = self.deltas.get(k)
        if cur is not None and cur.seq >= delta.seq:
            self.stale += 1
            return False
        self.deltas[k] = delta
        self.merges += 1
        return True

    def __len__(self) -> int:
        return len(self.deltas)

    def window_ids(self) -> list[int]:
        return sorted({wid for _, wid in self.deltas})

    def window_hosts(self, window_id: int) -> dict[str, WindowDelta]:
        """All hosts' deltas for one window (quorum checks read this)."""
        return {h: d for (h, w), d in self.deltas.items() if w == window_id}

    def fleet_window_dollars(self, window_id: int) -> dict[str, float]:
        """Per-policy fleet totals over the hosts seen for this window."""
        return self._totals(self.window_hosts(window_id).values())

    def fleet_totals(self) -> dict[str, float]:
        """Per-policy fleet totals over every merged delta."""
        return self._totals(self.deltas.values())

    @staticmethod
    def _totals(deltas) -> dict[str, float]:
        per_policy: dict[str, list[float]] = {}
        for d in deltas:
            for policy, v in d.dollars.items():
                per_policy.setdefault(policy, []).append(v)
        # fsum + sorted host/window iteration independence: exact rounding
        # of the true sum, so converged participants agree bit-for-bit
        return {p: math.fsum(vs) for p, vs in sorted(per_policy.items())}

    def digest(self) -> tuple:
        """Order-independent identity of the state; equal digests across
        participants == converged."""
        return tuple(sorted((h, w, d.seq)
                            for (h, w), d in self.deltas.items()))

    def snapshot(self) -> dict:
        return dict(deltas=len(self.deltas), merges=self.merges,
                    stale=self.stale, windows=len(self.window_ids()))
