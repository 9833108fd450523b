"""Fleet-wide dollar-policy swaps: quorum votes with a centralized tiebreak.

`FleetCoordinator` turns gossiped `WindowDelta`s into swap decisions. Each
host's *vote* for a window is a deterministic function of its own delta —
`DollarGovernor`'s hysteresis rule verbatim: leave the incumbent only if
the best policy's windowed shadow dollars undercut the incumbent's by the
relative `hysteresis` margin. Votes are weighted by the incumbent's
dollars on that host's partition (the dollars actually at stake there), so
a quiet edge cannot out-vote the host paying the bill. Because the vote is
derived from the delta itself, no separate ballot messages exist — gossip
convergence *is* vote delivery.

A window is decided once a quorum (default: majority of hosts) of deltas
is present, strictly in window order, exactly once (`decided` memoizes;
duplicated or re-delivered deltas can never re-apply a swap — the
fault-injection tests assert this). The decision rule:

  * a policy holding a strict majority of the vote weight wins ("quorum");
  * otherwise, in `mode="central"`, the coordinator breaks the tie from
    its own merged view — argmin of the fleet-aggregated window dollars,
    hysteresis against the incumbent ("tiebreak");
  * otherwise the incumbent stands.

Swaps apply atomically across the fleet (`EgressCache.set_policy` on every
node: contents preserved, $0 to swap) and publish through the duck-typed
obs surface — a `policy_swap` decision event plus `fleet.*` metrics.

`Fleet` is the facade: N `FleetNode`s over one shared origin store, a
`SimNetwork`, hash partitioning, gossip rounds, and the coordinator. Its
billing identity: `dollars()` is the fsum over per-node `BillingMeter`s
and reconciles bit-for-bit with the sum of per-node audits.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Optional

from repro_torch.egress.cache import ONLINE_POLICIES
from repro_torch.egress.store import ObjectStore

from .gossip import GossipState, SimNetwork
from .node import FleetNode
from .wire import WindowDelta, decode_window_delta, encode_window_delta

__all__ = ["FleetCoordinator", "FleetSwap", "Fleet", "hash_partition"]


def hash_partition(key: str, n_nodes: int) -> int:
    """Stable key -> host assignment (crc32: cheap, seed-free, portable)."""
    return zlib.crc32(key.encode("utf-8")) % n_nodes


@dataclasses.dataclass(frozen=True)
class FleetSwap:
    window_id: int
    old_policy: str
    new_policy: str
    mode: str                  # "quorum" | "tiebreak"
    votes: dict                # host -> [vote, weight]
    round: int                 # network round at application time


class FleetCoordinator:
    def __init__(self, n_hosts: int, policy: str = "lru",
                 policies: tuple[str, ...] = ONLINE_POLICIES,
                 hysteresis: float = 0.1, quorum: Optional[int] = None,
                 mode: str = "quorum", events=None, metrics=None):
        assert mode in ("quorum", "central"), mode
        assert hysteresis >= 0.0
        self.n_hosts = int(n_hosts)
        self.policy = policy               # fleet-wide incumbent
        self.policies = tuple(policies)
        self.hysteresis = float(hysteresis)
        self.quorum = (self.n_hosts // 2 + 1) if quorum is None else int(quorum)
        assert 1 <= self.quorum <= self.n_hosts, self.quorum
        self.mode = mode
        self.events = events               # duck-typed: .record(kind, ...)
        self.metrics = metrics             # duck-typed: .inc(name, value)
        self.state = GossipState()
        self.decided: dict[int, str] = {}  # window_id -> decided policy
        self.frontier = -1                 # highest contiguously decided wid
        self.swaps: list[FleetSwap] = []

    # ------------------------------------------------------------------
    def ingest(self, delta: WindowDelta) -> bool:
        return self.state.merge(delta)

    def vote_of(self, delta: WindowDelta) -> tuple[str, float]:
        """One host's (vote, weight) from its own window evidence —
        DollarGovernor's hysteresis rule, weight = incumbent dollars."""
        d = delta.dollars
        inc = self.policy
        weight = d.get(inc, 0.0)
        if not d:
            return inc, 0.0
        best = min(d, key=d.get)
        if best != inc and d[best] < (1.0 - self.hysteresis) * weight:
            return best, weight
        return inc, weight

    def poll(self, apply_fn: Optional[Callable[[str, "FleetSwap"], None]]
             = None, network_round: int = 0) -> list[FleetSwap]:
        """Decide every window with a quorum of deltas, oldest first.

        Windows decide strictly in order (a gap without quorum blocks the
        rest — votes depend on the incumbent at decision time), and each
        at most once: re-delivered evidence for a decided window is inert.
        """
        applied = []
        for wid in self.state.window_ids():
            if wid <= self.frontier:
                continue
            if wid != self.frontier + 1:
                break                       # in-order: wait for the gap
            hosts = self.state.window_hosts(wid)
            if len(hosts) < self.quorum:
                break
            decision, mode_used, votes = self._decide(wid, hosts)
            self.decided[wid] = decision
            self.frontier = wid
            if self.metrics is not None:
                self.metrics.inc("fleet.windows_decided")
            if decision != self.policy:
                swap = FleetSwap(wid, self.policy, decision, mode_used,
                                 votes, network_round)
                self.policy = decision
                self.swaps.append(swap)
                applied.append(swap)
                if apply_fn is not None:
                    apply_fn(decision, swap)
                if self.events is not None:
                    self.events.record("policy_swap", f"fleet/window{wid}",
                                       0, 0.0, 0.0, wid, decision)
                if self.metrics is not None:
                    self.metrics.inc("fleet.swaps")
        return applied

    def _decide(self, wid: int,
                hosts: dict[str, WindowDelta]) -> tuple[str, str, dict]:
        votes = {h: self.vote_of(d) for h, d in sorted(hosts.items())}
        tally: dict[str, float] = {}
        for vote, weight in votes.values():
            tally[vote] = tally.get(vote, 0.0) + weight
        total = math.fsum(tally.values())
        record = {h: [v, w] for h, (v, w) in votes.items()}
        if total <= 0.0:
            return self.policy, "quorum", record     # no dollars at stake
        winner = max(sorted(tally), key=lambda p: tally[p])
        if tally[winner] > 0.5 * total:
            return winner, "quorum", record
        if self.mode == "central":
            # centralized tiebreak: fleet-aggregated window dollars, same
            # hysteresis rule against the incumbent
            agg = self.state.fleet_window_dollars(wid)
            inc = self.policy
            best = min(agg, key=agg.get)
            if best != inc and agg[best] < (1.0 - self.hysteresis) * \
                    agg.get(inc, 0.0):
                return best, "tiebreak", record
        return self.policy, "quorum", record

    def snapshot(self) -> dict:
        return dict(policy=self.policy, quorum=self.quorum, mode=self.mode,
                    hysteresis=self.hysteresis, frontier=self.frontier,
                    windows_decided=len(self.decided),
                    swaps=[dataclasses.asdict(s) for s in self.swaps],
                    state=self.state.snapshot())


class Fleet:
    """N governed edge hosts over one origin store, acting as one fleet."""

    COORD = "coordinator"

    def __init__(self, store: Optional[ObjectStore] = None,
                 n_nodes: int = 4, capacity_bytes: float = 1 << 22,
                 policy: str = "lru",
                 policies: tuple[str, ...] = ONLINE_POLICIES,
                 window_span: float = 512.0, max_skew: float = 64.0,
                 hysteresis: float = 0.1, quorum: Optional[int] = None,
                 mode: str = "quorum", network: Optional[SimNetwork] = None,
                 gossip_every: Optional[int] = None, seed: int = 0,
                 events=None, metrics=None, price: str = "s3_internet",
                 keep_wire_log: bool = True):
        assert n_nodes >= 1
        self.store = store if store is not None else ObjectStore(price)
        self.network = network if network is not None else SimNetwork(seed)
        self.nodes = [
            FleetNode(f"edge{i}", self.store, capacity_bytes, policy,
                      policies, window_span, max_skew, events=events,
                      metrics=metrics, keep_wire_log=keep_wire_log)
            for i in range(n_nodes)]
        self._by_host = {n.host: n for n in self.nodes}
        self.coordinator = FleetCoordinator(
            n_nodes, policy, policies, hysteresis, quorum, mode,
            events=events, metrics=metrics)
        self.metrics = metrics
        self.gossip_every = gossip_every     # None = step() manually
        self._since_gossip = 0
        self._auto_t = 0.0

    # ------------------------------------------------------------------
    def node_of(self, key: str) -> FleetNode:
        return self.nodes[hash_partition(key, len(self.nodes))]

    def access(self, key: str, event_time: Optional[float] = None) -> bytes:
        """Route one request to its owning host by key hash."""
        if event_time is None:
            event_time = self._auto_t
        self._auto_t = max(self._auto_t, float(event_time)) + 1.0
        data = self.node_of(key).access(key, event_time)
        if self.gossip_every:
            self._since_gossip += 1
            if self._since_gossip >= self.gossip_every:
                self._since_gossip = 0
                self.step()
        return data

    # ------------------------------------------------------------------
    def step(self) -> list[FleetSwap]:
        """One gossip round: every node broadcasts its full state (anti-
        entropy — drops heal on the next round) to all peers and the
        coordinator; deliver with faults; merge; poll for decisions."""
        for node in self.nodes:
            frames = [encode_window_delta(d)
                      for d in node.state.deltas.values()]
            node.outbox.clear()
            for peer in self.nodes:
                if peer is node:
                    continue
                for f in frames:
                    self.network.send(node.host, peer.host, f)
            for f in frames:
                self.network.send(node.host, self.COORD, f)
        for dst, _src, frame in self.network.deliver():
            delta = decode_window_delta(frame)
            if dst == self.COORD:
                self.coordinator.ingest(delta)
            else:
                self._by_host[dst].state.merge(delta)
        return self.coordinator.poll(self._apply_swap, self.network.round)

    def _apply_swap(self, policy: str, swap: FleetSwap) -> None:
        for node in self.nodes:
            node.cache.set_policy(policy)    # no-op if already there

    def flush(self, max_rounds: int = 64) -> bool:
        """End-of-stream: close all open windows, then gossip until every
        participant (nodes + coordinator) holds the same digest. Returns
        True iff converged within `max_rounds`."""
        for node in self.nodes:
            node.flush()
        for _ in range(max_rounds):
            self.step()
            if self.converged():
                return True
        return self.converged()

    def converged(self) -> bool:
        """True when every participant (nodes + coordinator) holds the
        same digest. Frames still in flight cannot break this: a frame is
        a delta of its sender's state at send time, states only grow, and
        merge keeps the max seq — so once digests agree, anything still
        queued (delayed/duplicated copies) is stale on arrival."""
        digests = {n.state.digest() for n in self.nodes}
        digests.add(self.coordinator.state.digest())
        return len(digests) == 1

    # ------------------------------------------------------------------
    @property
    def policy(self) -> str:
        return self.coordinator.policy

    @property
    def swaps(self) -> list[FleetSwap]:
        return self.coordinator.swaps

    def dollars(self) -> float:
        """Fleet-wide realized bill: fsum over per-node BillingMeters."""
        return math.fsum(n.cache.meter.dollars for n in self.nodes)

    def audits(self) -> dict:
        """Per-host exact offline audits (None for traffic-less hosts);
        their observed dollars fsum to `dollars()` bit-for-bit (each
        host's audit reads its own meter, and a None host's meter is $0).
        """
        return {n.host: n.audit() for n in self.nodes}

    def fleet_shadow_totals(self) -> dict[str, float]:
        """Converged fleet-wide per-policy windowed shadow dollars, from
        the coordinator's merged gossip state."""
        return self.coordinator.state.fleet_totals()

    def snapshot(self) -> dict:
        return dict(
            n_nodes=len(self.nodes), policy=self.coordinator.policy,
            dollars=self.dollars(),
            window_span=self.nodes[0].window_span,
            max_skew=self.nodes[0].watermark.max_skew,
            coordinator=self.coordinator.snapshot(),
            network=self.network.snapshot(),
            shadow_totals=self.fleet_shadow_totals(),
            nodes={n.host: n.snapshot() for n in self.nodes})
