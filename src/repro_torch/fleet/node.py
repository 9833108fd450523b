"""One edge host of the fleet: live cache + shadow panel + event-time windows.

A `FleetNode` wraps the billing path of a single simulated edge host —
an `EgressCache` over the shared origin `ObjectStore`, billed through the
host's own consumer meter — together with the governance evidence it
contributes to the fleet:

  * a metadata-only `ShadowPanel` replaying every local access against all
    candidate policies ($0 of extra egress, exactly as in DESIGN.md §8);
  * clock-skew-tolerant *event-time* windowing: accesses carry a global
    event time (the fleet stamps the trace index), windows are tumbling
    spans `[k*span, (k+1)*span)` aligned across hosts, and a window closes
    only once the host's `Watermark` (shared with `WindowedAuditor`)
    passes its end. Bounded skew is asserted by the watermark, which
    guarantees a late event's window is *still open* when it arrives —
    late events therefore fold into the open window instead of reopening
    a closed one (`late_folded` counts the defensive fallback path);
  * a wire log of every `AccessEvent` (`repro.fleet.wire` frames), so the
    host's bill can be re-derived off-host: `replayed_dollars()` decodes
    the log and re-accrues miss costs in arrival order with the meter's
    own arithmetic — bit-equal to `cache.meter.dollars`.

Closed windows become `WindowDelta` messages in `outbox`, merged into the
node's own `GossipState` and broadcast by the fleet's gossip rounds.
Hosts emit a *contiguous* window sequence (empty windows included), so a
quorum of deltas per window is reachable even when a partition goes quiet.
"""
from __future__ import annotations

import math

from repro_torch.egress.cache import ONLINE_POLICIES, AccessEvent, EgressCache
from repro_torch.egress.store import ObjectStore
from repro_torch.online.shadow import ShadowPanel
from repro_torch.online.window import Watermark

from .gossip import GossipState
from .wire import WindowDelta, decode_access_event, encode_access_event

__all__ = ["FleetNode"]


class FleetNode:
    def __init__(self, host: str, store: ObjectStore, capacity_bytes: float,
                 policy: str = "lru",
                 policies: tuple[str, ...] = ONLINE_POLICIES,
                 window_span: float = 512.0, max_skew: float = 64.0,
                 events=None, metrics=None, keep_wire_log: bool = True):
        assert window_span > 0, window_span
        self.host = host
        self.cache = EgressCache(store, capacity_bytes, policy,
                                 consumer=host, metrics=metrics,
                                 events=events)
        self.policies = tuple(policies)
        self.panel = ShadowPanel(capacity_bytes, self.policies)
        self.window_span = float(window_span)
        self.watermark = Watermark(max_skew)
        self.state = GossipState()
        self.outbox: list[WindowDelta] = []
        self.keep_wire_log = keep_wire_log
        self.wire_log: list[bytes] = []
        self.late_folded = 0          # defensive fold-into-open-window path
        self._open: dict[int, dict] = {}    # window_id -> accumulator
        self._last_closed = -1
        self._seq = 0
        self.cache.add_listener(self._on_event)

    # ------------------------------------------------------------------
    def access(self, key: str, event_time: float) -> bytes:
        """Serve one request at the given event time (the global trace
        position); closes any windows the watermark has passed."""
        data = self.cache.get(key, event_time=float(event_time))
        self._close_ripe()
        return data

    def _on_event(self, ev: AccessEvent) -> None:
        t = ev.event_time
        self.watermark.advance(t)             # asserts bounded skew
        if self.keep_wire_log:
            self.wire_log.append(encode_access_event(ev))
        shadows = self.panel.shadows
        before = [sh.dollars for sh in shadows.values()]
        self.panel.on_event(ev)
        wid = int(t // self.window_span)
        if wid <= self._last_closed:
            # bounded skew guarantees a late event's own window is still
            # open (it closes only at watermark = end + skew); this branch
            # is the defensive boundary case (lateness == max_skew exactly)
            self.late_folded += 1
            wid = min(self._open, default=self._last_closed + 1)
        acc = self._open.get(wid)
        if acc is None:
            acc = self._open[wid] = dict(events=0, dollars=dict.fromkeys(
                self.policies, 0.0))
        acc["events"] += 1
        dollars = acc["dollars"]
        for policy, b in zip(shadows, before):
            dollars[policy] += shadows[policy].dollars - b

    # ------------------------------------------------------------------
    def _close_ripe(self) -> None:
        wm = self.watermark.value
        if not math.isfinite(wm):
            return
        # window w is closeable iff (w+1)*span <= watermark
        w_max = int(wm // self.window_span) - 1
        for w in range(self._last_closed + 1, w_max + 1):
            self._emit(w)

    def _emit(self, wid: int) -> None:
        acc = self._open.pop(wid, None) or dict(
            events=0, dollars=dict.fromkeys(self.policies, 0.0))
        self._seq += 1
        delta = WindowDelta(self.host, wid, self._seq, self.watermark.value,
                            acc["events"], dict(acc["dollars"]))
        self._last_closed = max(self._last_closed, wid)
        self.outbox.append(delta)
        self.state.merge(delta)

    def flush(self) -> None:
        """End-of-stream: close every window seen, watermark regardless
        (keeps the emitted sequence contiguous through the last event)."""
        if self._open:
            for w in range(self._last_closed + 1, max(self._open) + 1):
                self._emit(w)

    # ------------------------------------------------------------------
    def replayed_dollars(self) -> float:
        """Re-accrue this host's bill from the decoded wire log: naive sum
        of miss costs in arrival order — the same floats in the same order
        with the same IEEE addition as `BillingMeter.record_get`, hence
        bit-equal to `cache.meter.dollars`."""
        total = 0.0
        for raw in self.wire_log:
            ev = decode_access_event(raw)
            if not ev.hit:
                total += ev.miss_cost
        return total

    def audit(self):
        """This host's exact offline audit (its own partition's trace);
        None for a host that saw no traffic — an empty trace has no OPT
        to bracket, and its meter holds exactly $0."""
        if self.cache.hits + self.cache.misses == 0:
            return None
        return self.cache.audit()

    def snapshot(self) -> dict:
        return dict(
            host=self.host, policy=self.cache.policy,
            dollars=self.cache.meter.dollars,
            hits=self.cache.hits, misses=self.cache.misses,
            hit_rate=self.cache.hit_rate, used=self.cache.used,
            windows_closed=self._seq, late_folded=self.late_folded,
            late_events=self.watermark.late,
            watermark=self.watermark.value,
            shadow=self.panel.snapshot())
