"""Dollar-governor: hot-swaps the live cache's policy on shadow evidence.

Subscribes to an `EgressCache`'s access stream and drives three organs:

  * the shadow-policy panel (`shadow.py`) — counterfactual dollars for the
    full online policy set, $0 of extra egress;
  * the windowed exact audit (`window.py`) — a live OPT-dollars bracket
    and regret estimate over recent traffic;
  * the swap rule — every `window` accesses, compare each policy's
    *windowed* shadow dollars; if the best shadow undercuts the incumbent
    policy's shadow by more than `hysteresis` (relative), hot-swap the
    live cache via `set_policy` (contents preserved, $0 to swap).

Comparisons are shadow-vs-shadow (the incumbent's own shadow, not the live
meter): all shadows start equally cold when the governor attaches and see
identical traffic, so a swap decision is never polluted by warm-up
asymmetry or by the live cache's admission controller.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.egress.cache import ONLINE_POLICIES, AccessEvent, EgressCache
from .shadow import ShadowPanel
from .window import WindowedAuditor

__all__ = ["DollarGovernor", "SwapEvent"]


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    clock: int                  # live-cache clock at the swap
    old_policy: str
    new_policy: str
    window_dollars: dict        # policy -> dollars over the deciding window


class DollarGovernor:
    def __init__(self, cache: EgressCache,
                 policies: tuple[str, ...] = ONLINE_POLICIES,
                 window: int = 512, hysteresis: float = 0.05,
                 auditor: Optional[WindowedAuditor] = None,
                 audit_every_window: bool = False, metrics=None):
        assert window >= 1 and hysteresis >= 0.0
        self.cache = cache
        self.window = int(window)
        self.hysteresis = float(hysteresis)
        self.panel = ShadowPanel(cache.capacity, policies)
        self.auditor = auditor
        self.audit_every_window = audit_every_window
        self.metrics = metrics
        self.swaps: list[SwapEvent] = []
        self._mark = self.panel.dollars()   # shadow $ at window start
        self._since = 0
        cache.add_listener(self._on_event)

    # ------------------------------------------------------------------
    def _on_event(self, ev: AccessEvent) -> None:
        self.panel.on_event(ev)
        if self.auditor is not None:
            self.auditor.on_event(ev)
        self._since += 1
        if self._since >= self.window:
            self._tick(ev.clock)

    def _tick(self, clock: int) -> None:
        now = self.panel.dollars()
        deltas = {p: now[p] - self._mark[p] for p in now}
        self._mark = now
        self._since = 0
        if self.metrics is not None:
            for p, d in deltas.items():
                self.metrics.observe(f"governor.window_dollars.{p}", d,
                                     step=clock)
        incumbent = self.cache.policy
        best = min(deltas, key=lambda p: deltas[p])
        if (best != incumbent and incumbent in deltas
                and deltas[best] < (1.0 - self.hysteresis) * deltas[incumbent]):
            self.cache.set_policy(best)
            self.swaps.append(SwapEvent(clock, incumbent, best, deltas))
            if self.metrics is not None:
                self.metrics.inc("governor.swaps")
        if self.auditor is not None and self.audit_every_window:
            self.auditor.audit()

    # ------------------------------------------------------------------
    def audit(self):
        """Bracket OPT-dollars on the auditor's current window (or None)."""
        return self.auditor.audit() if self.auditor is not None else None

    def snapshot(self) -> dict:
        return dict(
            policy=self.cache.policy,
            swaps=[dataclasses.asdict(s) for s in self.swaps],
            shadow=self.panel.snapshot(),
            live_dollars=self.cache.meter.dollars,
            window=self.window, hysteresis=self.hysteresis,
        )
