# Online dollar-governance over the egress stack (DESIGN.md §8):
#   metrics   — back-compat shim; the registry lives in repro.obs.metrics (§9)
#   shadow    — metadata-only shadow panel: counterfactual $ per policy, $0 egress
#   window    — ring-buffered exact audit: live OPT-dollar bracket + regret
#   admission — s*-aware bypass/keep rule (eq. 3 as an admission controller)
#   governor  — hysteresis policy hot-swap driven by windowed shadow dollars
from .metrics import MetricsRegistry
from .shadow import ShadowCache, ShadowPanel
from .window import Watermark, WindowAudit, WindowedAuditor
from .admission import SStarAdmission
from .governor import DollarGovernor, SwapEvent

__all__ = [
    "MetricsRegistry", "ShadowCache", "ShadowPanel", "Watermark",
    "WindowAudit", "WindowedAuditor", "SStarAdmission", "DollarGovernor",
    "SwapEvent",
]
