"""Back-compat shim: `MetricsRegistry` moved to `repro.obs.metrics`.

The registry was promoted into the observability layer (DESIGN.md §9)
when it grew histograms and Prometheus exposition; import it from
`repro.obs` in new code. This module keeps `repro.online.metrics` (and
`from repro.online import MetricsRegistry`) working unchanged.
"""
from repro_torch.obs.metrics import (Histogram, MetricsRegistry,  # noqa: F401
                               log_bounds, sstar_bounds)

__all__ = ["MetricsRegistry", "Histogram", "log_bounds", "sstar_bounds"]
