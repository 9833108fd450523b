"""Dollar-regret against the exact (or bracketed) offline optimum.

R(pi) = (Cost(pi) - Cost(OPT)) / Cost(OPT)        (paper §2)
"""
from __future__ import annotations

import numpy as np

from . import policies as pol
from .opt_exact import exact_opt_uniform
from .trace import Trace

__all__ = ["regret", "regret_table"]


def regret(policy_dollars: float, opt_dollars: float) -> float:
    return (policy_dollars - opt_dollars) / max(opt_dollars, 1e-12)


def regret_table(trace: Trace, costs: np.ndarray, B: int,
                 policies: tuple[str, ...] = ("lru", "lfu", "gds", "gdsf",
                                              "belady", "cost_belady"),
                 ) -> dict[str, float]:
    """Uniform-size (page) regret table against the exact optimum."""
    opt = exact_opt_uniform(trace.ids, costs, B)
    out = {"opt_dollars": opt.dollars}
    for p in policies:
        r = pol.simulate(p, trace, costs, float(B))
        out[p] = regret(r.dollars, opt.dollars)
        out[f"{p}_dollars"] = r.dollars
    return out
