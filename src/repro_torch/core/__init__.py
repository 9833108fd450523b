# The paper's measurement loop on PyTorch: price each miss (eq. 1), replay
# the policy panel over policies x price vectors x budgets on the card, and
# score the dollars against the exact offline optimum; and the cost-FOO
# bracket for variable sizes, its rounded schedule checked on the card.
from .pricing import (PRICE_VECTORS, PriceVector, crossover_bytes,
                      heterogeneity, miss_costs)
from .trace import (Trace, next_use_indices, twemcache_like, two_class_trace,
                    wiki_cdn_like, zipf_trace)
from .policies import POLICIES, PolicyResult, simulate, total_cost_no_cache
from .opt_exact import (OptResult, SweepResult, build_interval_arrays,
                        build_intervals, dp_opt_uniform, enumerate_opt_uniform,
                        exact_opt_uniform, exact_opt_uniform_sweep,
                        interval_deltas, lp_opt, zcap_profile)
from .cost_foo import (CostFooResult, cost_foo, round_fractional,
                       round_fractional_reference)
from .regret import regret, regret_table
from .policies_torch import (POLICY_WEIGHTS, PolicyWeights, resolve_device,
                             simulate_torch, stack_policy_weights,
                             sweep_torch)
from . import carry

__all__ = [
    "PRICE_VECTORS", "PriceVector", "crossover_bytes", "heterogeneity",
    "miss_costs", "Trace", "next_use_indices", "twemcache_like",
    "two_class_trace", "wiki_cdn_like", "zipf_trace", "POLICIES",
    "PolicyResult", "simulate", "total_cost_no_cache", "OptResult",
    "SweepResult", "build_interval_arrays", "build_intervals",
    "dp_opt_uniform", "enumerate_opt_uniform", "exact_opt_uniform",
    "exact_opt_uniform_sweep", "interval_deltas", "lp_opt", "zcap_profile",
    "CostFooResult", "cost_foo", "round_fractional",
    "round_fractional_reference", "regret", "regret_table", "POLICY_WEIGHTS",
    "PolicyWeights", "resolve_device", "simulate_torch",
    "stack_policy_weights", "sweep_torch", "carry",
]
