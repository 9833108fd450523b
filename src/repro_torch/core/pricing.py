"""Cloud price vectors, per-miss dollar costs, the s* crossover and heterogeneity H.

Implements eq. (1)  c_i = f + s_i * e  (GET fee + egress), eq. (3)  s* = f / e,
and the access-weighted coefficient of variation H used by the
heterogeneity-regret law (paper §4).

Price vectors are list prices as of the paper (June 2026), dollars:
  f : per-GET request fee          [$ / request]
  e : per-byte egress rate         [$ / byte]
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

__all__ = [
    "PriceVector",
    "PRICE_VECTORS",
    "miss_costs",
    "crossover_bytes",
    "heterogeneity",
]


@dataclasses.dataclass(frozen=True)
class PriceVector:
    """A cloud billing vector: flat GET fee + linear egress rate."""

    name: str
    get_fee: float          # $ per GET request
    egress_per_byte: float  # $ per byte of egress
    latency_penalty: float = 0.0  # optional $-equivalent per miss (paper's "+ latency")

    def miss_cost(self, size_bytes) -> np.ndarray:
        """c_i = f + s_i * e (+ latency penalty). Vectorized over sizes."""
        s = np.asarray(size_bytes, dtype=np.float64)
        return self.get_fee + s * self.egress_per_byte + self.latency_penalty

    def miss_cost_scalar(self, size_bytes: float) -> float:
        """Scalar fast path for per-access hot loops (EgressCache, tracer
        spans): identical IEEE-754 operation order to `miss_cost`, so the
        result is bit-equal to `float(miss_cost(s))` — billing-faithful
        without the ~2us numpy round-trip."""
        return (self.get_fee + float(size_bytes) * self.egress_per_byte
                + self.latency_penalty)

    @property
    def crossover_bytes(self) -> float:
        """s* = f / e — object size at which GET fee equals egress cost."""
        return self.get_fee / self.egress_per_byte


# List prices (June 2026). GET fees are per-request; egress converted from $/GB.
_GB = 1e9
PRICE_VECTORS: Mapping[str, PriceVector] = {
    # S3 GET $0.40 per 1M requests, internet egress $0.09/GB  -> s* ~ 4.44 KB
    "s3_internet": PriceVector("s3_internet", 0.40e-6, 0.09 / _GB),
    # S3 cross-region transfer $0.02/GB -> s* ~ 20 KB
    "s3_cross_region": PriceVector("s3_cross_region", 0.40e-6, 0.02 / _GB),
    # GCS class-B op $0.40/1M ... but paper lists s* ~ 333 B via $0.004/10k GET
    # and $0.12/GB egress: f = 0.004/1e4 = 4.0e-8?  The paper's s* ~ 330 B with
    # e = $0.12/GB implies f = 4.0e-8 $/GET ($0.04 per 1M). Use that.
    "gcs_internet": PriceVector("gcs_internet", 0.04e-6, 0.12 / _GB),
    # Azure read ops ~$0.004 per 10k ($0.04/1M = 4.0e-8) with $0.087/GB -> ~460 B
    "azure_internet": PriceVector("azure_internet", 0.04e-6, 0.087 / _GB),
}


def miss_costs(sizes: np.ndarray, price: PriceVector) -> np.ndarray:
    """Per-object miss-cost vector c_i = f + s_i e."""
    return price.miss_cost(sizes)


def crossover_bytes(price: PriceVector) -> float:
    """Eq. (3): the GET-fee / egress crossover size s* = f/e."""
    return price.crossover_bytes


def heterogeneity(trace_ids: np.ndarray, costs_per_object: np.ndarray) -> float:
    """Access-weighted coefficient of variation H of the miss-cost vector.

    Each *access* contributes its object's miss cost; H = std/mean over the
    per-access cost sequence (paper §4: "access-weighted coefficient of
    variation of the miss-cost vector").
    """
    per_access = np.asarray(costs_per_object, dtype=np.float64)[np.asarray(trace_ids)]
    m = per_access.mean()
    if m == 0:
        return 0.0
    return float(per_access.std() / m)
