"""Roofline terms of a dry-run cell on one NVIDIA H100 SXM.

The port of `repro.launch.roofline`, with the H100's figures. From
NVIDIA's H100 Tensor Core GPU datasheet, the SXM part (dense rates,
without sparsity, at its 700 W power limit):

  PEAK_FLOPS     = 989e12  FLOP/s, BF16 Tensor Core
  F32_PEAK_FLOPS = 67e12   FLOP/s, FP32 (outside the Tensor Cores)
  HBM_BW         = 3.35e12 B/s, HBM3
  NVLINK_BW      = 450e9   B/s: fourth-generation NVLink gives a GPU
                           900 GB/s, the two directions together; a
                           collective's result bytes arrive in one
                           direction, so the term uses half of it.

The dry-run's counts are per device (`launch.hlo_analysis`), so the
three terms are

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_result_bytes_per_device / NVLINK_BW

They are projections from datasheet figures, not measurements.
"""
from __future__ import annotations

import dataclasses
import math

from ..models.common import tree_zip_map

PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

__all__ = ["RooflineTerms", "terms_from_analysis", "count_params",
           "model_flops", "PEAK_FLOPS", "F32_PEAK_FLOPS", "HBM_BW",
           "NVLINK_BW"]


@dataclasses.dataclass
class RooflineTerms:
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (counted flops x devices)
    roofline_fraction: float     # compute_s / max(all terms)

    def as_dict(self):
        return dataclasses.asdict(self)


def terms_from_analysis(flops_dev: float, bytes_dev: float,
                        coll_bytes_dev: float, num_devices: int,
                        model_flops_total: float) -> RooflineTerms:
    c = flops_dev / PEAK_FLOPS
    m = bytes_dev / HBM_BW
    k = coll_bytes_dev / NVLINK_BW
    terms = {"compute": c, "memory": m, "collective": k}
    dominant = max(terms, key=terms.get)
    bound = max(c, m, k)
    counted_total = flops_dev * num_devices
    return RooflineTerms(
        flops_dev=flops_dev, bytes_dev=bytes_dev,
        coll_bytes_dev=coll_bytes_dev,
        compute_s=c, memory_s=m, collective_s=k, dominant=dominant,
        model_flops_total=model_flops_total,
        useful_ratio=(model_flops_total / counted_total)
        if counted_total else 0.0,
        roofline_fraction=(c / bound) if bound > 0 else 0.0,
    )


def count_params(abstract_params, axes_tree, *, top_k: int = 0,
                 num_experts: int = 0) -> tuple[float, float, float]:
    """(total, active, embed) parameter counts of a tree of (meta) tensors
    and its logical axes: leaves with a "vocab" axis count as embedding
    and not as active; expert leaves count top_k / num_experts of
    themselves as active."""
    pairs = []
    tree_zip_map(lambda p, ax: pairs.append((float(math.prod(p.shape)), ax)),
                 abstract_params, axes_tree)
    total = active = embed = 0.0
    for n, ax in pairs:
        total += n
        if isinstance(ax, tuple) and "vocab" in ax:
            embed += n
            continue
        if isinstance(ax, tuple) and "expert" in ax and num_experts > 0:
            active += n * (top_k / num_experts)
        else:
            active += n
    return total, active, embed


def model_flops(kind: str, n_active_nonembed: float, tokens: float) -> float:
    """6ND for training, 2ND for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_nonembed * tokens
