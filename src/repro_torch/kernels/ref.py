"""Plain PyTorch versions of the port's kernels.

They define what the CUDA kernels compute. The CPU tests hold them against
the JAX package's oracles and Pallas kernels; on the card, `chip_smoke.py`
holds each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch

__all__ = ["evict_argmin_ref", "next_use_ref", "frequency_rank_ref",
           "interval_occupancy_ref", "occupancy_feasible_ref", "BIG",
           "INT_BIG"]

BIG = 3.4e38          # score of an entry outside the mask (float32)
INT_BIG = 2**31 - 1   # touch of an entry outside the tie set


def evict_argmin_ref(scores: torch.Tensor, touch: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic argmin of (score, touch, index) over masked entries.

    scores: (N,) or (C, N) float32 or bfloat16, upcast to float32 as the
    kernel does; touch: int32, (N,) or (C, N), broadcast over rows; mask:
    bool, same shape as scores. Reduces along the last dim and returns
    (victim index int32, victim score float32), 0-d for a vector and (C,)
    for a batch. Entries outside the mask score BIG, so an empty row gives
    score BIG and the index of the smallest touch.
    """
    s = torch.where(mask, scores.float(), BIG)   # BIG rounds to float32
    min_s = torch.amin(s, dim=-1, keepdim=True)
    tie = s <= min_s
    t = torch.where(tie, touch, INT_BIG)
    victim = torch.argmin(t, dim=-1, keepdim=True)
    score = torch.gather(s, -1, victim)
    return victim.squeeze(-1).to(torch.int32), score.squeeze(-1)


def next_use_ref(ids: torch.Tensor, num_objects: int | None = None
                 ) -> torch.Tensor:
    """next(t): index of the next request of ids[t], or T if none (int32).

    A stable sort groups each object's requests in time order, so the
    successor within a group is the next use.
    """
    T = ids.shape[0]
    order = torch.sort(ids, stable=True).indices
    sorted_ids = ids[order]
    succ = torch.full((T,), T, dtype=torch.int64, device=ids.device)
    if T > 1:
        same = sorted_ids[1:] == sorted_ids[:-1]
        succ[:-1] = torch.where(same, order[1:], succ[:-1])
    nxt = torch.empty(T, dtype=torch.int64, device=ids.device)
    nxt[order] = succ
    return nxt.to(torch.int32)


def frequency_rank_ref(ids: torch.Tensor) -> torch.Tensor:
    """rank[t] = the count of ids[t] in ids[:t+1] (int32): the frequency
    the replay reads at step t. In the stable sort by id, t's place in its
    id's run, plus one."""
    T = ids.shape[0]
    order = torch.sort(ids, stable=True).indices
    sorted_ids = ids[order]
    pos = torch.arange(T, device=ids.device)
    head = torch.ones(T, dtype=torch.bool, device=ids.device)
    head[1:] = sorted_ids[1:] != sorted_ids[:-1]
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    rank = torch.empty(T, dtype=torch.int64, device=ids.device)
    rank[order] = pos - start + 1
    return rank.to(torch.int32)


def interval_occupancy_ref(deltas: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum of (T,) occupancy deltas: the occupancy
    profile occ(p), the LHS of eq. (2). int32 deltas are cast first.

    PyTorch's cumsum adds float32 in float64 on the CPU and in float32 on
    the card; where every partial sum is exact in float32 (integer-valued
    deltas below 2^24) the two agree bit for bit.
    """
    return torch.cumsum(deltas.float(), 0)


def occupancy_feasible_ref(deltas: torch.Tensor, zcap: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Occupancy profile and its worst excess over the per-instant cap.

    Returns (occ (T,) float32, max over p of occ[p] - zcap[p] as a 0-d
    float32 tensor); the schedule fits iff the excess is within tolerance.
    """
    occ = interval_occupancy_ref(deltas)
    return occ, torch.amax(occ - zcap.float())
