"""Batched cache-policy replay on PyTorch: the port of `policies_jax.py`.

The paper's sweeps replay one trace under a grid of (policy, price vector,
budget) cells. Policies are score weights, exactly as in the reference:
the victim is the cached object with the minimum score, where

  score(i) = w_t * last_touch(i)                     (LRU)
           + w_f * freq(i)                           (LFU)
           + w_gd   * (L + c_i / s_i)                (GreedyDual-Size)
           + w_gdsf * (L + freq(i) * c_i / s_i)      (GDSF)
           + w_bel  * (-next_use(i))                 (Belady: evict farthest)
           + w_cb   * (-(s_i * gap_i / c_i))         (cost-aware Belady)

The reference nests `jax.vmap` three deep around one `lax.scan` per cell.
Here the grid is flattened to a leading cell axis, C = Q*P*K with cell
c = (q*P + p)*K + k, and one Python loop over the T requests advances all
C cells at once. Each step does what the reference's `step` does, in the
same order and with the same float32 expressions written as separate ops
(no fused multiply-add), so the CPU and the card give the reference's bits
wherever the reference's own arithmetic is exact.

Victim selection goes through `kernels.ops.evict_argmin`: the CUDA kernel
on the card (`use_kernel=None` -> the device is CUDA), the plain PyTorch
version on the CPU or with `use_kernel=False`. next(t) comes from
`kernels.ops.next_use` the same way, once per replay.

Uniform-size pages (the exact reference's regime): one eviction per miss.
Variable sizes stay on the host reference (`policies.py`).
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Sequence

import numpy as np
import torch

from . import carry
from ..kernels import _build, ops

__all__ = ["PolicyWeights", "POLICY_WEIGHTS", "simulate_torch", "sweep_torch",
           "stack_policy_weights", "resolve_device"]

_BIG = 3.4e38


@dataclasses.dataclass(frozen=True)
class PolicyWeights:
    w_t: float = 0.0
    w_f: float = 0.0
    w_gd: float = 0.0
    w_gdsf: float = 0.0
    w_bel: float = 0.0
    w_cb: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array([self.w_t, self.w_f, self.w_gd, self.w_gdsf,
                         self.w_bel, self.w_cb], dtype=np.float32)


POLICY_WEIGHTS: dict[str, PolicyWeights] = {
    "lru": PolicyWeights(w_t=1.0),
    "lfu": PolicyWeights(w_f=1.0, w_t=1e-12),
    "gds": PolicyWeights(w_gd=1.0),
    "gdsf": PolicyWeights(w_gdsf=1.0),
    "belady": PolicyWeights(w_bel=1.0),
    "cost_belady": PolicyWeights(w_cb=1.0),
}


def stack_policy_weights(policies: Sequence[str | PolicyWeights]) -> np.ndarray:
    """(Q, 6) weight stack for a policy panel: the grid's policy axis."""
    rows = []
    for p in policies:
        w = POLICY_WEIGHTS[p] if isinstance(p, str) else p
        rows.append(w.as_array())
    return np.stack(rows)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device and no card this raises; nothing carries on on the CPU
    unless the caller asked for it."""
    if device is None:
        if not ops.on_cuda():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _replay(weights: torch.Tensor, ids: np.ndarray, nxt: np.ndarray,
            costs: torch.Tensor, sizes: torch.Tensor, budgets: torch.Tensor,
            use_kernel: bool, trace_steps: bool = False):
    """Replay every (policy, price vector, budget) cell over the trace.

    weights (Q, 6) float32, costs (P, N) float32, sizes (N,) float32 and
    budgets (K,) int32 lie on the replay's device; ids and nxt are host
    arrays, so the step loop reads its request and next use without a
    device round trip. Returns dollars (Q, P, K) float32 and hits (Q, P, K)
    int32, plus their per-step values (T, Q, P, K) when `trace_steps`.
    """
    dev = costs.device
    f32, i32 = torch.float32, torch.int32
    Q, (P, N), K, T = weights.shape[0], costs.shape, budgets.shape[0], len(ids)
    C = Q * P * K
    big = torch.tensor(_BIG, dtype=f32, device=dev)
    neg_big = torch.tensor(-_BIG, dtype=f32, device=dev)

    # per-policy weights, shaped to broadcast over (Q, P, K) and (Q, P, K, N)
    w = [weights[:, j].reshape(Q, 1, 1) for j in range(6)]
    w_bel, w_cb = w[4].unsqueeze(-1), w[5].unsqueeze(-1)
    gd_active = (w[2] + w[3]) > 0
    c_over_s = costs / torch.clamp_min(sizes, 1e-30)          # (P, N)
    cost_floor = torch.clamp_min(costs, 1e-30)                # (P, N)
    capacity = budgets.reshape(1, 1, K)

    cached = torch.zeros((Q, P, K, N), dtype=torch.bool, device=dev)
    static = torch.full((Q, P, K, N), _BIG, dtype=f32, device=dev)
    used = torch.zeros((Q, P, K), dtype=i32, device=dev)
    infl = torch.zeros((Q, P, K), dtype=f32, device=dev)
    dollars = torch.zeros((Q, P, K), dtype=f32, device=dev)
    hits = torch.zeros((Q, P, K), dtype=i32, device=dev)
    # Every request updates next use, last touch and frequency of its
    # object whatever the cache holds, so these are the same in every cell:
    # one (N,) row each, broadcast over the cells (frequency on the host,
    # since a step only reads its own object's count). The next use is kept
    # as the reference's float32 value, its never-reused flag and its
    # Belady term, each written for object i alone.
    nxtf = torch.full((N,), float(T), dtype=f32, device=dev)
    never = torch.ones(N, dtype=torch.bool, device=dev)
    bel = torch.full((N,), -_BIG, dtype=f32, device=dev)
    touch = torch.zeros(N, dtype=i32, device=dev)
    freq = np.zeros(N, dtype=np.int64)
    cached_rows = cached.view(C, N)
    # per-object columns of the price matrices, (1, P, 1) each
    cost_cols = costs.t().contiguous().view(N, 1, P, 1)
    cos_cols = c_over_s.t().contiguous().view(N, 1, P, 1)
    # -(a / b) == a / (-b) exactly, so cost-Belady's negation is folded in
    neg_cost_floor = -cost_floor
    if trace_steps:
        steps_d = torch.empty((T, Q, P, K), dtype=f32, device=dev)
        steps_h = torch.empty((T, Q, P, K), dtype=i32, device=dev)

    for t in range(T):
        i, nu, tf = int(ids[t]), int(nxt[t]), float(t)
        freq[i] += 1
        fi = float(freq[i])
        cached_i = cached.select(3, i)
        is_hit = cached_i.clone()
        dollars += torch.where(is_hit, 0.0, cost_cols[i])
        hits += is_hit

        # mask = cached \ {i}: clear column i in place; it is set again below
        # (a miss always inserts, a hit keeps i), and the victim is never i
        cached_i.fill_(False)
        gap = torch.clamp_min(nxtf - tf, 1.0)
        cb = torch.where(never, neg_big, sizes * gap / neg_cost_floor)
        raw = static + w_bel * bel + w_cb * cb.view(1, P, 1, N)
        victim, vscore = ops.evict_argmin(raw.view(C, N), touch, cached_rows,
                                          use_kernel=use_kernel)
        victim, vscore = victim.view(Q, P, K), vscore.view(Q, P, K)
        full = used >= capacity

        # eq.-(2) semantics: a miss always inserts (mandatory displacement)
        do_insert = ~is_hit
        do_evict = do_insert & full & (vscore < big)
        # clear the victim's slot; cells that evict nothing clear column i
        evicted = torch.where(do_evict, victim, i)
        cached_rows.scatter_(1, evicted.view(C, 1).to(torch.int64), False)
        # GreedyDual aging: L := priority of the evicted victim
        infl = torch.where(do_evict & gd_active, vscore, infl)
        cos_i = cos_cols[i]
        my_static = (w[0] * tf + w[1] * fi
                     + w[2] * (infl + cos_i)
                     + w[3] * (infl + fi * cos_i))
        used -= do_evict.to(i32)
        used += do_insert
        cached_i.fill_(True)
        # touches (hit or insert) refresh score, next use and touch time
        static.select(3, i).copy_(my_static)
        nxtf.select(0, i).fill_(float(nu))
        never.select(0, i).fill_(nu >= T)
        bel.select(0, i).fill_(-_BIG if nu >= T else -float(nu))
        touch.select(0, i).fill_(t)
        if trace_steps:
            steps_d[t] = dollars
            steps_h[t] = hits
    if trace_steps:
        return dollars, hits, (steps_d, steps_h)
    return dollars, hits, None


def _policy_stack(policy) -> np.ndarray:
    """A name, a sequence of names / `PolicyWeights`, or a stack as is
    (`carry.weight_stack` checks its shape)."""
    if isinstance(policy, str):
        return stack_policy_weights([policy])
    if isinstance(policy, torch.Tensor):
        return policy.detach().cpu().numpy()
    if isinstance(policy, np.ndarray):
        return policy
    return stack_policy_weights(policy)


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def _simulate(ids, nxt, costs: torch.Tensor, sizes: torch.Tensor,
              capacity: int, weights: torch.Tensor, num_objects: int,
              use_kernel: bool = False, trace_steps: bool = False):
    """One policy replay, uniform-size pages. Returns (dollars, hits).

    The counterpart of the reference's `_simulate`, with the same
    arguments: ids and nxt (T,), costs and sizes (N,), weights (6,). The
    device is that of `costs`. `use_kernel` routes the victim argmin through
    the CUDA kernel. `trace_steps` also returns the per-step (dollars,
    hits) trajectory, each (T,), for step-for-step equivalence tests.
    """
    if costs.shape != (num_objects,):
        raise ValueError(f"costs must have shape ({num_objects},)")
    budgets = torch.tensor([int(capacity)], dtype=torch.int32,
                           device=costs.device)
    d, h, steps = _replay(weights.reshape(1, 6), _host_ints(ids),
                          _host_ints(nxt), costs.reshape(1, -1), sizes,
                          budgets, use_kernel, trace_steps)
    d, h = d.reshape(()), h.reshape(())
    if trace_steps:
        return d, h, (steps[0].reshape(-1), steps[1].reshape(-1))
    return d, h


def _prepare(ids, costs, num_objects, sizes, dev):
    ids = np.asarray(ids, dtype=np.int32)
    n = int(num_objects if num_objects is not None else ids.max() + 1)
    ids_t, sizes_t = carry.trace_tensors(ids, sizes, dev, num_objects=n)
    costs_t = carry.cost_matrix(costs, dev)
    if costs_t.shape[-1] != n or sizes_t.shape != (n,):
        raise ValueError(f"costs and sizes must have {n} objects")
    return ids, ids_t, n, sizes_t, costs_t


def _next_use_host(ids_t: torch.Tensor, n: int, use_kernel: bool) -> np.ndarray:
    return _host_ints(ops.next_use(ids_t, n, use_kernel=use_kernel))


def simulate_torch(policy: str, ids: np.ndarray, costs: np.ndarray,
                   capacity_pages: int, num_objects: int | None = None,
                   sizes: np.ndarray | None = None,
                   use_kernel: bool | None = None, device=None):
    """Replay one policy on a uniform-size page trace. Returns (dollars, hits).

    `sizes` only affects the cost-density terms of GDS/GDSF/cost-Belady
    (the cache itself is page-uniform, matching the exact reference). Runs
    on CUDA unless `device` says otherwise."""
    d, h = sweep_torch(policy, ids, np.asarray(costs)[None, :],
                       np.array([capacity_pages]), num_objects, sizes,
                       use_kernel, device=device, return_hits=True)
    return float(d[0, 0]), int(h[0, 0])


def sweep_torch(policy, ids: np.ndarray, cost_matrix: np.ndarray,
                budgets: np.ndarray, num_objects: int | None = None,
                sizes: np.ndarray | None = None,
                use_kernel: bool | None = None,
                profile: dict | None = None, device=None,
                return_hits: bool = False):
    """Batched replay of a (policy x price-vector x budget) grid.

    policy:      one policy name -> dollars of shape (P, K); a sequence of
                 names / `PolicyWeights` (or a (Q, 6) stack) -> dollars of
                 shape (Q, P, K), all cells advanced by one step loop.
    cost_matrix: (P, N) per-object costs for P price vectors.
    budgets:     (K,) page budgets.
    use_kernel:  None -> the CUDA kernels on the card, the plain versions
                 on the CPU; False -> the plain versions on any device.
    profile:     pass a dict to get `compile_s` (building and loading the
                 kernel library; ~0 once loaded), `execute_s` (next(t) plus
                 the replay, synchronised) and `cells`.
    device:      None -> CUDA, raising when there is no card.
    return_hits: also return the hit counts, int32 of the same shape.
    """
    dev = resolve_device(device)
    use_k = dev.type == "cuda" if use_kernel is None else use_kernel
    stack = _policy_stack(policy)
    t0 = time.perf_counter()
    if use_k:
        _build.library()
    t1 = time.perf_counter()
    ids, ids_t, n, sizes_t, costs_t = _prepare(ids, cost_matrix, num_objects,
                                               sizes, dev)
    if costs_t.dim() != 2:
        raise ValueError("cost_matrix must have shape (P, N)")
    weights = carry.weight_stack(stack, dev)
    budgets_t = torch.as_tensor(np.asarray(budgets, dtype=np.int32),
                                device=dev)
    dollars, hits, _ = _replay(weights, ids, _next_use_host(ids_t, n, use_k),
                               costs_t, sizes_t, budgets_t, use_k)
    out, hit_counts = carry.to_numpy(dollars), carry.to_numpy(hits)
    t2 = time.perf_counter()
    if profile is not None:
        profile.update(compile_s=t1 - t0, execute_s=t2 - t1,
                       cells=int(out.size))
    if isinstance(policy, str):
        out, hit_counts = out[0], hit_counts[0]
    return (out, hit_counts) if return_hits else out
