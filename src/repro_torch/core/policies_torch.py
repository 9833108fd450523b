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
c = (q*P + p)*K + k. On the card (`use_kernel=None` -> the device is CUDA)
`sweep_torch` replays the whole grid in one launch of the `replay_scan`
kernel, each cell's scan on its own block, with next(t) and the frequency
rank from one `next_use` call handed over on the card. Its plain version,
taken on the CPU or with `use_kernel=False`, is `_replay`: one Python loop
over the T requests that advances all C cells at once. Each step does what the
reference's `step` does, in the same order and with the same float32
expressions written as separate ops (no fused multiply-add), so the CPU
and the card give the reference's bits wherever the reference's own
arithmetic is exact, and the kernel repeats them op for op.

The step loop is also the trajectory path (`_simulate(trace_steps=True)`,
the reference's step-for-step form): there the victim argmin goes through
`kernels.ops.evict_argmin`, the CUDA kernel on the card with
`use_kernel=True`.

Two units of budget, one entry point. Pages (`budget_unit="pages"`, the
exact reference's regime): every object takes one page, sizes enter only
the cost terms, and a miss with a full cache evicts one victim. Bytes
(`budget_unit="bytes"`, the paper's CDN arm, `policies.py`'s
`_simulate_priority` and `_simulate_oracle` in these float32 scores): each
object takes its whole-byte size; a miss of an object larger than the
budget is fetched through (billed, not admitted, nothing evicted, L
unchanged); any other miss evicts victims of least score, one after the
other, each setting GreedyDual's L, until the object fits, then is
admitted and scored with the current L. The bytes held are counted exactly
in integers. Where no cached object scores below 3.4e38 the miss is
fetched through, so a byte cache never holds more than its budget. With
every size 1 and a budget of B >= 1, the byte replay is the page replay
of B pages, bit for bit, wherever some cached score lies below 3.4e38.
On the card the byte grid is one launch of `replay_bytes_kernel`.

While a `torch.profiler` runs, `sweep_torch` opens a range for each of its
phases (`repro_torch.sweep`, then `.prepare`, `.next_use`, which on the
card writes the frequency rank too, `.replay`, `.copy_back`), on the clock
of the trace's kernels and copies. They are plain op ranges, not user
annotations, so the profiler copies none of them onto the device's
timeline; with no profiler running a range is one flag check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections.abc import Sequence

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from . import carry
from ..kernels import _build, ops
from ..kernels.replay_scan import replay_bytes_cuda, replay_scan_cuda

__all__ = ["PolicyWeights", "POLICY_WEIGHTS", "simulate_torch", "sweep_torch",
           "stack_policy_weights", "resolve_device"]

_BIG = 3.4e38
_NO_SPAN = contextlib.nullcontext()


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
    Integer sizes (N,) make it the byte replay: whole bytes, budgets (K,)
    int64 in bytes, and the scores read the sizes' float32 values.
    """
    dev = costs.device
    f32, i32 = torch.float32, torch.int32
    Q, (P, N), K, T = weights.shape[0], costs.shape, budgets.shape[0], len(ids)
    C = Q * P * K
    big = torch.tensor(_BIG, dtype=f32, device=dev)
    neg_big = torch.tensor(-_BIG, dtype=f32, device=dev)
    by_bytes = not sizes.is_floating_point()
    if by_bytes:
        size_of = sizes.to(torch.int64)
        size_host = size_of.cpu().numpy()
        sizes = sizes.to(f32)

    # per-policy weights, shaped to broadcast over (Q, P, K) and (Q, P, K, N)
    w = [weights[:, j].reshape(Q, 1, 1) for j in range(6)]
    w_bel, w_cb = w[4].unsqueeze(-1), w[5].unsqueeze(-1)
    gd_active = (w[2] + w[3]) > 0
    c_over_s = costs / torch.clamp_min(sizes, 1e-30)          # (P, N)
    cost_floor = torch.clamp_min(costs, 1e-30)                # (P, N)
    capacity = budgets.reshape(1, 1, K)

    cached = torch.zeros((Q, P, K, N), dtype=torch.bool, device=dev)
    static = torch.full((Q, P, K, N), _BIG, dtype=f32, device=dev)
    used = torch.zeros((Q, P, K), dtype=budgets.dtype, device=dev)
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
        if not by_bytes:
            victim, vscore = ops.evict_argmin(raw.view(C, N), touch,
                                              cached_rows,
                                              use_kernel=use_kernel)
            victim, vscore = victim.view(Q, P, K), vscore.view(Q, P, K)
            full = used >= capacity

            # eq.-(2) semantics: a miss always inserts (mandatory
            # displacement)
            admit = ~is_hit
            do_evict = admit & full & (vscore < big)
            # clear the victim's slot; cells that evict nothing clear
            # column i
            evicted = torch.where(do_evict, victim, i)
            cached_rows.scatter_(1, evicted.view(C, 1).to(torch.int64),
                                 False)
            # GreedyDual aging: L := priority of the evicted victim
            infl = torch.where(do_evict & gd_active, vscore, infl)
            used -= do_evict.to(i32)
            used += admit
        else:
            size_i = int(size_host[i])
            # a miss of an object larger than the budget is fetched through
            admit = ~is_hit & (capacity >= size_i)
            need = admit & (used + size_i > capacity)
            while bool(need.any()):   # evict until it fits, victim by victim
                victim, vscore = ops.evict_argmin(raw.view(C, N), touch,
                                                  cached_rows,
                                                  use_kernel=use_kernel)
                victim, vscore = victim.view(Q, P, K), vscore.view(Q, P, K)
                do_evict = need & (vscore < big)
                admit &= do_evict | ~need   # nothing to evict: fetch through
                evicted = torch.where(do_evict, victim, i)
                cached_rows.scatter_(1, evicted.view(C, 1).to(torch.int64),
                                     False)
                infl = torch.where(do_evict & gd_active, vscore, infl)
                used -= torch.where(do_evict, size_of[victim.long()], 0)
                need = do_evict & (used + size_i > capacity)
            used += torch.where(admit, size_i, 0)
        cos_i = cos_cols[i]
        my_static = (w[0] * tf + w[1] * fi
                     + w[2] * (infl + cos_i)
                     + w[3] * (infl + fi * cos_i))
        cached_i.copy_(is_hit | admit)
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


def _span(name: str = ""):
    """The profiler range `repro_torch.sweep<name>` while a profiler runs,
    else a shared no-op: one flag check, where even an unrecorded
    `record_function` costs microseconds. A `_RecordFunctionFast` range has
    the scope of an op: the profiler keeps it on the host and, unlike a
    `record_function` (a user annotation), copies none of it onto the
    device's timeline, where it would read as device work."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast("repro_torch.sweep" + name)


def _prepare(ids, costs, num_objects, sizes, dev, by_bytes=False):
    """The inputs on `dev`: ids, costs and the sizes, float32 for pages
    and int32 whole bytes for the byte replay."""
    ids = np.asarray(ids, dtype=np.int32)
    n = int(num_objects if num_objects is not None else ids.max() + 1)
    if len(ids) and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"ids must lie in [0, {n})")
    if by_bytes:
        if sizes is None:
            raise ValueError("the byte replay needs the objects' sizes")
        ids_t = torch.as_tensor(ids, device=dev)
        sizes_t = carry.byte_sizes(sizes, dev)
    else:
        ids_t, sizes_t = carry.trace_tensors(ids, sizes, dev, num_objects=n)
    costs_t = carry.cost_matrix(costs, dev)
    if costs_t.shape[-1] != n or sizes_t.shape != (n,):
        raise ValueError(f"costs and sizes must have {n} objects")
    return ids, ids_t, n, sizes_t, costs_t


def _budgets(budgets, by_bytes: bool) -> np.ndarray:
    """Page budgets as int32; byte budgets as int64, whole and >= 0."""
    if not by_bytes:
        return np.asarray(budgets, dtype=np.int32)
    b = np.asarray(budgets)
    if b.ndim != 1 or not np.array_equal(b, np.floor(b)) or (b < 0).any():
        raise ValueError("byte budgets must be whole numbers >= 0")
    return b.astype(np.int64)


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
                return_hits: bool = False, budget_unit: str = "pages"):
    """Batched replay of a (policy x price-vector x budget) grid.

    policy:      one policy name -> dollars of shape (P, K); a sequence of
                 names / `PolicyWeights` (or a (Q, 6) stack) -> dollars of
                 shape (Q, P, K).
    cost_matrix: (P, N) per-object costs for P price vectors.
    budgets:     (K,) budgets in `budget_unit`.
    budget_unit: "pages" (every object one page; sizes, ones if None, enter
                 the cost terms only) or "bytes" (each object takes its
                 size, which must be given in whole bytes below 2^31; see
                 the module's docstring). On the card "bytes" launches
                 `replay_bytes` in place of `replay_scan`.
    use_kernel:  None -> the CUDA kernels on the card (next(t) and the
                 frequency rank from one `next_use` call, then the whole
                 grid in one `replay_scan` launch, with no host step
                 between), the plain step loop on the CPU; False -> the
                 plain versions on any device.
    profile:     pass a dict to get `compile_s` (building and loading the
                 kernel library; ~0 once loaded), `execute_s` (next(t) plus
                 the replay, synchronised) and `cells`; on the kernel path
                 also `work`, the kernel's counters as int64 numpy of
                 dollars' shape plus a last axis in `WORK_COLUMNS` order
                 (`BYTE_WORK_COLUMNS` for bytes), copied back after the
                 results (none without `profile`); its last three columns
                 are the cell's launch: the block that replayed it (in a
                 grid of more cells than SMs, slowest rows first:
                 `replay_scan`'s launch order) and the block's start and
                 end in ns.
    device:      None -> CUDA, raising when there is no card.
    return_hits: also return the hit counts, int32 of the same shape.
    """
    if budget_unit not in ("pages", "bytes"):
        raise ValueError('budget_unit must be "pages" or "bytes"')
    by_bytes = budget_unit == "bytes"
    dev = resolve_device(device)
    use_k = dev.type == "cuda" if use_kernel is None else use_kernel
    if use_k and dev.type != "cuda":
        raise ValueError("use_kernel=True needs a CUDA device: the kernels "
                         "have no CPU mode")
    stack = _policy_stack(policy)
    t0 = time.perf_counter()
    if use_k:
        _build.library()
    t1 = time.perf_counter()
    with _span():
        with _span(".prepare"):
            ids, ids_t, n, sizes_t, costs_t = _prepare(
                ids, cost_matrix, num_objects, sizes, dev, by_bytes)
            if costs_t.dim() != 2:
                raise ValueError("cost_matrix must have shape (P, N)")
            weights = carry.weight_stack(stack, dev)
            budgets_t = torch.as_tensor(_budgets(budgets, by_bytes),
                                        device=dev)
        work = None
        if use_k:
            with _span(".next_use"):
                nxt_t, rank_t = ops.next_use(ids_t, n, use_kernel=True,
                                             with_rank=True)
            with _span(".replay"):
                replay = replay_bytes_cuda if by_bytes else replay_scan_cuda
                dollars, hits, work = replay(weights, ids_t, nxt_t, rank_t,
                                             costs_t, sizes_t, budgets_t)
        else:
            with _span(".next_use"):
                nxt_t = ops.next_use(ids_t, n, use_kernel=False)
            with _span(".replay"):
                dollars, hits, _ = _replay(weights, ids, _host_ints(nxt_t),
                                           costs_t, sizes_t, budgets_t,
                                           use_kernel=False)
        with _span(".copy_back"):
            out, hit_counts = carry.to_numpy(dollars), carry.to_numpy(hits)
            if profile is not None and work is not None:
                work = carry.to_numpy(work)
        t2 = time.perf_counter()
    if profile is not None:
        profile.update(compile_s=t1 - t0, execute_s=t2 - t1,
                       cells=int(out.size))
        if work is not None:
            profile["work"] = work[0] if isinstance(policy, str) else work
    if isinstance(policy, str):
        out, hit_counts = out[0], hit_counts[0]
    return (out, hit_counts) if return_hits else out
