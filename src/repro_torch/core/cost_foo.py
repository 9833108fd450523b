"""cost-FOO: flow/LP bracket on the dollar-optimum for variable sizes (paper §2).

General caching with variable sizes is NP-hard (Folwarczny & Sgall 2015).
The LP relaxation of the interval program (eq. 2) is a *fractional-caching
lower bound* on billed dollars — the dollar analogue of FOO (Berger et al.
2018). A feasible schedule upper-brackets the optimum. The pair is cost-FOO;
the paper reports a median bracket (U-L)/L of ~0.04 on synthetic traces.

  L = epoch-decomposed LP (fractional, via sparse HiGHS LPs)
  U = min( greedy rounding of the LP x ,  best feasible policy in dollars )

Scaling to CDN-length traces (DESIGN.md §4):

  * `round_fractional` runs on a lazy range-add/range-min segment tree over
    the *headroom* profile zcap - occ — feasibility of an interval is one
    O(log T) range-min instead of an O(L) occupancy slice, and committing
    it is one O(log T) range-add. The pre-PR quadratic path is kept as
    `round_fractional_reference`, the oracle the tree is asserted
    bit-identical against (tests/test_cost_foo_property.py).
  * The LP lower bound is epoch-decomposed à la PFOO (Berger et al.):
    overlapping epochs are solved concurrently (HiGHS releases the GIL);
    every interval is assigned to the last epoch that starts at or before
    it, intervals too long for any epoch are credited their savings for
    free in L (a relaxation — L stays a valid lower bound) and handed to
    the global rounding with x = 1 (they must still prove feasibility
    against the full-trace occupancy, so U stays a valid upper bound).
  * The rounded schedule can be re-validated end to end through the
    port's CUDA range-add/running-max scan (`kernels.occupancy_feasible`)
    on the card, or its plain PyTorch version on the CPU —
    `cost_foo(..., validate=True, device=...)`.

This is the port's copy of `src/repro/core/cost_foo.py`. Only the schedule
check differs (`_validate_schedule`, and `cost_foo`'s `use_kernel` and
`device` in place of `use_pallas`); the rest, docstrings aside, is the
reference's code.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time

import numpy as np
import torch

from ..kernels import ops
from . import policies as pol
from .opt_exact import (Interval, build_interval_arrays, interval_deltas,
                        lp_solve_arrays, zcap_profile)
from .policies_torch import resolve_device
from .trace import Trace

__all__ = ["CostFooResult", "cost_foo", "round_fractional",
           "round_fractional_reference"]

# epoch decomposition defaults: traces at or below the threshold are solved
# monolithically (one epoch == the pre-PR LP, bit-for-bit); above it, the
# LP is split into overlapping epochs solved concurrently
_INF = float("inf")

_EPOCH_AUTO_THRESHOLD = 25_000
_EPOCH_LEN_DEFAULT = 20_000


@dataclasses.dataclass
class CostFooResult:
    lower: float            # LP fractional lower bound on billed dollars
    upper: float            # best feasible schedule, billed dollars
    total_no_cache: float
    bracket: float          # (U - L) / L
    profile: dict = dataclasses.field(default_factory=dict)  # solver counters

    @property
    def is_tight(self) -> bool:
        return self.bracket <= 0.05


def _round_tol(B: float) -> float:
    """Feasibility slack of the rounding pass, relative to the byte budget.

    An absolute 1e-9 is spuriously strict at GB budgets (where one float
    ulp of the occupancy sum already exceeds it) and meaninglessly loose
    at unit budgets; 1e-9·B tracks the precision the occupancy arithmetic
    actually has.
    """
    return 1e-9 * max(1.0, float(B))


def _occupancy_feasible(extra: Interval, occ: np.ndarray, zcap: np.ndarray,
                        tol: float) -> bool:
    """Would adding `extra` keep occupancy within B - s_{o(tau)} everywhere?"""
    a, b = extra.t + 1, extra.u - 1
    if a > b:
        return True
    seg = occ[a:b + 1] + extra.size
    return bool((seg <= zcap[a:b + 1] + tol).all())


def round_fractional_reference(ids: np.ndarray, sizes: np.ndarray, B: float,
                               x: np.ndarray, paid: list[Interval]) -> float:
    """Quadratic rounding oracle: per-interval O(L) occupancy slices.

    The pre-segment-tree implementation, kept as the ground truth that
    `round_fractional` is asserted bit-identical against and as the
    baseline of the >=5x speedup gate in benchmarks/bench_costfoo.py.
    """
    T = len(ids)
    tol = _round_tol(B)
    zcap = np.zeros(T)
    for tau in range(1, T):
        s = sizes[ids[tau]]
        zcap[tau] = B - s if s <= B else B
    occ = np.zeros(T)
    order = sorted(range(len(paid)),
                   key=lambda j: (-float(x[j] > 0.999),
                                  -float(x[j]) * paid[j].save / max(paid[j].size, 1.0)))
    saved = 0.0
    for j in order:
        iv = paid[j]
        if x[j] <= 1e-9:
            continue
        if _occupancy_feasible(iv, occ, zcap, tol):
            occ[iv.t + 1:iv.u] += iv.size
            saved += iv.save
    return saved


class _HeadroomTree:
    """Lazy range-add / range-min segment tree over the headroom profile.

    Leaves are serving instants 1..T-1 holding zcap - occ; feasibility of
    an interval is one range-min >= size - tol and committing it is one
    range-add of -size — O(log T) each vs the O(L) slice of the reference
    path. Representation: mn[v] is the min of v's subtree EXCLUDING pending
    adds at strict ancestors; add[v] is the add pending on all of v's
    subtree; so the true min of v's subtree is mn[v] + sum of add[] over
    v's strict ancestors. Plain Python lists beat numpy here — every op
    touches O(log T) scalars.
    """

    __slots__ = ("size", "mn", "add")

    def __init__(self, headroom: np.ndarray):
        n = max(1, len(headroom))
        size = 1
        while size < n:
            size <<= 1
        self.size = size
        mn = [float("inf")] * (2 * size)
        mn[size:size + len(headroom)] = [float(v) for v in headroom]
        for i in range(size - 1, 0, -1):
            mn[i] = mn[2 * i] if mn[2 * i] < mn[2 * i + 1] else mn[2 * i + 1]
        self.mn = mn
        self.add = [0.0] * (2 * size)

    def range_min(self, l: int, r: int, stop: float = -_INF) -> float:
        """Min headroom over leaves [l, r], inclusive.

        `stop` is an early-exit threshold: every pending add is <= 0 (the
        tree only ever commits -size), so a partially accumulated border
        value only DECREASES as the walk ascends — the moment it dips
        below `stop` the true range min is certainly below `stop` too, and
        that partial value (an upper bound still < stop) is returned. The
        exact min is returned whenever it is >= stop, so feasibility
        decisions `range_min(l, r, thr) >= thr` are identical to the
        exact-min ones.
        """
        mn, add = self.mn, self.add
        l += self.size
        r += self.size
        if l == r:
            res = mn[l]
            l >>= 1
            while l:
                res += add[l]
                l >>= 1
            return res
        resl, resr = mn[l], mn[r]
        lp = l >> 1
        rp = r >> 1
        while lp != rp:
            if not l & 1:
                v = mn[l + 1]
                if v < resl:
                    resl = v
            if r & 1:
                v = mn[r - 1]
                if v < resr:
                    resr = v
            resl += add[lp]
            resr += add[rp]
            v = resl if resl < resr else resr
            if v < stop:
                return v
            l = lp
            r = rp
            lp >>= 1
            rp >>= 1
        res = resl if resl < resr else resr
        while lp:
            res += add[lp]
            if res < stop:
                return res
            lp >>= 1
        return res

    def find_below(self, l: int, r: int, thr: float):
        """Locate a witness: any leaf in [l, r] with true value < thr.

        Returns (leaf, value) — value is the leaf's exact current
        headroom — or (-1, inf) when every leaf in range is >= thr.
        Guided descent: a subtree whose true min (mn[v] + strict-ancestor
        adds) is >= thr cannot contain a witness and is pruned.
        """
        mn, add = self.mn, self.add
        size = self.size
        stack = [(1, 0, size - 1, 0.0)]
        while stack:
            v, lo, hi, acc = stack.pop()
            if hi < l or lo > r or mn[v] + acc >= thr:
                continue
            if lo == hi:
                return lo, mn[v] + acc
            mid = (lo + hi) >> 1
            acc += add[v]
            stack.append((2 * v + 1, mid + 1, hi, acc))
            stack.append((2 * v, lo, mid, acc))
        return -1, _INF

    def range_add(self, l: int, r: int, v: float) -> None:
        """Add v to every leaf in [l, r], inclusive."""
        mn, add = self.mn, self.add
        l += self.size
        r += self.size
        mn[l] += v
        add[l] += v
        if l != r:
            mn[r] += v
            add[r] += v
            lp = l >> 1
            rp = r >> 1
            while lp != rp:
                if not l & 1:
                    mn[l + 1] += v
                    add[l + 1] += v
                if r & 1:
                    mn[r - 1] += v
                    add[r - 1] += v
                c = lp + lp
                a = mn[c]
                b = mn[c + 1]
                mn[lp] = (a if a < b else b) + add[lp]
                c = rp + rp
                a = mn[c]
                b = mn[c + 1]
                mn[rp] = (a if a < b else b) + add[rp]
                l = lp
                r = rp
                lp >>= 1
                rp >>= 1
            l = lp
        else:
            l >>= 1
        while l:
            c = l + l
            a = mn[c]
            b = mn[c + 1]
            mn[l] = (a if a < b else b) + add[l]
            l >>= 1


def _round_arrays(pt: np.ndarray, pu: np.ndarray, psave: np.ndarray,
                  psize: np.ndarray, x: np.ndarray, zcap: np.ndarray,
                  tol: float):
    """Segment-tree rounding over flat interval arrays.

    Same greedy as the reference — identical ordering keys (evaluated with
    the exact same float expression shapes) and identical feasibility
    predicate, re-expressed as headroom range-mins — so accepted sets and
    the saved-dollar sum match the oracle bit for bit when the occupancy
    arithmetic is exact (integer-valued sizes). Returns (saved, accepted
    interval indices).
    """
    m = len(pt)
    if m == 0:
        return 0.0, []
    # reference key: (-(x > 0.999), -x * save / max(size, 1)); lexsort is
    # stable ascending with the LAST key primary, matching sorted()
    dens = (-x) * psave / np.maximum(psize, 1.0)
    pref = -(x > 0.999).astype(np.float64)
    order = np.lexsort((dens, pref))
    tree = _HeadroomTree(zcap[1:])   # leaf k = instant k+1
    mn = tree.mn
    range_min = tree.range_min
    range_add = tree.range_add
    find_below = tree.find_below
    l_arr = pt.tolist()              # covers instants t+1..u-1 = leaves t..u-2
    r_arr = (pu - 2).tolist()
    sv = psave.tolist()
    sz = psize.tolist()
    xv = x.tolist()
    saved = 0.0
    accepted: list[int] = []
    # bottleneck cache: a known instant and its EXACT current headroom
    # (kept exact by debiting covering accepts). Adds only ever decrease
    # headroom, so "bad_tau in range and bad_h < s - tol" proves the range
    # min is < s - tol without walking the tree — O(1) rejects once the
    # profile saturates (the common case on scan-like traffic). Witness
    # probes cost a walk themselves, so they back off exponentially on
    # workloads where cached bottlenecks never land inside later ranges
    bad_tau = -1
    bad_h = _INF
    probe_gap = 1                    # walk-rejects until the next probe
    since_probe = 0
    cache_hit = False
    for j in order.tolist():
        if xv[j] <= 1e-9:
            continue
        l = l_arr[j]
        r = r_arr[j]
        s = sz[j]
        if l > r:                    # no interior instant: free to keep
            saved += sv[j]
            accepted.append(j)
            continue
        thr = s - tol
        if l <= bad_tau <= r and bad_h < thr:
            cache_hit = True
            continue                 # bottleneck proves infeasibility
        # mn[1] is the global min headroom (the root has no ancestors):
        # while the cache is loosely packed the range query short-circuits;
        # once packed, the threshold lets the walk abort mid-climb
        if mn[1] >= thr or range_min(l, r, thr) >= thr:
            range_add(l, r, -s)
            saved += sv[j]
            accepted.append(j)
            if l <= bad_tau <= r:
                bad_h -= s
        else:
            since_probe += 1
            if since_probe >= probe_gap:
                bad_tau, bad_h = find_below(l, r, thr)
                probe_gap = 1 if cache_hit else min(probe_gap * 2, 256)
                cache_hit = False
                since_probe = 0
    return saved, accepted


def round_fractional(ids: np.ndarray, sizes: np.ndarray, B: float,
                     x: np.ndarray, paid: list[Interval],
                     return_accepted: bool = False):
    """PFOO-like rounding: greedily retain gaps by LP preference (x, then
    dollar density), keeping the occupancy profile feasible. Returns the
    dollars *saved* by the resulting feasible schedule (and the accepted
    interval indices when `return_accepted`).

    O((T + m) log T) on the headroom segment tree; see
    `round_fractional_reference` for the O(T·L) oracle it replays exactly.
    """
    ids = np.asarray(ids)
    m = len(paid)
    pt = np.fromiter((iv.t for iv in paid), np.int64, m)
    pu = np.fromiter((iv.u for iv in paid), np.int64, m)
    ps = np.fromiter((iv.save for iv in paid), np.float64, m)
    pz = np.fromiter((iv.size for iv in paid), np.float64, m)
    zcap = zcap_profile(ids, sizes, B)
    saved, accepted = _round_arrays(pt, pu, ps, pz, np.asarray(x, np.float64),
                                    zcap, _round_tol(B))
    return (saved, accepted) if return_accepted else saved


def _epoch_plan(T: int, epoch_len: int, overlap: float):
    """(stride, epoch count) for the overlapping-epoch decomposition."""
    epoch_len = max(2, min(int(epoch_len), T))
    if epoch_len >= T:
        return T, 1, epoch_len
    stride = max(1, int(round(epoch_len * (1.0 - overlap))))
    return stride, (T - 1) // stride + 1, epoch_len


def cost_foo(trace: Trace, costs: np.ndarray, B: float,
             policies: tuple[str, ...] = ("gdsf", "gds", "cost_belady", "belady"),
             epoch_len: int | None = None, epoch_overlap: float = 0.5,
             max_workers: int | None = None, validate: bool = False,
             use_kernel: bool | None = None, device=None) -> CostFooResult:
    """Bracket OPT-dollars on a variable-size trace (DESIGN.md §4).

    `epoch_len=None` solves monolithically up to T=25k and decomposes into
    overlapping 20k epochs beyond that; pass an explicit `epoch_len` to
    force either. `validate=True` replays the rounded schedule through the
    occupancy-feasibility scan on `device` (the card unless the caller
    names one; with no device and no card it raises) and asserts it never
    exceeds zcap: the CUDA kernel for a CUDA device, its plain PyTorch
    version on the CPU, as `ops.occupancy_feasible` dispatches
    (`use_kernel`). Everything else runs on the host.
    """
    dev = resolve_device(device) if validate else None
    t_start = time.perf_counter()
    ids = np.asarray(trace.ids)
    sizes = np.asarray(trace.sizes, np.float64)
    costs = np.asarray(costs, np.float64)
    T = len(ids)
    B = float(B)
    total = float(costs[ids].sum()) if T else 0.0
    t_arr, u_arr, obj, save, size = build_interval_arrays(ids, costs, sizes)
    fits = size <= B
    free_save = float(save[fits & (u_arr == t_arr + 1)].sum())
    paidm = fits & (u_arr > t_arr + 1)
    pt, pu = t_arr[paidm], u_arr[paidm]
    ps, pz = save[paidm], size[paidm]
    m = len(pt)
    if epoch_len is None:
        epoch_len = T if T <= _EPOCH_AUTO_THRESHOLD else _EPOCH_LEN_DEFAULT
    profile: dict = dict(requests=int(T), paid_intervals=int(m))
    if m == 0 or T <= 1:
        lower = upper = total - free_save
        for p in policies:
            upper = min(upper, pol.simulate(p, trace, costs, B).dollars)
        upper = max(upper, lower)
        bracket = (upper - lower) / max(lower, 1e-12)
        return CostFooResult(lower, upper, total, bracket, profile)

    zcap = zcap_profile(ids, sizes, B)
    stride, n_epochs, epoch_len = _epoch_plan(T, epoch_len, epoch_overlap)
    profile.update(epochs=int(n_epochs), epoch_len=int(epoch_len),
                   stride=int(stride))

    # stitching rule (DESIGN.md §4): each interval goes to the LAST epoch
    # starting at or before its t (maximal right headroom); intervals whose
    # gap outlives the epoch overlap are "crossing" — free savings credit
    # in L (relaxation), x = 1/2 into the global rounding for U: positive,
    # so they can fill leftover headroom by dollar density, but OUTSIDE the
    # preferred x≈1 class — no epoch LP accounted for their load, and at
    # x = 1 they crowd out the LPs' chosen intervals during rounding
    k_j = np.minimum(pt // stride, n_epochs - 1)
    e_per = np.minimum(k_j * stride + epoch_len, T)
    contained = pu < e_per
    crossing_save = float(ps[~contained].sum())
    profile["crossing_intervals"] = int((~contained).sum())

    t_lp = time.perf_counter()
    x = np.zeros(m)
    x[~contained] = 0.5
    jobs = []
    for k in range(n_epochs):
        a = k * stride
        e = min(a + epoch_len, T)
        sel = np.flatnonzero(contained & (k_j == k))
        if len(sel) and e - a > 1:
            jobs.append((a, e, sel))

    def _solve(job):
        a, e, sel = job
        return sel, lp_solve_arrays(pt[sel] - a, pu[sel] - a, ps[sel],
                                    pz[sel], zcap[a + 1:e], e - a - 1)

    if len(jobs) <= 1 or (max_workers is not None and max_workers <= 1):
        results = [_solve(j) for j in jobs]
    else:
        workers = min(len(jobs), max_workers or (os.cpu_count() or 1))
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            results = list(ex.map(_solve, jobs))
    lp_savings = 0.0
    for sel, (sav, xk) in results:
        lp_savings += sav
        x[sel] = xk
    lower = total - (lp_savings + crossing_save + free_save)
    profile["lp_seconds"] = time.perf_counter() - t_lp

    t_round = time.perf_counter()
    rounded_save, accepted = _round_arrays(pt, pu, ps, pz, x, zcap,
                                           _round_tol(B))
    profile["round_seconds"] = time.perf_counter() - t_round
    profile["rounded_intervals"] = len(accepted)
    if validate and accepted:
        _validate_schedule(pt, pu, pz, accepted, zcap, T, B, use_kernel, dev)

    upper = total - (rounded_save + free_save)
    for p in policies:
        upper = min(upper, pol.simulate(p, trace, costs, B).dollars)
    upper = max(upper, lower)  # numerical guard
    bracket = (upper - lower) / max(lower, 1e-12)
    profile["total_seconds"] = time.perf_counter() - t_start
    return CostFooResult(lower, upper, total, bracket, profile)


def _validate_schedule(pt, pu, pz, accepted, zcap, T, B, use_kernel,
                       device):
    """Replay the accepted schedule through the occupancy scan on `device`.

    The deltas are built on the host in float64 and cast to float32, as in
    the reference. The scan's occupancies are float32, so the tolerance is
    the float32 precision of a B-sized running sum, not the rounding pass's
    own 1e-9·B.
    """
    acc = np.asarray(accepted, np.int64)
    deltas = interval_deltas(pt[acc], pu[acc], pz[acc], T)
    _, excess = ops.occupancy_feasible(
        torch.as_tensor(deltas.astype(np.float32), device=device),
        torch.as_tensor(np.asarray(zcap).astype(np.float32), device=device),
        use_kernel=use_kernel)
    tol = max(_round_tol(B), 1e-4 * max(1.0, B))
    if float(excess) > tol:
        raise AssertionError(
            f"rounded schedule exceeds zcap by {float(excess):.6g} "
            f"(tolerance {tol:.6g})")


def _free_intervals(trace: Trace, costs: np.ndarray, B: float) -> list[Interval]:
    from .opt_exact import build_intervals
    ivs = build_intervals(trace.ids, costs, trace.sizes)
    return [iv for iv in ivs if iv.u == iv.t + 1 and iv.size <= B]
