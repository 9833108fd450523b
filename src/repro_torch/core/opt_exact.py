"""The exact offline dollar-optimum (paper §2).

For each request t whose object recurs at next(t), a binary x_t decides
whether the object is retained across the gap (a hit at next(t), saving
c_{o(t)}), occupying capacity at every *interior* serving instant:

    s_{o(tau)} + sum_{t < tau < next(t)} s_{o(t)} x_t  <=  B      (eq. 2)

Uniform sizes -> consecutive-ones constraint matrix -> totally unimodular ->
the LP relaxation is integral, and the optimum equals a min-cost flow on the
time line: shelf arcs of capacity B-1 and one unit-capacity arc per reuse
gap with cost -c_i.

This module provides three mutually-validating solvers:

  * `exact_opt_uniform`    — successive-shortest-path min-cost flow on flat
                             CSR numpy arrays, shortest paths by scipy's C
                             Dijkstra (paper's scalable exact form)
  * `exact_opt_uniform_sweep`
                           — the parametric form: ONE warm-started SSP run
                             answers every budget in a grid at roughly the
                             cost of the largest single solve (DESIGN.md §5)
  * `lp_opt`               — the interval LP in an O(T)-nonzero difference
                             form, solved by scipy/HiGHS (covers variable
                             sizes too, where it is the cost-FOO *fractional*
                             lower bound)
  * `dp_opt_uniform`,
    `enumerate_opt_uniform`— brute-force oracles for tiny instances (tests)

Total billed cost of a schedule = sum_t c_{o(t)}  -  savings(selected hits).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .trace import next_use_indices

__all__ = [
    "Interval",
    "build_intervals",
    "build_interval_arrays",
    "interval_deltas",
    "zcap_profile",
    "OptResult",
    "SweepResult",
    "exact_opt_uniform",
    "exact_opt_uniform_sweep",
    "lp_opt",
    "lp_solve_arrays",
    "dp_opt_uniform",
    "enumerate_opt_uniform",
]


@dataclasses.dataclass(frozen=True)
class Interval:
    t: int      # request index of this access
    u: int      # next access of the same object (u < T)
    obj: int    # object id
    save: float  # dollars saved if retained (c_obj)
    size: float  # bytes occupied while retained


def build_interval_arrays(ids: np.ndarray, costs: np.ndarray,
                          sizes: np.ndarray):
    """Vectorized reuse-gap extraction: flat (t, u, obj, save, size) arrays.

    The array form of `build_intervals` — shared by the LP's difference-form
    matrix construction, the epoch decomposition in `cost_foo`, and
    `interval_deltas` (the occupancy kernel's input). One `next_use_indices`
    pass plus boolean masks instead of a Python loop over T.
    """
    ids = np.asarray(ids)
    nxt = next_use_indices(ids)
    T = len(ids)
    keep = nxt < T
    t = np.flatnonzero(keep).astype(np.int64)
    u = nxt[keep].astype(np.int64)
    obj = ids[keep].astype(np.int64)
    save = np.asarray(costs, np.float64)[obj]
    size = np.asarray(sizes, np.float64)[obj]
    return t, u, obj, save, size


def build_intervals(ids: np.ndarray, costs: np.ndarray,
                    sizes: np.ndarray) -> list[Interval]:
    """All reuse gaps (t, next(t)) with next(t) < T."""
    t, u, obj, save, size = build_interval_arrays(ids, costs, sizes)
    return [Interval(a, b, o, sv, sz)
            for a, b, o, sv, sz in zip(t.tolist(), u.tolist(), obj.tolist(),
                                       save.tolist(), size.tolist())]


def interval_deltas(t: np.ndarray, u: np.ndarray, size: np.ndarray,
                    T: int) -> np.ndarray:
    """Per-instant occupancy deltas of a retention schedule.

    Interval (t, u) occupies serving instants t+1..u-1, so it contributes
    +size at index t+1 and -size at index u; the prefix sum of the result
    is eq. (2)'s LHS occupancy profile — feed it to
    `kernels.interval_occupancy` / `kernels.occupancy_feasible`.
    """
    d = np.zeros(int(T), np.float64)
    t = np.asarray(t, np.int64)
    u = np.asarray(u, np.int64)
    size = np.asarray(size, np.float64)
    starts = t + 1
    sm = starts < T
    np.add.at(d, starts[sm], size[sm])
    em = u < T
    np.add.at(d, u[em], -size[em])
    return d


def zcap_profile(ids: np.ndarray, sizes: np.ndarray, B: float) -> np.ndarray:
    """Occupancy cap per serving instant (eq. 2's RHS), vectorized.

    zcap[tau] = B - s_{o(tau)} while the served object fits, else B
    (fetch-through: an over-budget object never occupies the cache).
    Index 0 is a placeholder set to B — there is no constraint before the
    first request.
    """
    ids = np.asarray(ids)
    s_at = np.asarray(sizes, np.float64)[ids]
    zcap = np.where(s_at <= B, B - s_at, float(B))
    if len(zcap):
        zcap[0] = float(B)
    return zcap


@dataclasses.dataclass
class OptResult:
    dollars: float            # total billed cost under the optimum
    savings: float            # dollars saved vs caching nothing
    total_no_cache: float     # sum of all c_{o(t)}
    hits: int                 # number of retained gaps (incl. free ones)
    selected: list[Interval]  # retained gaps (excl. trivially-free ones)
    free_hits: int            # gaps with no interior instant (always kept)
    profile: dict = dataclasses.field(default_factory=dict)  # solver counters


# ---------------------------------------------------------------------------
# min-cost flow (successive shortest paths with Johnson potentials)
#
# Flat-array engine: arcs live in paired numpy arrays (edge i and i^1 are
# duals), adjacency is CSR-style (edges lexsorted by (src, dst), grouped),
# and each shortest-path phase runs through scipy's C Dijkstra on reduced
# costs. Saturated arcs are not removed from the CSR structure — their
# weight is set to _BLOCKED, far above any real path cost, so the sparsity
# pattern (and the per-(src,dst) dedup below) is computed exactly once.
# ---------------------------------------------------------------------------

_BLOCKED = 1e18          # weight of a saturated arc in the Dijkstra graph
_BLOCK_THRESH = 1e17     # any dist above this means "no residual path"


@dataclasses.dataclass
class SweepResult:
    """Exact OPT for every budget in a grid, from ONE parametric SSP run."""
    budgets: np.ndarray        # (K,) int   — page budgets B
    dollars: np.ndarray        # (K,) float — exact billed cost at each B
    savings: np.ndarray        # (K,) float — dollars saved vs caching nothing
    hits: np.ndarray           # (K,) int   — retained gaps (incl. free ones)
    total_no_cache: float      # sum of all c_{o(t)}
    free_hits: int             # gaps with no interior instant (always kept)
    unit_path_costs: np.ndarray  # per-unit SSP path costs (non-decreasing)
    profile: dict = dataclasses.field(default_factory=dict)  # solver counters


class _ParametricSSP:
    """Successive shortest paths on the caching time line, budget-parametric.

    Nodes are serving instants 1..T-1 (index p-1) plus the sink instant T
    (index T-1); shelf arcs (p-1 -> p, capacity k_max, cost 0) and one unit
    arc per paid reuse gap (node t -> node u-1, cost -save).

    Why one run answers every budget: with flow value bounded by k, the flow
    through any shelf arc is at most k (every cut carries exactly the total
    flow, and interval arcs take their share first), so the shelf capacity
    never binds and the ONLY budget-dependent quantity is the flow bound
    itself. SSP augments along non-decreasing path costs, hence the optimal
    flow of value k is, for every k, a prefix of the same augmentation
    sequence — raising the budget just unlocks the next units. Recording the
    per-unit path costs therefore yields exact OPT for all budgets at once.
    """

    def __init__(self, T: int, paid_t: np.ndarray, paid_u: np.ndarray,
                 paid_save: np.ndarray, k_max: int):
        # profiling counters (DESIGN.md §9): surfaced via OptResult/
        # SweepResult `.profile` so operators can see where solve time went
        self.dijkstra_calls = 0
        self.augmentations = 0
        self.n = n = T
        self.s, self.t = 0, T - 1
        self.m = m = len(paid_t)
        self.eps = 1e-12 * max(1.0, float(paid_save.max()) if m else 1.0)
        ns = T - 1  # shelf arcs
        ne = 2 * (ns + m)
        shelf_src = np.arange(ns, dtype=np.int64)
        fwd_src = np.concatenate([shelf_src, paid_t.astype(np.int64)])
        fwd_dst = np.concatenate([shelf_src + 1, paid_u.astype(np.int64) - 1])
        fwd_cap = np.concatenate([np.full(ns, float(k_max)), np.ones(m)])
        fwd_cost = np.concatenate([np.zeros(ns), -paid_save.astype(np.float64)])
        self.frm = np.empty(ne, np.int64)
        self.to = np.empty(ne, np.int64)
        self.cap = np.empty(ne, np.float64)
        self.cost = np.empty(ne, np.float64)
        self.frm[0::2] = fwd_src; self.to[0::2] = fwd_dst
        self.cap[0::2] = fwd_cap; self.cost[0::2] = fwd_cost
        self.frm[1::2] = fwd_dst; self.to[1::2] = fwd_src
        self.cap[1::2] = 0.0;     self.cost[1::2] = -fwd_cost
        self.first_interval_edge = 2 * ns  # interval fwd arcs: even ids >= this

        # CSR with per-(src,dst) dedup. Parallel arcs happen only when a gap
        # has exactly one interior instant (interval arc t -> t+1 alongside
        # the shelf arc), so every group has at most two members.
        order = np.lexsort((self.to, self.frm))
        key = self.frm[order] * np.int64(n) + self.to[order]
        first = np.ones(len(key), bool)
        first[1:] = key[1:] != key[:-1]
        starts = np.flatnonzero(first)
        sizes = np.diff(np.append(starts, len(key)))
        assert sizes.max(initial=1) <= 2, "unexpected arc multiplicity"
        self.grp_keys = key[starts]
        self.grp_e0 = order[starts]
        self.grp_e1 = np.where(sizes == 2, order[np.minimum(starts + 1,
                                                            len(key) - 1)], -1)
        src_of_grp = self.frm[self.grp_e0]
        counts = np.bincount(src_of_grp, minlength=n)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        self.indices = self.to[self.grp_e0].astype(np.int32)

        # exact initial potentials: one relaxation pass in topological order
        # (the original graph is a DAG on the time line)
        pot = np.zeros(n)
        by_dst = np.argsort(paid_u, kind="stable") if m else np.zeros(0, int)
        ptr = 0
        for p in range(1, n):
            lo = pot[p - 1]
            while ptr < m and int(paid_u[by_dst[ptr]]) - 1 == p:
                j = by_dst[ptr]
                cand = pot[int(paid_t[j])] - float(paid_save[j])
                if cand < lo:
                    lo = cand
                ptr += 1
            pot[p] = lo
        self.pot = pot

    def run(self, max_units: int) -> tuple[np.ndarray, np.ndarray]:
        """Augment unit-by-unit until `max_units` is reached or the shortest
        residual path stops saving dollars. Returns (unit_path_costs,
        unit_net_selected): per flow unit, its true path cost and the net
        number of interval arcs it newly saturates (reverse traversals of
        earlier selections count -1 — one unit can carry several short gaps
        or re-route earlier ones)."""
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra

        n, s, t = self.n, self.s, self.t
        unit_costs: list[float] = []
        unit_dsel: list[int] = []
        remaining = max_units
        while remaining > 0:
            rc = self.cost + self.pot[self.frm] - self.pot[self.to]
            w = np.where(self.cap > 0.5, rc, _BLOCKED)
            data = w[self.grp_e0]
            two = self.grp_e1 >= 0
            np.minimum(data, np.where(two, w[self.grp_e1], _BLOCKED),
                       out=data)
            np.maximum(data, 0.0, out=data)  # clip fp jitter in reduced costs
            g = csr_matrix((data, self.indices, self.indptr), shape=(n, n))
            self.dijkstra_calls += 1
            dist, pred = dijkstra(g, directed=True, indices=s,
                                  return_predecessors=True)
            dt = float(dist[t])
            if dt >= _BLOCK_THRESH:
                break
            path_cost = dt + self.pot[t] - self.pot[s]
            if path_cost >= -self.eps:
                break  # no more negative (dollar-saving) paths
            self.pot += np.minimum(dist, dt)  # Johnson update, clamped at sink
            # node path sink -> source, then per-hop arc selection
            nodes = [t]
            b = t
            while b != s:
                b = int(pred[b])
                nodes.append(b)
            hops = np.array(nodes[::-1], dtype=np.int64)
            a_arr, b_arr = hops[:-1], hops[1:]
            gidx = np.searchsorted(self.grp_keys, a_arr * np.int64(n) + b_arr)
            e0 = self.grp_e0[gidx]
            e1 = self.grp_e1[gidx]
            use1 = (e1 >= 0) & (w[np.maximum(e1, 0)] < w[e0])
            edges = np.where(use1, e1, e0)
            f = min(float(remaining), float(self.cap[edges].min()))
            # a dollar-saving path always crosses a unit interval arc
            assert f == 1.0, f"non-unit bottleneck {f} on a negative path"
            self.cap[edges] -= f
            self.cap[edges ^ 1] += f
            is_iv = edges >= self.first_interval_edge
            dsel = int(np.sum(is_iv & (edges % 2 == 0))
                       - np.sum(is_iv & (edges % 2 == 1)))
            unit_costs.append(path_cost)
            unit_dsel.append(dsel)
            remaining -= 1
        self.augmentations += len(unit_costs)
        return np.asarray(unit_costs), np.asarray(unit_dsel, dtype=np.int64)

    def profile(self, budgets_answered: int = 1) -> dict:
        """Solver counters: how the exact answer was produced. A sweep
        answers `budgets_answered` budgets from this ONE augmentation
        sequence — that ratio is the warm-start reuse."""
        return dict(dijkstra_calls=self.dijkstra_calls,
                    augmentations=self.augmentations,
                    nodes=int(self.n), paid_intervals=int(self.m),
                    budgets_answered=int(budgets_answered),
                    warm_start_reuse=float(budgets_answered))

    def saturated_intervals(self) -> np.ndarray:
        """Indices j of paid intervals whose unit arc is saturated."""
        iv_caps = self.cap[self.first_interval_edge::2]
        return np.flatnonzero(iv_caps < 0.5)


def _paid_free_arrays(ids: np.ndarray, costs: np.ndarray):
    """Vectorized interval extraction: (paid_t, paid_u, paid_save, free_save,
    n_free, total)."""
    ids = np.asarray(ids)
    T = len(ids)
    save = np.asarray(costs, dtype=np.float64)[ids] if T else np.zeros(0)
    total = float(save.sum())
    nxt = next_use_indices(ids)
    t_arr = np.arange(T, dtype=np.int64)
    recurs = nxt < T
    free = recurs & (nxt == t_arr + 1)
    paid = recurs & (nxt > t_arr + 1)
    return (t_arr[paid], nxt[paid], save[paid],
            float(save[free].sum()), int(free.sum()), total)


def exact_opt_uniform(ids: np.ndarray, costs: np.ndarray, B: int,
                      return_selected: bool = False) -> OptResult:
    """Exact dollar-optimum for uniform-size pages via min-cost flow.

    Nodes = serving instants 1..T-1 plus sink T; shelf arcs p->p+1 with
    capacity B-1 (cost 0); a unit arc (t+1)->u with cost -c_i per reuse gap.
    Gaps with no interior instant (u == t+1) are free and always retained.
    """
    ids = np.asarray(ids)
    T = len(ids)
    if B < 1 or T == 0:
        total = float(np.asarray(costs)[ids].sum()) if T else 0.0
        return OptResult(total, 0.0, total, 0, [], 0)
    paid_t, paid_u, paid_save, free_save, n_free, total = \
        _paid_free_arrays(ids, costs)
    k = B - 1
    if k == 0 or len(paid_t) == 0:
        dollars = total - free_save
        return OptResult(dollars, free_save, total, n_free, [], n_free)
    ssp = _ParametricSSP(T, paid_t, paid_u, paid_save, k)
    unit_costs, _ = ssp.run(k)
    savings = float(-unit_costs.sum()) + free_save
    sel_idx = ssp.saturated_intervals()
    selected = []
    if return_selected:
        selected = [Interval(int(paid_t[j]), int(paid_u[j]), int(ids[paid_t[j]]),
                             float(paid_save[j]), 1.0) for j in sel_idx]
    dollars = total - savings
    return OptResult(dollars, savings, total, n_free + len(sel_idx),
                     selected, n_free, profile=ssp.profile())


def exact_opt_uniform_sweep(ids: np.ndarray, costs: np.ndarray,
                            budgets: np.ndarray) -> SweepResult:
    """Exact dollar-optimum for EVERY budget in `budgets`, one SSP run.

    Warm start along the budget axis: the residual graph after k units of
    flow is exactly the state a (k+1)-budget solve would resume from, so the
    sweep costs roughly one solve at max(budgets) instead of len(budgets)
    independent solves (see `_ParametricSSP` for why capacities never bind).

    Matches per-budget `exact_opt_uniform` to float precision; asserted at
    1e-6 relative in tests and bench_flow_scale.
    """
    budgets = np.asarray(budgets, dtype=np.int64)
    if budgets.ndim != 1 or len(budgets) == 0:
        raise ValueError("budgets must be a non-empty 1-D array")
    ids = np.asarray(ids)
    T = len(ids)
    K = len(budgets)
    paid_t, paid_u, paid_save, free_save, n_free, total = \
        _paid_free_arrays(ids, costs)
    k_max = int(budgets.max()) - 1
    if T == 0 or k_max < 1 or len(paid_t) == 0:
        unit_costs = np.zeros(0)
        unit_dsel = np.zeros(0, np.int64)
        profile = dict(dijkstra_calls=0, augmentations=0, nodes=int(T),
                       paid_intervals=int(len(paid_t)),
                       budgets_answered=int(K), warm_start_reuse=float(K))
    else:
        ssp = _ParametricSSP(T, paid_t, paid_u, paid_save, k_max)
        unit_costs, unit_dsel = ssp.run(k_max)
        profile = ssp.profile(budgets_answered=K)
    cum_save = np.concatenate([[0.0], np.cumsum(-unit_costs)])
    cum_sel = np.concatenate([[0], np.cumsum(unit_dsel)])
    ks = np.clip(budgets - 1, 0, len(unit_costs))
    alive = budgets >= 1  # B < 1 cannot even keep free (adjacent) repeats
    savings = np.where(alive, cum_save[ks] + free_save, 0.0)
    hits = np.where(alive, cum_sel[ks] + n_free, 0).astype(np.int64)
    return SweepResult(budgets=budgets, dollars=total - savings,
                       savings=savings, hits=hits, total_no_cache=total,
                       free_hits=n_free, unit_path_costs=unit_costs,
                       profile=profile)


# ---------------------------------------------------------------------------
# sparse interval LP (difference form) — uniform exact / variable fractional
# ---------------------------------------------------------------------------

def lp_solve_arrays(pt: np.ndarray, pu: np.ndarray, psave: np.ndarray,
                    psize: np.ndarray, zcap: np.ndarray, nz: int):
    """Difference-form interval LP (eq. 2's relaxation) over local instants.

    The array core behind `lp_opt` and `cost_foo`'s epoch decomposition:
    interval j occupies instants pt[j]+1..pu[j]-1 (1-based local instants,
    so 0 <= pt[j] and pu[j]-1 <= nz); zcap[k] caps occupancy at instant
    k+1 (length nz). Matrix construction is fully vectorized — 2 nonzeros
    per variable, assembled with numpy concatenates instead of per-row
    Python appends. Returns (savings_upper_bound, x_fractional).
    """
    from scipy import sparse
    from scipy.optimize import linprog

    m = len(pt)
    if m == 0 or nz <= 0:
        return 0.0, np.zeros(0)
    # conditioning: cloud miss costs are ~1e-8 $ (below HiGHS's default
    # tolerances) and sizes span bytes..GB — normalize both scales
    save_scale = float(psave.mean()) or 1.0
    size_scale = float(psize.mean()) or 1.0
    sz = psize / size_scale
    taus = np.arange(1, nz + 1, dtype=np.int64)
    # z coefficients: z_tau is +1 in row tau-1, -1 in row tau (tau <= nz-1);
    # x coefficients: -size in row t (starts occupying at instant t+1),
    # +size in row u-1 when it stops occupying inside the horizon
    ends = pu <= nz
    rows = np.concatenate([taus - 1, taus[:nz - 1],
                           pt, pu[ends] - 1])
    cols = np.concatenate([m + taus - 1, m + taus[:nz - 1] - 1,
                           np.arange(m, dtype=np.int64), np.flatnonzero(ends)])
    vals = np.concatenate([np.ones(nz), -np.ones(nz - 1), -sz, sz[ends]])
    A = sparse.csc_matrix((vals, (rows, cols)), shape=(nz, m + nz))
    c = np.concatenate([-psave / save_scale, np.zeros(nz)])
    zc = zcap / size_scale
    bounds = [(0.0, 1.0)] * m + list(zip(np.zeros(nz), zc))
    res = linprog(c, A_eq=A, b_eq=np.zeros(nz), bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    return float(-res.fun) * save_scale, res.x[:m]


def lp_opt(ids: np.ndarray, costs: np.ndarray, sizes: np.ndarray, B: float):
    """Interval LP (eq. 2) in an O(T + m)-nonzero difference form via HiGHS.

    Returns (dollars_lower_bound, savings_upper_bound, x_fractional, paid).
    For uniform sizes the matrix is totally unimodular: x is integral and the
    bound is the exact optimum. For variable sizes this is the cost-FOO
    fractional lower bound on billed dollars.

    Difference form: occupancy z_tau (tau = 1..T-1) with
        z_1 = sum_{t=0} s_i x_i ;  z_tau - z_{tau-1} = starts(tau-1) - ends(tau)
        0 <= z_tau <= B - s_{o(tau)}   (B if s_{o(tau)} > B: fetch-through)
    which has 2 nonzeros per x and per z instead of one per covered instant.
    """
    ids = np.asarray(ids)
    T = len(ids)
    costs = np.asarray(costs, np.float64)
    total = float(costs[ids].sum()) if T else 0.0
    t, u, obj, save, size = build_interval_arrays(ids, costs, sizes)
    fits = size <= B
    free_save = float(save[fits & (u == t + 1)].sum())
    paidm = fits & (u > t + 1)
    pt, pu = t[paidm], u[paidm]
    ps, pz = save[paidm], size[paidm]
    paid = [Interval(a, b, o, sv, szv)
            for a, b, o, sv, szv in zip(pt.tolist(), pu.tolist(),
                                        obj[paidm].tolist(), ps.tolist(),
                                        pz.tolist())]
    nz = T - 1
    if len(paid) == 0 or nz <= 0:
        return total - free_save, free_save, np.zeros(0), paid
    zcap = zcap_profile(ids, sizes, B)[1:]
    savings, x = lp_solve_arrays(pt, pu, ps, pz, zcap, nz)
    savings += free_save
    return total - savings, savings, x, paid


# ---------------------------------------------------------------------------
# brute-force oracles (tests only)
# ---------------------------------------------------------------------------

def enumerate_opt_uniform(ids: np.ndarray, costs: np.ndarray, B: int) -> float:
    """Exhaustive subset enumeration over reuse gaps (validates eq. 2 itself).
    Only for #paid intervals <= ~18."""
    ids = np.asarray(ids)
    T = len(ids)
    total = float(costs[ids].sum())
    intervals = build_intervals(ids, costs, np.ones(max(1, ids.max() + 1)))
    free_save = sum(iv.save for iv in intervals if iv.u == iv.t + 1)
    paid = [iv for iv in intervals if iv.u > iv.t + 1]
    m = len(paid)
    assert m <= 20, "too many intervals to enumerate"
    best = 0.0
    for mask in range(1 << m):
        occ = np.zeros(T, dtype=np.int64)
        save = 0.0
        ok = True
        for j in range(m):
            if mask >> j & 1:
                iv = paid[j]
                occ[iv.t + 1:iv.u] += 1
                save += iv.save
        if B >= 1 and (occ > B - 1).any():
            ok = False
        if ok:
            best = max(best, save)
    return total - (best + free_save)


def dp_opt_uniform(ids: np.ndarray, costs: np.ndarray, B: int) -> float:
    """State-space DP over cache contents — validates that eq. (2) models
    real caching (independent of the interval formulation). Tiny inputs only.

    Semantics match eq. (2): the object being served always occupies a slot
    at its serving instant (no bypass), so a miss on a full cache must evict
    one resident even if the fetched object is then dropped immediately.
    """
    ids = np.asarray(ids)
    states: dict[frozenset, float] = {frozenset(): 0.0}
    for t, i in enumerate(ids):
        i = int(i)
        new: dict[frozenset, float] = {}

        def upd(st, c):
            if st not in new or c < new[st]:
                new[st] = c

        for st, c in states.items():
            if i in st:
                upd(st, c)  # hit
                continue
            c2 = c + float(costs[i])
            S = set(st)
            if len(S) < B:
                upd(frozenset(S | {i}), c2)  # retain the fetched object
                upd(frozenset(S), c2)        # drop it right after serving
            else:
                # full: serving displaces one resident no matter what
                for v in S:
                    upd(frozenset((S - {v}) | {i}), c2)
                    upd(frozenset(S - {v}), c2)
        states = new
    return min(states.values())
