"""Replay grids that reach the edges of the `replay_scan` kernel, shared by
the CPU tests (`test_torch_replay_scan.py`) and the card's
(`test_torch_cuda.py`). Not a test file; numpy and the port only, no JAX.

Every case is a full grid: the six policies, a mixed weight row and a
reversed Belady (w_bel = -1: an object never used again scores 3.4e38, so
when every cached object is one, nothing is evicted and the cache grows),
two price vectors, and budgets 0, 1, a small one, N and past N (except
`warp_edges`, whose budgets sit at the kernel's warp thresholds).
"""
import numpy as np

from repro_torch.core.policies_torch import stack_policy_weights
from repro_torch.kernels.replay_scan import FULL_WARPS, STATIC_WARPS

POLICIES = ["lru", "lfu", "gds", "gdsf", "belady", "cost_belady"]
MIXED = np.array([0.5, 0.25, 1.0, 0.75, 0.125, 2.0], np.float32)
REVERSED_BELADY = np.array([0, 0, 0, 0, -1.0, 0], np.float32)
# the byte grids' ninth row: w_cb = -1, where the byte kernel's cost-Belady
# bounds (w_cb > 0 only) stay off
REVERSED_COST_BELADY = np.array([0, 0, 0, 0, 0, -1.0], np.float32)
# rows whose scores are signed zeros: every weight -0.0 but w_bel (sb is
# -0.0), w_gd = w_cb = -0.0 (sb is +0.0), and GreedyDual-Size with w_cb = -0.0
# (infl takes the victims' signed zeros)
SIGNED_ZERO_ROWS = np.array([[-0.0, -0.0, -0.0, -0.0, 0.0, -0.0],
                             [0.0, 0.0, -0.0, 0.0, 0.0, -0.0],
                             [0.0, 0.0, 1.0, 0.0, 0.0, -0.0]], np.float32)
CASES = ["pow2", "lognormal", "overflow", "ties", "signed_zero",
         "finite_later", "warp_edges"]


def weights() -> np.ndarray:
    return np.concatenate([stack_policy_weights(POLICIES), MIXED[None],
                           REVERSED_BELADY[None]])


def budgets(N: int) -> np.ndarray:
    return np.array([0, 1, 7, N, N + 3], np.int32)


def scoring_warps(u: int, one: int, per: int) -> int:
    """The kernel's warps_for: one warp up to `one` slots, else one a `per`
    slots, 2 to 16."""
    return 1 if u <= one else min(16, max(2, -(-u // per)))


def warp_thresholds() -> list:
    """For each path's rule, the two smallest tables after which a cell
    takes more scoring warps: the one-warp limit and the next step."""
    out = []
    for one, per in (STATIC_WARPS, FULL_WARPS):
        step = next(u for u in range(one + 1, one + 16 * per + 2)
                    if scoring_warps(u + 1, one, per)
                    != scoring_warps(u, one, per))
        out += [one, step]
    return out


def warp_budgets() -> np.ndarray:
    """Tables one below, at and one above each of `warp_thresholds`."""
    return np.array(sorted({b + d for b in warp_thresholds()
                            for d in (-1, 0, 1)}), np.int32)


def make(name: str, seed: int = 0) -> dict:
    """One case's inputs: weights (Q, 6), ids (T,), costs (P, N), sizes
    (N,), budgets (K,), all numpy.

    pow2:      power-of-two costs and sizes, every score exact in float32.
    lognormal: lognormal costs and sizes, scores rounded.
    overflow:  c/s overflows to inf for most objects, so a zero weight
               times inf puts NaN in their scores. The NaN rule then picks
               object 0 (requested often, its score finite): evicted while
               cached, and while it is not, nothing is evicted and the
               cache grows past its budget. A few sizes of 3e38 send
               cost-Belady's term to -inf.
    ties:      unit costs and sizes: GreedyDual's, LFU's and Belady's
               never-again scores tie, and the touch decides.
    signed_zero: costs of +0.0 and -0.0, sizes of +0.0, -0.0 and 1, and the
               rows of SIGNED_ZERO_ROWS besides the usual ones: scores of
               -0.0 and +0.0 tie, the touch breaks them, and GreedyDual's
               infl carries a victim's signed zero into later scores.
    finite_later: sizes 1 but for objects 0 and 1, of size
               2e38, costs from 1 to 8, so that size * gap overflows while
               gap >= 2 and not at gap 1: a big object's cb term is -inf at
               a touch whose next use is two or more steps on, 0 * cb is
               NaN, and rows with w_cb = 0 score in full until the slot is
               touched again with a finite term (a request on the next
               step, or none) or evicted.
    warp_edges: a sweep over all objects, then uniform requests; budgets at
               each warp threshold of `warp_budgets`, less, and one more.
    """
    rng = np.random.default_rng([CASES.index(name), seed])
    w = weights()
    if name == "signed_zero":
        T, N = 400, 40
        ids = rng.integers(0, N, T)
        cm = np.stack([np.zeros(N), rng.choice([0.0, -0.0], N)])
        sizes = rng.choice([0.0, -0.0, 1.0], N)
        w = np.concatenate([w, SIGNED_ZERO_ROWS])
        return dict(weights=w, ids=ids.astype(np.int32),
                    costs=cm.astype(np.float32),
                    sizes=sizes.astype(np.float32), budgets=budgets(N))
    if name == "finite_later":
        T, N = 400, 30
        big = np.array([0, 1])
        ids = rng.integers(len(big), N, T)
        # a big object b comes as (b, b): the first touch's term is finite
        # (gap 1); or as (b, x, b): -inf at the first touch (gap 2), finite
        # on x's step (gap 1), where a row that evicts the soonest next use
        # takes it
        for t in rng.choice(T - 2, 12, replace=False):
            b = rng.choice(big)
            ids[t] = ids[t + 1 + (rng.random() < 0.5)] = b
        sizes = np.ones(N)
        sizes[big] = 2e38
        cm = np.stack([np.ones(N), 2.0 ** rng.integers(0, 4, N)])
        return dict(weights=w, ids=ids.astype(np.int32),
                    costs=cm.astype(np.float32),
                    sizes=sizes.astype(np.float32), budgets=budgets(N))
    if name == "warp_edges":
        b = warp_budgets()
        N = int(b.max()) + 64
        ids = np.concatenate([rng.permutation(N), rng.integers(0, N, 1200)])
        cm = rng.lognormal(-12.0, 1.5, (2, N))
        sizes = rng.lognormal(8.0, 2.0, N)
        return dict(weights=w, ids=ids.astype(np.int32),
                    costs=cm.astype(np.float32),
                    sizes=sizes.astype(np.float32), budgets=b)
    if name == "overflow":
        T, N = 300, 30
        ids = rng.integers(0, N, T)
        ids[rng.random(T) < 0.25] = 0
        costs = np.full(N, 3e38)
        sizes = np.full(N, 1e-30)
        costs[0], sizes[0] = 1.0, 1.0
        big = rng.choice(np.arange(1, N), 4, replace=False)
        costs[big], sizes[big] = 1.0, 3e38
        cm = np.stack([costs, costs / 2])
    elif name == "ties":
        T, N = 300, 20
        ids = rng.integers(0, N, T)
        sizes = np.ones(N)
        cm = np.ones((2, N))
    else:
        T, N = 400, 40
        ids = rng.integers(0, N, T)
        if name == "pow2":
            costs = 2.0 ** rng.integers(0, 12, N)
            sizes = 2.0 ** rng.integers(0, 4, N)
            cm = np.stack([costs, 8 * costs])
        else:
            cm = rng.lognormal(-12.0, 1.5, (2, N))
            sizes = rng.lognormal(8.0, 2.0, N)
    return dict(weights=w, ids=ids.astype(np.int32),
                costs=cm.astype(np.float32), sizes=sizes.astype(np.float32),
                budgets=budgets(N))


# The byte replay's grids (`budget_unit="bytes"`): whole-byte sizes, the
# page grids' weight rows and a reversed cost-Belady, two price vectors,
# and byte budgets that reach its edges. Shared by
# `test_torch_replay_bytes.py` and the card's tests.
BYTE_CASES = ["pareto", "multi_victim", "ties", "unit", "zero_cost"]


def byte_weights() -> np.ndarray:
    """The six policies, the mixed row, the reversed Belady (row 7) and the
    reversed cost-Belady (row 8)."""
    return np.concatenate([weights(), REVERSED_COST_BELADY[None]])


def make_bytes(name: str, seed: int = 0) -> dict:
    """One byte case's inputs: weights (Q, 6), ids (T,), costs (P, N),
    sizes (N,) whole bytes (float64), budgets (K,) int64 bytes. Every case
    takes `byte_weights()` but `zero_cost`.

    pareto:       Pareto sizes as the CDN arm's (a few objects larger than
                  the small budgets, which are fetched through), costs from
                  the sizes as list prices give them, budgets 0 (every miss
                  fetched through), half the largest size, and 1, 5 and 20 %
                  of the catalog's bytes.
    multi_victim: mostly objects of 1-8 bytes and a few of 400-900, so that
                  a large one's admission evicts many small ones (GreedyDual
                  rows set L at each), and budgets near one large object.
    ties:         two sizes and unit costs: scores tie, the touch decides.
    unit:         every size 1, budgets 1, 7 and N pages' worth: the page
                  replay's grid, which the byte replay must repeat.
    zero_cost:    the second price vector bills a quarter of the objects
                  nothing (the operator's own origin), so cost-Belady's
                  term, floored at 1e-30, overflows to -inf at the touch of
                  a large one whose next use is far (and is finite when it
                  is near): its row scans in full while such a slot is
                  cached and goes back to its group bounds once none is.
                  The rows with w_cb = 0 would score those objects NaN (0 *
                  -inf), which the plain reference does not replay, so this
                  case takes the rows with w_cb != 0 alone.
    """
    rng = np.random.default_rng([100 + BYTE_CASES.index(name), seed])
    w = byte_weights()
    if name == "pareto":
        T, N = 1500, 200
        ids = rng.integers(0, N, T)
        sizes = np.ceil(np.clip((rng.pareto(1.0, N) + 1.0) * 300.0, 64.0,
                                5e6))
        fee, egress = np.array([0.4e-6, 0.04e-6]), np.array([0.09e-9,
                                                             0.12e-9])
        cm = fee[:, None] + sizes[None, :] * egress[:, None]
        total = sizes.sum()
        budgets = np.array([0, sizes.max() // 2, total // 100, total // 20,
                            total // 5])
    elif name == "multi_victim":
        T, N = 1200, 120
        ids = rng.integers(0, N, T)
        sizes = rng.integers(1, 9, N).astype(np.float64)
        big = rng.choice(N, 10, replace=False)
        sizes[big] = rng.integers(400, 900, len(big))
        cm = np.stack([2.0 ** rng.integers(0, 12, N),
                       rng.lognormal(-12.0, 1.5, N)])
        budgets = np.array([100, 950, 1400, 2500])
    elif name == "ties":
        T, N = 600, 30
        ids = rng.integers(0, N, T)
        sizes = rng.choice([3.0, 5.0], N)
        cm = np.ones((2, N))
        budgets = np.array([4, 11, 40])
    elif name == "zero_cost":
        T, N = 1200, 100
        ids = rng.integers(0, N, T)
        sizes = np.ceil(rng.lognormal(8.0, 1.5, N))
        free = rng.choice(N, N // 4, replace=False)
        # size * gap passes 3.4e8 (cb = -inf at cost 0) from gaps of 43-170
        sizes[free] = rng.integers(2_000_000, 8_000_000, len(free))
        cm = np.stack([0.4e-6 + sizes * 0.09e-9] * 2)
        cm[1, free] = 0.0
        w = w[w[:, 5] != 0]
        total = sizes.sum()
        budgets = np.array([total // 20, total // 5, total // 2])
    else:
        T, N = 500, 40
        ids = rng.integers(0, N, T)
        sizes = np.ones(N)
        cm = rng.lognormal(-12.0, 1.5, (2, N))
        budgets = np.array([1, 7, N])
    return dict(weights=w, ids=ids.astype(np.int32), costs=cm,
                sizes=sizes, budgets=budgets.astype(np.int64))
