"""Replay grids that reach the edges of the `replay_scan` kernel, shared by
the CPU tests (`test_torch_replay_scan.py`) and the card's
(`test_torch_cuda.py`). Not a test file; numpy and the port only, no JAX.

Every case is a full grid: the six policies, a mixed weight row and a
reversed Belady (w_bel = -1: an object never used again scores 3.4e38, so
when every cached object is one, nothing is evicted and the cache grows),
two price vectors, and budgets 0, 1, a small one, N and past N.
"""
import numpy as np

from repro_torch.core.policies_torch import stack_policy_weights

POLICIES = ["lru", "lfu", "gds", "gdsf", "belady", "cost_belady"]
MIXED = np.array([0.5, 0.25, 1.0, 0.75, 0.125, 2.0], np.float32)
REVERSED_BELADY = np.array([0, 0, 0, 0, -1.0, 0], np.float32)
CASES = ["pow2", "lognormal", "overflow", "ties"]


def weights() -> np.ndarray:
    return np.concatenate([stack_policy_weights(POLICIES), MIXED[None],
                           REVERSED_BELADY[None]])


def budgets(N: int) -> np.ndarray:
    return np.array([0, 1, 7, N, N + 3], np.int32)


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
    """
    rng = np.random.default_rng([CASES.index(name), seed])
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
    return dict(weights=weights(), ids=ids.astype(np.int32),
                costs=cm.astype(np.float32), sizes=sizes.astype(np.float32),
                budgets=budgets(N))
