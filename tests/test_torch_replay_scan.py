"""The `replay_scan` kernel's algorithm, checked on the CPU.

The kernel (`src/repro_torch/kernels/csrc/replay_scan.cu`) cannot run here,
so a numpy model of its per-cell algorithm does: a slot table with an
object -> slot map, the victim taking the displacing object's slot, the
argmin only on steps that evict, the NaN rule, and the table growing past
its budget. The model repeats the kernel's float32 operations in its order
and is held bit for bit to the JAX replay (`_simulate` with
`use_pallas=False`, `sweep_jax`) and to the port's step loop, the kernel's
plain version, on the grids of `tests/_replay_cases.py`. The wrapper's host
side (the frequency rank, the layout plan, its input checks) is tested
here too; the kernel itself is held to the step loop on the card in
`tests/test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies_jax import _simulate as jax_simulate
from repro.core.policies_jax import sweep_jax
from repro.core.trace import next_use_indices
from repro_torch.core import policies_torch as pt
from repro_torch.kernels import ops
from repro_torch.kernels.replay_scan import (CHUNK, SLOT_WORDS, STAGE_BYTES,
                                             frequency_rank, plan,
                                             replay_scan_cuda)

import _replay_cases as cases

f32 = np.float32
BIG = f32(3.4e38)
# an H100 block's opt-in shared memory less about the kernel's static part
H100_SHARED = 232_448 - 272


def _fixed_score(w, tf, fi, infl, cos, nu, T):
    """static + w_bel * bel at a touch (csrc/replay_scan.cu, fixed_score)."""
    a = w[0] * tf
    b = w[1] * fi
    c = w[2] * (infl + cos)
    d = w[3] * (infl + fi * cos)
    stat = ((a + b) + c) + d
    bel = -BIG if nu >= T else -f32(nu)
    return stat + w[4] * bel


def _scores(sb, nu, size, negcf, tf, T, w_cb):
    """Every cached slot's score at step tf (csrc/replay_scan.cu, score)."""
    gap = np.maximum(nu.astype(f32) - tf, f32(1.0))
    cb = np.where(nu >= T, -BIG, (size * gap) / negcf)
    return sb + w_cb * cb


def model_cell(w, ids, nxt, rank, cost, cos, negcf, size, budget):
    """One cell's replay as the kernel runs it. Returns dollars, hits and
    the edges the run reached."""
    T, N = len(ids), len(cost)
    gd_active = (w[2] + w[3]) > 0
    slot_of = np.full(N, -1)
    obj = np.zeros(N, np.int64)
    touch = np.zeros(N, np.int64)
    nu = np.zeros(N, np.int64)
    sb = np.zeros(N, f32)
    sz = np.zeros(N, f32)
    ncf = np.zeros(N, f32)
    used, hits, infl, dollars = 0, 0, f32(0), f32(0)
    seen = dict(scored=0, nan=0, touch_ties=0, kept=0, peak=0)
    for t in range(T):
        i, tf = int(ids[t]), f32(t)
        s = slot_of[i]
        hit = s >= 0
        dollars = dollars + (f32(0) if hit else cost[i])
        hits += hit
        if not hit:
            victim, vscore = -1, BIG
            if used >= budget:
                seen["scored"] += 1
                raw = _scores(sb[:used], nu[:used], sz[:used], ncf[:used], tf,
                              T, w[5])
                if np.isnan(raw).any():          # the plain min is NaN
                    seen["nan"] += 1
                    victim = slot_of[0]
                    vscore = raw[victim] if victim >= 0 else BIG
                elif used:
                    low = raw.min()
                    tied = np.flatnonzero(raw == low)
                    seen["touch_ties"] += len(tied) > 1
                    pick = tied[np.lexsort((obj[tied], touch[tied]))[0]]
                    victim, vscore = pick, raw[pick]
                if not vscore < BIG:
                    victim = -1
                    seen["kept"] += 1
            if victim >= 0:                      # i takes the victim's slot
                if gd_active:
                    infl = vscore
                slot_of[obj[victim]] = -1
                s = victim
            else:                                # append: may pass the budget
                s = used
                used += 1
                seen["peak"] = max(seen["peak"], used)
            slot_of[i] = s
            obj[s], sz[s], ncf[s] = i, size[i], negcf[i]
        sb[s] = _fixed_score(w, tf, f32(rank[t]), infl, cos[i], int(nxt[t]), T)
        nu[s], touch[s] = nxt[t], t
    return dollars, hits, seen


def model_grid(c: dict):
    """The whole grid through `model_cell`, with the wrapper's columns."""
    w_all, ids, costs, sizes, budgets = (c["weights"], c["ids"], c["costs"],
                                         c["sizes"], c["budgets"])
    nxt = next_use_indices(ids).astype(np.int64)
    rank = frequency_rank(ids)
    with np.errstate(all="ignore"):
        cos = costs / np.maximum(sizes, f32(1e-30))
        negcf = -np.maximum(costs, f32(1e-30))
    Q, (P, N), K = len(w_all), costs.shape, len(budgets)
    dollars = np.zeros((Q, P, K), f32)
    hits = np.zeros((Q, P, K), np.int64)
    seen = []
    with np.errstate(all="ignore"):
        for q in range(Q):
            for p in range(P):
                for k in range(K):
                    dollars[q, p, k], hits[q, p, k], s = model_cell(
                        w_all[q], ids, nxt, rank, costs[p], cos[p], negcf[p],
                        sizes, int(budgets[k]))
                    seen.append(s)
    return dollars, hits, seen


_GRIDS = {}


def _grid(name):
    if name not in _GRIDS:
        _GRIDS[name] = model_grid(cases.make(name))
    return _GRIDS[name]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _step_loop(c: dict):
    ids = c["ids"]
    d, h, _ = pt._replay(
        torch.tensor(c["weights"]), ids, next_use_indices(ids),
        torch.tensor(c["costs"]), torch.tensor(c["sizes"]),
        torch.tensor(c["budgets"]), use_kernel=False)
    return d.numpy(), h.numpy()


@pytest.mark.parametrize("name", cases.CASES)
def test_model_matches_the_step_loop(name):
    c = cases.make(name)
    dollars, hits, _ = _grid(name)
    d, h = _step_loop(c)
    np.testing.assert_array_equal(_bits(dollars), _bits(d))
    np.testing.assert_array_equal(hits, h)


@pytest.mark.parametrize("name", cases.CASES)
def test_model_matches_jax_simulate(name):
    c = cases.make(name)
    dollars, hits, _ = _grid(name)
    ids = c["ids"]
    nxt = jnp.asarray(next_use_indices(ids).astype(np.int32))
    N = c["costs"].shape[1]
    for q, w in enumerate(c["weights"]):
        for p, costs in enumerate(c["costs"]):
            for k, B in enumerate(c["budgets"]):
                d, h = jax_simulate(jnp.asarray(ids), nxt, jnp.asarray(costs),
                                    jnp.asarray(c["sizes"]), jnp.int32(B),
                                    jnp.asarray(w), N, use_pallas=False)
                assert _bits(d) == _bits(dollars[q, p, k]), (q, p, k)
                assert int(h) == hits[q, p, k], (q, p, k)


@pytest.mark.parametrize("name", cases.CASES)
def test_model_matches_sweep_jax(name):
    c = cases.make(name)
    dollars, _, _ = _grid(name)
    want = sweep_jax(c["weights"], c["ids"], c["costs"], c["budgets"],
                     num_objects=c["costs"].shape[1], sizes=c["sizes"])
    np.testing.assert_array_equal(_bits(dollars), _bits(want))


def test_cases_reach_the_kernels_edges():
    """Each edge the kernel handles on its own path is taken somewhere:
    the NaN rule (victim object 0, evicted and kept), scores at 3.4e38 or
    more keeping every object, growth past the budget, ties the touch
    breaks, budgets 0 and past N."""
    seen = {name: _grid(name)[2] for name in cases.CASES}
    overflow = seen["overflow"]
    assert sum(s["nan"] for s in overflow) > 100
    assert sum(s["kept"] for s in overflow) > 0
    assert sum(s["touch_ties"] for s in seen["ties"]) > 100
    c = cases.make("pow2")
    Q, P, K = len(c["weights"]), *c["costs"].shape[:1], len(c["budgets"])
    grid = np.array(seen["pow2"], dtype=object).reshape(Q, P, K)
    reversed_belady = grid[Q - 1]
    # w_bel = -1 scores every never-again object 3.4e38: kept, so it grows
    assert all(s["kept"] > 0 for s in reversed_belady[:, :3].ravel())
    assert all(s["peak"] > int(c["budgets"][k])
               for k in (1, 2) for s in reversed_belady[:, k])
    # budget 0: the first miss finds an empty cache and keeps its object
    assert all(s["peak"] >= 1 for s in grid[:, :, 0].ravel())
    # budget N and past N: nothing is ever scored
    assert all(s["scored"] == 0 for s in grid[:, :, 3:].ravel())


def test_frequency_rank_equals_the_step_loops_counts():
    rng = np.random.default_rng(5)
    for T, N in [(0, 1), (1, 1), (500, 7), (3000, 400)]:
        ids = rng.integers(0, N, T)
        counts = np.zeros(N, np.int64)
        want = []
        for i in ids:
            counts[i] += 1
            want.append(counts[i])
        got = frequency_rank(ids)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.array(want, np.int64))


@pytest.mark.parametrize("cells,N,map_shared,all_shared", [
    (96, 20_000, True, False),     # the main path: slots spill past ~5,700
    (96, 2_000, True, True),       # the parity grid: all in shared memory
    (4, 2**17, False, False),      # map and spilled slots in device memory
    (1, 1, True, True),
    (200, 27_228, True, False),    # the largest map kept in shared memory
    (200, 27_229, False, False),
])
def test_plan_places_map_and_slots_by_size(cells, N, map_shared, all_shared):
    p = plan(cells, N, H100_SHARED)
    assert p["map_shared"] == map_shared
    assert (p["slots_shared"] == N) == all_shared
    assert p["shared_bytes"] <= H100_SHARED
    assert p["map_words"] == (0 if map_shared else cells * N)
    assert p["slot_words"] == (0 if all_shared else cells * SLOT_WORDS * N)
    left = H100_SHARED - p["shared_bytes"]
    # the shared table takes all the room it can
    assert all_shared or left < 4 * SLOT_WORDS
    if N == 20_000:
        assert p["slots_shared"] >= 2560      # the largest main-path budget
    assert STAGE_BYTES == CHUNK * 7 * 4


def test_plan_refuses_a_block_with_no_slot():
    with pytest.raises(ValueError):
        plan(1, 10, STAGE_BYTES + 4 * SLOT_WORDS - 1)


def _inputs(T=10, N=5, Q=2, P=3, K=4, **over):
    x = dict(weights=torch.zeros(Q, 6), ids=torch.zeros(T, dtype=torch.int32),
             nxt=torch.zeros(T, dtype=torch.int32),
             rank=torch.ones(T, dtype=torch.int32), costs=torch.ones(P, N),
             sizes=torch.ones(N), budgets=torch.ones(K, dtype=torch.int32))
    x.update(over)
    return x


@pytest.mark.parametrize("bad", [
    dict(weights=torch.zeros(2, 5)), dict(weights=torch.zeros(2, 6).double()),
    dict(ids=torch.zeros(10)), dict(nxt=torch.zeros(9, dtype=torch.int32)),
    dict(rank=torch.ones(10, 1, dtype=torch.int32)),
    dict(costs=torch.ones(5, 3).t()), dict(sizes=torch.ones(4)),
    dict(budgets=torch.ones(0, dtype=torch.int32)),
    dict(costs=torch.ones(3, 0), sizes=torch.ones(0)),
])
def test_replay_scan_cuda_refuses_bad_shapes_and_types(bad):
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="must|unsupported"):
        replay_scan_cuda(**_inputs(**bad))
    assert ops.launch_counts()["replay_scan"] == 0


def test_replay_scan_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        replay_scan_cuda(**_inputs())
    assert ops.launch_counts()["replay_scan"] == 0


def test_sweep_torch_takes_the_kernel_only_on_the_card():
    c = cases.make("pow2")
    kw = dict(num_objects=c["costs"].shape[1], sizes=c["sizes"])
    with pytest.raises(ValueError):   # the kernel has no CPU mode
        pt.sweep_torch(c["weights"], c["ids"], c["costs"], c["budgets"],
                       use_kernel=True, device="cpu", **kw)
    ops.reset_launch_counts()
    got = pt.sweep_torch(c["weights"], c["ids"], c["costs"], c["budgets"],
                         device="cpu", **kw)
    assert all(n == 0 for n in ops.launch_counts().values())
    np.testing.assert_array_equal(_bits(got), _bits(_grid("pow2")[0]))


def test_sweep_torch_refuses_ids_outside_the_objects():
    costs = np.ones((1, 4))
    for ids in ([0, 4], [-1, 2]):
        with pytest.raises(ValueError, match="ids must lie"):
            pt.sweep_torch("lru", np.array(ids), costs, np.array([1]),
                           num_objects=4, device="cpu")
