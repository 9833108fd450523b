"""The `replay_scan` kernel's algorithm, checked on the CPU.

The kernel (`src/repro_torch/kernels/csrc/replay_scan.cu`) cannot run here,
so a numpy model of its per-cell algorithm does: a slot table with an
object -> slot map, the victim taking the displacing object's slot, the
argmin only on steps that evict, as the order image of the score and then
the touch (touches of cached objects are distinct; the model checks that),
the static path (rows with w_cb = 0 compare sb alone while no cached
slot's cost-Belady term was non-finite at its touch, the victim's score
recomputed in full), runs of hits resolved a window of 32 requests at a
time (each slot touched by the run's last request to it), the NaN rule,
and the table growing past its budget.
The model repeats the kernel's float32 operations in its order and is held
bit for bit to the JAX replay (`_simulate` with `use_pallas=False`,
`sweep_jax`) and to the port's step loop, the kernel's plain version, on
the grids of `tests/_replay_cases.py`. The wrapper's host side (the
frequency rank, the layout plan, its input checks) is tested here too; the
kernel itself is held to the step loop on the card in
`tests/test_torch_cuda.py`.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies_jax import _simulate as jax_simulate
from repro.core.policies_jax import sweep_jax
from repro.core.trace import next_use_indices
from repro_torch.core import policies_torch as pt
from repro_torch.kernels import ops, ref
from repro_torch.kernels.replay_scan import (BOUND_GROUP, BYTE_WORK_COLUMNS,
                                             CHUNK, SLOT_WORDS, STAGE_BYTES,
                                             FULL_WARPS, STATIC_WARPS,
                                             WORK_COLUMNS, plan,
                                             replay_scan_cuda)

import _replay_cases as cases

f32 = np.float32
BIG = f32(3.4e38)
EMPTY = np.uint32(0xFFFFFFFF)
# an H100 block's opt-in shared memory less about the kernel's static part
H100_SHARED = 232_448 - 272


def order_image(x):
    """argmin_rule.cuh's order_image: uint32 words in the floats' order,
    -0.0 folded onto 0.0 (NaN has no place; callers leave it out)."""
    b = np.asarray(x, f32).view(np.uint32).copy()
    b[(b << np.uint32(1)) == 0] = 0
    return np.where(b & np.uint32(0x80000000), ~b,
                    b | np.uint32(0x80000000)).astype(np.uint32)


def _fixed_score(w, tf, fi, infl, cos, nu, T):
    """static + w_bel * bel at a touch (csrc/replay_scan.cu, touch_score)."""
    a = w[0] * tf
    b = w[1] * fi
    c = w[2] * (infl + cos)
    d = w[3] * (infl + fi * cos)
    stat = ((a + b) + c) + d
    bel = -BIG if nu >= T else -f32(nu)
    return stat + w[4] * bel


def _cost_belady(nu, size, negcf, tf, T):
    """cb at step tf (csrc/replay_scan.cu, cost_belady), elementwise."""
    gap = np.maximum(np.asarray(nu).astype(f32) - tf, f32(1.0))
    return np.where(np.asarray(nu) >= T, -BIG, (size * gap) / negcf)


def _scores(sb, nu, size, negcf, tf, T, w_cb):
    """Every cached slot's score at step tf (csrc/replay_scan.cu,
    slot_score)."""
    return sb + w_cb * _cost_belady(nu, size, negcf, tf, T)


def model_cell(w, ids, nxt, rank, cost, cos, negcf, size, budget):
    """One cell's replay as the kernel runs it. Returns dollars, hits and
    the edges the run reached."""
    T, N = len(ids), len(cost)
    gd_active = (w[2] + w[3]) > 0
    static_row = w[5] == 0
    slot_of = np.full(N, -1)
    obj = np.zeros(N, np.int64)
    touch = np.zeros(N, np.int64)
    nu = np.zeros(N, np.int64)
    flag = np.zeros(N, bool)     # the slot's term was not finite at its touch
    sb = np.zeros(N, f32)
    sz = np.zeros(N, f32)
    ncf = np.zeros(N, f32)
    used, hits, infl, dollars, bad = 0, 0, f32(0), f32(0), 0
    seen = dict(scored=0, nan=0, touch_ties=0, signed_ties=0, kept=0,
                peak=0, static=0, full_static=0, static_after_clear=0,
                most_bad=0, cleared_by_touch=0, cleared_by_evict=0,
                run_hits=0, run_repeats=0)
    cleared = False

    def bad_at(t):
        """The request's cost-Belady term is not finite at its own step."""
        i = int(ids[t])
        return bool(static_row and not np.isfinite(_cost_belady(
            nxt[t], size[i], negcf[i], f32(t), T)))

    def touch_slot(s, t):
        sb[s] = _fixed_score(w, f32(t), f32(rank[t]), infl, cos[int(ids[t])],
                             int(nxt[t]), T)
        nu[s], touch[s], flag[s] = nxt[t], t, bad_at(t)

    t = 0
    while t < T:
        # a window of up to 32 requests inside the 512-request chunk: every
        # request before the first miss is a hit as of its own step
        end = min(t + 32, (t // CHUNK + 1) * CHUNK, T)
        window = slot_of[ids[t:end]]
        h = int(np.argmax(window < 0)) if (window < 0).any() else end - t
        if h:
            run = window[:h]
            last = {int(s): t + k for k, s in enumerate(run)}
            seen["run_hits"] += h
            seen["run_repeats"] += h - len(last)
            for s, r in last.items():      # the run's last request per slot
                was_bad = flag[s]
                bad += int(bad_at(r)) - int(was_bad)
                if was_bad and bad == 0:
                    seen["cleared_by_touch"] += 1
                touch_slot(s, r)
            hits += h
            t += h
            seen["most_bad"] = max(seen["most_bad"], bad)
            cleared = cleared or (seen["most_bad"] > 0 and bad == 0)
            if h == end - (t - h):
                continue
        # request t misses
        i, tf = int(ids[t]), f32(t)
        dollars = dollars + cost[i]
        victim, evict = -1, False
        if used >= budget:
            seen["scored"] += 1
            raw = _scores(sb[:used], nu[:used], sz[:used], ncf[:used], tf,
                          T, w[5])
            if static_row and bad == 0:       # sb alone
                seen["static"] += 1
                seen["static_after_clear"] += cleared
                keys = sb[:used]
            else:
                seen["full_static"] += static_row
                keys = raw
            if np.isnan(keys).any():          # the plain min is NaN
                seen["nan"] += 1
                victim = slot_of[0]
                vscore = raw[victim] if victim >= 0 else BIG
                evict = vscore < BIG
            elif used:
                img = order_image(keys)
                tied = np.flatnonzero(img == img.min())
                assert len(set(touch[tied])) == len(tied)
                seen["touch_ties"] += len(tied) > 1
                zeros = raw[tied][raw[tied] == 0]
                seen["signed_ties"] += len(set(np.signbit(zeros))) > 1
                victim = tied[np.argmin(touch[tied])]
                if gd_active:                 # recomputed in full
                    vscore = raw[victim]
                    evict = vscore < BIG
                else:
                    evict = img.min() < order_image(BIG)
            if not evict:
                victim = -1
                seen["kept"] += 1
        if victim >= 0:                      # i takes the victim's slot
            if gd_active:
                infl = vscore
            if flag[victim] and bad == 1:
                seen["cleared_by_evict"] += 1
            bad -= int(flag[victim])
            slot_of[obj[victim]] = -1
            s = victim
        else:                                # append: may pass the budget
            s = used
            used += 1
            seen["peak"] = max(seen["peak"], used)
        slot_of[i] = s
        obj[s], sz[s], ncf[s] = i, size[i], negcf[i]
        touch_slot(s, t)
        bad += int(flag[s])
        seen["most_bad"] = max(seen["most_bad"], bad)
        cleared = cleared or (seen["most_bad"] > 0 and bad == 0)
        t += 1
    return dollars, hits, seen


def model_grid(c: dict):
    """The whole grid through `model_cell`, with the wrapper's columns."""
    w_all, ids, costs, sizes, budgets = (c["weights"], c["ids"], c["costs"],
                                         c["sizes"], c["budgets"])
    nxt = next_use_indices(ids).astype(np.int64)
    rank = ref.frequency_rank_ref(torch.tensor(ids)).numpy()
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
    breaks, signed zeros among them, budgets 0 and past N, the static
    path leaving for the full score and coming back, and tables at the
    warp thresholds."""
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
    # every static row of every case takes the static path somewhere
    assert sum(s["static"] for name in cases.CASES for s in seen[name]) > 1000
    # signed zeros tie and the touch breaks them, on the static path too
    zero = seen["signed_zero"]
    assert sum(s["signed_ties"] for s in zero) > 100
    assert sum(s["static"] for s in zero) > 100
    # a term non-finite at its touch sends static rows to the full score,
    # and the count comes back to 0 by a touch and by an eviction
    later = seen["finite_later"]
    assert sum(s["full_static"] for s in later) > 100
    assert sum(s["cleared_by_touch"] for s in later) > 0
    assert sum(s["cleared_by_evict"] for s in later) > 0
    assert sum(s["static_after_clear"] for s in later) > 0
    # hits go in runs, and a run meets the same slot more than once
    assert sum(s["run_hits"] for s in seen["ties"]) > 1000
    assert sum(s["run_repeats"] for s in seen["ties"]) > 100
    # every warp-threshold table fills and evicts
    edges = cases.make("warp_edges")
    for s, k in zip(seen["warp_edges"],
                    np.tile(np.arange(len(edges["budgets"])),
                            len(edges["weights"]) * 2)):
        assert s["peak"] >= int(edges["budgets"][k]) and s["scored"] > 0


def test_order_image_keeps_the_float_order():
    """The image's order is the floats' (-0.0 and 0.0 tie), +inf's image
    is below the empty lane's word, and a NaN has no image in the order."""
    rng = np.random.default_rng(3)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3.4e38,
                        -3.4e38, 1.0, -1.0], f32)
    x = np.concatenate([special, rng.standard_normal(500).astype(f32)
                        * f32(10.0) ** rng.integers(-40, 38, 500)]).astype(f32)
    img = order_image(x)
    a, b = np.meshgrid(np.arange(len(x)), np.arange(len(x)))
    np.testing.assert_array_equal(img[a] < img[b], x[a] < x[b])
    np.testing.assert_array_equal(img[a] == img[b], x[a] == x[b])
    assert order_image(np.inf)[()] < EMPTY
    assert int(order_image(np.inf)) == 0xFF800000


def test_layout_constants_mirror_the_kernel_source():
    """replay_scan.py's copies of the kernel's fixed layout and warp rule
    are the values csrc/replay_scan.cu compiles."""
    src = (Path(ops.__file__).parent / "csrc" / "replay_scan.cu").read_text()

    def ints(pattern):
        m = re.search(pattern, src)
        assert m, pattern
        return tuple(map(int, m.groups()))

    assert ints(r"constexpr int kChunk = (\d+);") == (CHUNK,)
    assert ints(r"constexpr int kSlotWords = (\d+);") == (SLOT_WORDS,)
    assert ints(r"constexpr int kStageWords = (\d+);") == (
        STAGE_BYTES // (4 * CHUNK),)
    assert ints(r"constexpr int kStaticOne = (\d+), kStaticPer = (\d+);") \
        == STATIC_WARPS
    assert ints(r"constexpr int kFullOne = (\d+), kFullPer = (\d+);") == \
        FULL_WARPS
    assert ints(r"constexpr int kGroup = (\d+);") == (BOUND_GROUP,)
    assert ints(r"constexpr int kWorkWords = (\d+);") == (len(WORK_COLUMNS),)
    assert ints(r"constexpr int kByteWorkWords = (\d+);") == (
        len(BYTE_WORK_COLUMNS),)


def test_warp_budgets_straddle_the_thresholds():
    """warp_edges holds tables one below, at and one above each size where
    a cell of either path takes more scoring warps."""
    b = set(cases.warp_budgets().tolist())
    rules = (STATIC_WARPS, FULL_WARPS)
    for one, per in rules:
        assert 1 <= per <= one
        assert {one - 1, one, one + 1} <= b
        assert cases.scoring_warps(one + 1, one, per) >= 2
    for u in cases.warp_thresholds():
        assert {u - 1, u, u + 1} <= b
        assert any(cases.scoring_warps(u + 1, one, per)
                   > cases.scoring_warps(u, one, per) for one, per in rules)


def _step_loop_counts(ids, N: int) -> np.ndarray:
    """The frequency the step loop reads at each step: the count of ids[t]
    in ids[:t+1]."""
    counts = np.zeros(N, np.int64)
    want = []
    for i in ids:
        counts[i] += 1
        want.append(counts[i])
    return np.array(want, np.int64)


def test_frequency_rank_equals_the_step_loops_counts():
    rng = np.random.default_rng(5)
    for T, N in [(0, 1), (1, 1), (500, 7), (3000, 400)]:
        ids = rng.integers(0, N, T)
        got = ref.frequency_rank_ref(torch.tensor(ids))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _step_loop_counts(ids, N))


def _rank_ids(shape):
    rng = np.random.default_rng(6)
    if shape == "T=0":
        return np.zeros(0, np.int32), 1
    if shape == "T=1":
        return np.array([3], np.int32), 4
    if shape == "all equal":
        return np.full(777, 5, np.int32), 9
    if shape == "N=1":
        return np.zeros(300, np.int32), 1
    ids = rng.integers(0, 50, 4000)          # "half one id"
    ids[rng.random(4000) < 0.5] = 17
    return ids.astype(np.int32), 50


@pytest.mark.parametrize("shape", ["T=0", "T=1", "all equal", "N=1",
                                   "half one id"])
def test_frequency_rank_ref_equals_the_step_loops_counts(shape):
    """The plain PyTorch rank (next_use's with_rank on the CPU) equals the
    step loop's counts on the edge shapes."""
    ids, N = _rank_ids(shape)
    got = ref.frequency_rank_ref(torch.tensor(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _step_loop_counts(ids, N))


@pytest.mark.parametrize("shape", ["T=1", "all equal", "N=1", "half one id"])
@pytest.mark.parametrize("with_rank", [False, True])
def test_next_use_with_rank_on_the_cpu(shape, with_rank):
    """ops.next_use's plain path: next(t) alone as before, or (next, rank)
    equal to the plain next(t) and to the step loop's counts; no kernel
    runs."""
    ids, N = _rank_ids(shape)
    ids_t = torch.tensor(ids)
    ops.reset_launch_counts()
    got = ops.next_use(ids_t, N, use_kernel=False, with_rank=with_rank)
    nxt = got[0] if with_rank else got
    assert torch.is_tensor(nxt) and nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), next_use_indices(ids, N))
    assert torch.equal(nxt, ref.next_use_ref(ids_t, N))
    if with_rank:
        assert len(got) == 2
        np.testing.assert_array_equal(got[1].numpy(),
                                      _step_loop_counts(ids, N))
    assert ops.launch_counts()["next_use"] == 0


@pytest.mark.parametrize("cells,N,map_shared,all_shared", [
    (96, 20_000, True, False),     # the main path: slots spill past ~5,700
    (96, 2_000, True, True),       # the parity grid: all in shared memory
    (4, 2**17, False, False),      # map and spilled slots in device memory
    (1, 1, True, True),
    (200, 26_716, True, False),    # the largest map kept in shared memory
    (200, 26_717, False, False),
    (3, 2**17 - 1, False, False),  # odd N: the device regions' stride is even
])
def test_plan_places_map_and_slots_by_size(cells, N, map_shared, all_shared):
    p = plan(cells, N, H100_SHARED)
    assert p["map_shared"] == map_shared
    assert (p["slots_shared"] == N) == all_shared
    assert p["shared_bytes"] <= H100_SHARED
    assert p["map_words"] == (0 if map_shared else cells * N)
    assert p["slot_words"] == (0 if all_shared
                               else cells * SLOT_WORDS * (N + N % 2))
    left = H100_SHARED - p["shared_bytes"]
    # the shared table takes all the room it can
    assert all_shared or left < 4 * SLOT_WORDS
    if N == 20_000:
        assert p["slots_shared"] >= 2560      # the largest main-path budget
    assert STAGE_BYTES == CHUNK * 9 * 4


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
