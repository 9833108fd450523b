"""The port's CUDA kernels, its replay, its serving engine and its training
step on the card, against their plain PyTorch versions and the CPU. Every
test is marked `cuda` and skips where torch sees no card. This file
imports no JAX (the replay's edge grids come from `_replay_cases.py`), so
it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import carry
from repro_torch.core import (POLICY_WEIGHTS, PRICE_VECTORS, cost_foo,
                              miss_costs, sweep_torch, zipf_trace)
from repro_torch.core.trace import next_use_indices, wiki_cdn_like
from repro_torch.kernels import ops, ref
from repro_torch.kernels.evict_argmin import evict_argmin_cuda
from repro_torch.kernels.interval_occupancy import (error_chain,
                                                    interval_occupancy_cuda,
                                                    occupancy_feasible_cuda)
from repro_torch.kernels import _build
from repro_torch.kernels.next_use import next_use_cuda, plan
from repro_torch.kernels.replay_scan import (BYTE_WORK_COLUMNS, WORK_COLUMNS,
                                             replay_bytes_cuda,
                                             replay_scan_cuda)
from repro_torch.kernels import replay_scan as replay_scan_module
from repro_torch.core import replay_bytes_ref
from repro_torch.core.policies_torch import _replay, stack_policy_weights
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.common import tree_map
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _grow

import _replay_cases

pytestmark = pytest.mark.cuda
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("C,N,dtype", [
    (96, 20000, "float32"), (96, 20000, "bfloat16"), (4, 1, "float32"),
    (3, 1001, "float32"), (1, 513, "bfloat16"),
])
def test_evict_argmin_kernel_matches_plain(cuda, C, N, dtype):
    rng = np.random.default_rng(C * N)
    s = torch.tensor(rng.integers(-8, 8, (C, N)).astype(np.float32),
                     device=cuda).to(_TORCH[dtype])
    touch = torch.tensor(rng.integers(2**31 - 100, 2**31 - 1, N)
                         .astype(np.int32), device=cuda)
    mask = torch.tensor(rng.random((C, N)) < 0.5, device=cuda)
    mask[0] = False                       # an empty row
    gi, gv = evict_argmin_cuda(s, touch, mask)
    wi, wv = ref.evict_argmin_ref(s, touch, mask)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    s1 = s[-1].contiguous()
    gi1, gv1 = evict_argmin_cuda(s1, touch, mask[-1].contiguous())
    assert int(gi1) == int(gi[-1]) and float(gv1) == float(gv[-1])


def test_evict_argmin_kernel_nan_and_signed_zero(cuda):
    s = torch.tensor([[3.0, float("nan"), -1.0, 2.0],
                      [0.0, -0.0, 0.0, 1.0],
                      [float("inf"), float("inf"), 5.0, 5.0]], device=cuda)
    touch = torch.tensor([[4, 3, 2, 1], [5, 3, 3, 0], [1, 0, 2, 2]],
                         dtype=torch.int32, device=cuda)
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]],
                        dtype=torch.bool, device=cuda)
    gi, gv = evict_argmin_cuda(s, touch, mask)
    wi, wv = ref.evict_argmin_ref(s, touch, mask)
    assert gi.tolist() == wi.tolist() == [0, 1, 2]
    assert torch.equal(gv, wv)


def _slice_ends(N, row):
    """Index of the last entry of each cluster rank's slice of mask words in
    row `row` of a (C, N) bool mask whose base is 16-byte aligned (as a
    fresh CUDA tensor's is): the kernel's split, in csrc/evict_argmin.cu."""
    head = min(N, (16 - (row * N) % 16) % 16)
    words = (N - head) // 16
    return [head + 16 * (words * (r + 1) // 8) - 1 for r in range(8)
            if words * (r + 1) // 8 > words * r // 8]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 20001])
def test_evict_argmin_kernel_row_lengths(cuda, N, dtype):
    """Rows whose mask starts off 16 bytes (scalar head and tail), a row with
    one cached entry, an empty row with per-row touch, bf16 with odd N."""
    rng = np.random.default_rng(N + 11)
    C = 9
    s = torch.tensor(rng.integers(-8, 8, (C, N)).astype(np.float32),
                     device=cuda).to(_TORCH[dtype])
    mask = torch.tensor(rng.random((C, N)) < 0.3, device=cuda)
    mask[0] = False                       # an empty row
    mask[1] = False
    mask[1, N // 2] = True                # a single cached entry
    for touch in (
            torch.tensor(rng.integers(0, 50, N).astype(np.int32), device=cuda),
            torch.tensor(rng.integers(0, 50, (C, N)).astype(np.int32),
                         device=cuda)):
        gi, gv = evict_argmin_cuda(s, touch, mask)
        wi, wv = ref.evict_argmin_ref(s, touch, mask)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi) and torch.equal(gv, wv)
        assert int(gi[1]) == N // 2


@pytest.mark.parametrize("N", [20000, 20001])
def test_evict_argmin_kernel_winner_at_slice_ends(cuda, N):
    """Row r's only minimum sits in the last entry of cluster rank r % 8's
    slice; with N = 20001 the rows' masks start at every offset mod 16."""
    C = 16
    rng = np.random.default_rng(N)
    s = rng.integers(1, 8, (C, N)).astype(np.float32)
    mask = np.ones((C, N), bool)
    want = []
    for r in range(C):
        ends = _slice_ends(N, r)
        j = ends[r % len(ends)]
        s[r, j] = -1.0
        want.append(j)
    s_t = torch.tensor(s, device=cuda)
    m_t = torch.tensor(mask, device=cuda)
    touch = torch.zeros(N, dtype=torch.int32, device=cuda)
    gi, gv = evict_argmin_cuda(s_t, touch, m_t)
    wi, _ = ref.evict_argmin_ref(s_t, touch, m_t)
    assert gi.tolist() == wi.tolist() == want
    assert gv.tolist() == [-1.0] * C


def test_evict_argmin_kernel_scores_at_or_above_big(cuda):
    """A cached entry scoring 3.4e38 or +inf ties or loses to the uncached
    ones: the kernel then rescans the row densely, as the plain version
    takes the minimum over all N."""
    N = 4099
    s = torch.full((3, N), float("inf"), device=cuda)
    mask = torch.zeros(3, N, dtype=torch.bool, device=cuda)
    mask[0, 4000] = True                  # +inf: any uncached entry wins
    mask[1, 17] = True
    s[1, 17] = 3.4e38                     # ties the uncached entries' score
    mask[2, 9] = True
    s[2, 9] = 1.0
    touch = torch.arange(N, 0, -1, dtype=torch.int32, device=cuda)
    gi, gv = evict_argmin_cuda(s, touch, mask)
    wi, wv = ref.evict_argmin_ref(s, touch, mask)
    assert gi.tolist() == wi.tolist() and torch.equal(gv, wv)
    assert gi.tolist() == [N - 1, N - 1, 9]


def _next_use_ids(rng, T, N, kind):
    """(T,) ids below N: uniform with the largest id N - 1 present, sorted
    either way, all below 1000 (N far above the largest id), with one id
    in half the requests (its run spans every tile of the last pass), or
    Zipf(1.0) ranks (a few hot ids spanning many tiles, a long tail)."""
    if kind == "below1000":
        return rng.integers(0, 1000, T).astype(np.int32)
    if kind == "zipf":
        p = 1.0 / np.arange(1, N + 1)
        return rng.choice(N, T, p=p / p.sum()).astype(np.int32)
    ids = rng.integers(0, N, T)
    if kind == "hot":
        ids[rng.random(T) < 0.5] = rng.integers(0, N)
    ids[rng.integers(0, T)] = N - 1
    if kind == "ascending":
        ids = np.sort(ids)
    elif kind == "descending":
        ids = np.sort(ids)[::-1]
    return np.ascontiguousarray(ids, np.int32)


@pytest.mark.parametrize("T,N,kind", [
    pytest.param(T, N, "uniform", id=f"{T}-{N}")
    for T, N in [(200_000, 20_000), (1, 1), (1000, 1), (4097, 4097),
                 (5000, 100_000),
                 # the largest id at each digit-count boundary
                 (100_000, 256), (100_000, 257), (100_000, 65_536),
                 (100_000, 65_537), (100_000, 2**24 + 1),
                 # the small tile's edges (2048 requests)
                 (2047, 300), (2048, 300), (2049, 300)]
] + [pytest.param(100_000, 5000, "ascending", id="ascending"),
     pytest.param(100_000, 5000, "descending", id="descending"),
     pytest.param(200_000, 2**30, "below1000", id="N-far-above-ids"),
     # the benchmark's shapes, skewed: hot ids' runs span many tiles
     pytest.param(200_000, 20_000, "zipf", id="zipf-20000"),
     pytest.param(200_000, 60_000, "zipf", id="zipf-60000"),
     pytest.param(200_000, 20_000, "hot", id="hot-half"),
     pytest.param(100_000, 200, "hot", id="hot-half-one-digit"),
     pytest.param(5000, 1, "uniform", id="one-id")])
def test_next_use_kernel_matches_plain(cuda, T, N, kind):
    rng = np.random.default_rng(T + N)
    ids = _next_use_ids(rng, T, N, kind)
    ids_t = torch.tensor(ids, device=cuda)
    got = next_use_cuda(ids_t, N)
    assert torch.equal(got, ref.next_use_ref(ids_t, N))
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))
    _assert_rank_beside(ids_t, N, got)


def _assert_rank_beside(ids_t, N, nxt):
    """next_use_cuda with the rank: next(t) unchanged, rank[t] equal to
    the plain rank on the CPU bit for bit."""
    got, rank = next_use_cuda(ids_t, N, rank=True)
    assert torch.equal(got, nxt)
    assert rank.dtype == torch.int32 and rank.shape == nxt.shape
    assert torch.equal(rank.cpu(), ref.frequency_rank_ref(ids_t.cpu()))


@pytest.mark.parametrize("kind", ["uniform", "hot"])
def test_next_use_kernel_three_passes(cuda, kind):
    N = 2**17 + 5                     # ids past 2^16: three digit passes
    rng = np.random.default_rng(3)
    ids = _next_use_ids(rng, 300_001, N, kind)
    ids_t = torch.tensor(ids, device=cuda)
    got = next_use_cuda(ids_t, N)
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))
    _assert_rank_beside(ids_t, N, got)


def _one_wave_items():
    return int(_build.library().next_use_one_wave_items())


@pytest.mark.parametrize("kind", ["uniform", "hot"])
@pytest.mark.parametrize("where", ["one-wave limit", "direct", "direct limit",
                                   "grouped", "grouped, ragged large tile"])
def test_next_use_kernel_paths(cuda, where, kind):
    limit = _one_wave_items()
    T, path = {"one-wave limit": (limit, "one_wave"),
               "direct": (limit + 1, "direct"),
               "direct limit": (2**22, "direct"),
               "grouped": (2**22 + 1, "grouped"),
               "grouped, ragged large tile": (2**24 + 3, "grouped")}[where]
    N = 2**20
    assert plan(T, N, limit)["path"] == path
    rng = np.random.default_rng(T)
    ids = _next_use_ids(rng, T, N, kind)
    ids_t = torch.tensor(ids, device=cuda)
    got = next_use_cuda(ids_t, N)
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))
    _assert_rank_beside(ids_t, N, got)


def test_next_use_kernel_calls_leave_no_state(cuda):
    """A big call, a small one, a refused one and a big one again on one
    stream, and calls on two streams interleaved, all equal the plain
    version: the counters each call leaves behind are the next call's."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    big = torch.randint(0, 2**20, (2**22 + 7,), generator=gen, device=cuda,
                        dtype=torch.int32)
    small = torch.randint(0, 7, (1000,), generator=gen, device=cuda,
                          dtype=torch.int32)
    first = next_use_cuda(big, 2**20)
    assert torch.equal(next_use_cuda(small, 7), ref.next_use_ref(small, 7))
    with pytest.raises(ValueError):
        next_use_cuda(torch.tensor([0, 7], dtype=torch.int32, device=cuda), 7)
    assert torch.equal(next_use_cuda(big, 2**20), first)
    assert torch.equal(first, ref.next_use_ref(big, 2**20))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        a = next_use_cuda(big, 2**20)
    with torch.cuda.stream(s2):
        b = next_use_cuda(small, 7)
    with torch.cuda.stream(s1):
        c = next_use_cuda(small, 7)
    torch.cuda.synchronize()
    assert torch.equal(a, first) and torch.equal(b, c)
    assert torch.equal(b, ref.next_use_ref(small, 7))
    # calls with and without the rank, alternating, on every path
    one_wave = torch.randint(0, 2**15, (200_000,), generator=gen,
                             device=cuda, dtype=torch.int32)
    direct = torch.randint(0, 2**20, (_one_wave_items() + 1,), generator=gen,
                           device=cuda, dtype=torch.int32)
    for ids, n in ((big, 2**20), (one_wave, 2**15), (direct, 2**20),
                   (small, 7)):
        plain_rank = ref.frequency_rank_ref(ids)
        plain_next = ref.next_use_ref(ids, n)
        for _ in range(2):
            nxt, rank = next_use_cuda(ids, n, rank=True)
            assert torch.equal(nxt, plain_next)
            assert torch.equal(rank, plain_rank)
            assert torch.equal(next_use_cuda(ids, n), plain_next)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    s = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        evict_argmin_cuda(s, torch.zeros(8, device=cuda),  # float touch
                          torch.ones(4, 8, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        evict_argmin_cuda(s.t(), torch.zeros(4, dtype=torch.int32,
                                             device=cuda),
                          torch.ones(8, 4, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        next_use_cuda(torch.tensor([0, 5], dtype=torch.int32, device=cuda), 5)


def test_sweep_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 24, 250).astype(np.int32)
    costs = 2.0 ** rng.integers(0, 12, 24)
    cost_matrix = np.stack([costs, 8 * costs, costs / 4, 64 * costs])
    budgets = np.array([2, 4, 8, 12])
    policies = list(POLICY_WEIGHTS)
    ops.reset_launch_counts()
    got = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24)
    assert ops.launch_counts() == {"evict_argmin": 0, "next_use": 1,
                                   "interval_occupancy": 0,
                                   "occupancy_feasible": 0, "replay_scan": 1,
                                   "replay_bytes": 0}
    ops.reset_launch_counts()
    x = _replay_on_card(dict(weights=stack_policy_weights(policies), ids=ids,
                             costs=cost_matrix, sizes=np.ones(24),
                             budgets=budgets), cuda)
    loop, _, _ = _replay(x["weights"], ids, x["nxt"].cpu().numpy(),
                         x["costs"], x["sizes"], x["budgets"],
                         use_kernel=True)      # the trajectory path's loop
    assert ops.launch_counts()["evict_argmin"] == 250
    plain = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24,
                        use_kernel=False)
    want = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24,
                       device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(loop.cpu().numpy(), want)
    np.testing.assert_array_equal(plain, want)


def test_sweep_ranks_on_the_card(cuda, monkeypatch):
    """The kernel path takes the rank from its one next_use call: no host
    rank, one rank launch a job; the plain path takes none."""
    def refuse(*a, **k):
        raise AssertionError("the plain frequency_rank_ref ran")
    from repro_torch.core import policies_torch
    assert not hasattr(policies_torch, "frequency_rank")
    ids, cm, budgets = _sweep_case()
    policies = list(POLICY_WEIGHTS)
    ops.reset_launch_counts()
    with monkeypatch.context() as patch:
        patch.setattr(ref, "frequency_rank_ref", refuse)
        got = [sweep_torch(policies, ids, cm, budgets, num_objects=24)
               for _ in range(3)]
    assert next_use_cuda.rank_launches == 3
    assert ops.launch_counts()["next_use"] == 3
    sweep_torch(policies, ids, cm, budgets, num_objects=24, use_kernel=False)
    assert next_use_cuda.rank_launches == 3
    want = sweep_torch(policies, ids, cm, budgets, num_objects=24,
                       device="cpu")
    for g in got:
        np.testing.assert_array_equal(g, want)


def _sweep_case():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 24, 250).astype(np.int32)
    costs = 2.0 ** rng.integers(0, 12, 24)
    return ids, np.stack([costs, 8 * costs, costs / 4]), np.array([2, 4, 8, 12])


def test_profile_keys_on_card(cuda):
    """The CPU path's keys (`test_profile_keys`) and `work`: the kernel's
    counters as int64 numpy in dollars' shape plus `WORK_COLUMNS`."""
    ids, cm, budgets = _sweep_case()
    columns = len(replay_scan_module.WORK_COLUMNS)
    for policy, shape in (("lru", (3, 4)), (list(POLICY_WEIGHTS), (6, 3, 4))):
        prof = {}
        out = sweep_torch(policy, ids, cm, budgets, num_objects=24,
                          profile=prof)
        assert set(prof) == {"compile_s", "execute_s", "cells", "work"}
        assert out.shape == shape and prof["cells"] == out.size
        assert isinstance(prof["work"], np.ndarray)
        assert prof["work"].dtype == np.int64
        assert prof["work"].shape == shape + (columns,)


def test_sweep_counters_and_spans_on_card(cuda, monkeypatch):
    """`profile["work"]` holds the counts `replay_scan_cuda` gives on the
    same inputs, in every call; without `profile` only dollars and hits
    come back. Under the profiler the spans stay on the host (no copy on
    the card's timeline) and the kernel runs after the replay span opens
    and before the copy back ends."""
    from torch.profiler import ProfilerActivity, profile
    ids, cm, budgets = _sweep_case()
    policies = list(POLICY_WEIGHTS)
    copies, to_numpy = [], carry.to_numpy
    monkeypatch.setattr(carry, "to_numpy",
                        lambda x: copies.append(x.shape) or to_numpy(x))
    sweep_torch(policies, ids, cm, budgets, num_objects=24)
    assert copies == [(6, 3, 4)] * 2
    profs = [{}, {}]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)            # the trace may drop its first events
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for p in profs:
            sweep_torch(policies, ids, cm, budgets, num_objects=24, profile=p)
    x = _replay_on_card(dict(weights=stack_policy_weights(policies), ids=ids,
                             costs=cm, sizes=np.ones(24), budgets=budgets),
                        cuda)
    own = replay_scan_cuda(**x)[2].cpu().numpy()
    for p in profs:
        np.testing.assert_array_equal(p["work"][..., :3], own[..., :3])
    events = prof.events()
    assert not [e.name for e in events if e.name.startswith("repro_torch.")
                and e.device_type == torch.autograd.DeviceType.CUDA]

    def ranges(name):
        return sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == name
                      and e.device_type == torch.autograd.DeviceType.CPU)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "replay_scan_kernel" in e.name)
    replay = ranges("repro_torch.sweep.replay")
    copy_back = ranges("repro_torch.sweep.copy_back")
    assert len(kernels) == len(replay) == len(copy_back) == 2
    for (k0, k1), (r0, _), (_, c1) in zip(kernels, replay, copy_back):
        assert r0 <= k0 <= k1 <= c1


def _replay_on_card(c: dict, dev) -> dict:
    ids = torch.tensor(np.asarray(c["ids"], np.int32), device=dev)
    costs = torch.tensor(np.asarray(c["costs"], np.float32), device=dev)
    return dict(
        weights=torch.tensor(np.asarray(c["weights"], np.float32), device=dev),
        ids=ids, nxt=ref.next_use_ref(ids, costs.shape[1]),
        rank=ref.frequency_rank_ref(ids), costs=costs,
        sizes=torch.tensor(np.asarray(c["sizes"], np.float32), device=dev),
        budgets=torch.tensor(np.asarray(c["budgets"], np.int32), device=dev))


def _launch_order(weights, P: int, K: int) -> np.ndarray:
    """The cells in the replay kernels' launch order: in a grid of more
    cells than the card's SMs (class, q, p, k), class 0 where w_cb != 0, 1
    in GreedyDual rows (w_gd + w_gdsf > 0 in float32), 2 where the score
    is fixed at the touch; in a grid of one wave, the cells' own order."""
    w = np.asarray(weights, np.float32)
    cells = len(w) * P * K
    if cells <= torch.cuda.get_device_properties(0).multi_processor_count:
        return np.arange(cells)
    cls = np.where(w[:, 5] != 0, 0, np.where(w[:, 2] + w[:, 3] > 0, 1, 2))
    rows = np.argsort(cls, kind="stable")
    return (rows[:, None] * (P * K) + np.arange(P * K)).ravel()


def _check_launch(work, columns, weights) -> None:
    """The launch's columns: block b replayed the b-th cell of
    `_launch_order`, and every block's start is at or before its end."""
    work = np.asarray(work)
    col = {c: work[..., j].ravel() for j, c in enumerate(columns)}
    order = _launch_order(weights, *work.shape[1:3])
    np.testing.assert_array_equal(np.sort(col["block"]), np.arange(len(order)))
    np.testing.assert_array_equal(np.argsort(col["block"]), order)
    assert (col["start_ns"] <= col["end_ns"]).all()


def _replay_kernel_against_step_loop(x: dict):
    d, h, work = replay_scan_cuda(**x)
    d2, h2, work2 = replay_scan_cuda(**x)
    pd, ph, _ = _replay(x["weights"], x["ids"].cpu().numpy(),
                        x["nxt"].cpu().numpy(), x["costs"], x["sizes"],
                        x["budgets"], use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(d), _bits(pd)) and torch.equal(h, ph)
    assert torch.equal(_bits(d), _bits(d2)) and torch.equal(h, h2)
    # the counts repeat; the clock64() cycles (columns 3 and 4) are times
    assert torch.equal(work[..., :3], work2[..., :3])
    cycles, evict_cycles = work[..., 3], work[..., 4]
    assert bool((cycles > 0).all()) and bool((evict_cycles >= 0).all())
    assert bool((evict_cycles <= cycles).all())
    assert bool(((evict_cycles > 0) == (work[..., 0] > 0)).all())
    for w in (work, work2):
        _check_launch(w.cpu().numpy(), WORK_COLUMNS, x["weights"].cpu())
    return work


@pytest.mark.parametrize("name", _replay_cases.CASES)
def test_replay_scan_matches_step_loop(cuda, name):
    """The edge grids (NaN and inf scores, growth past the budget, budgets
    0, 1, N and past N, ties) bit-equal to the plain step loop, twice."""
    c = _replay_cases.make(name)
    work = _replay_kernel_against_step_loop(_replay_on_card(c, cuda))
    budgets = torch.tensor(c["budgets"], device=cuda)
    # every cell's table stays within max(budget, 1) or grows only to N
    assert bool((work[..., 2] <= c["costs"].shape[1]).all())
    assert bool((work[..., 0][..., budgets >= c["costs"].shape[1]] == 0).all())


def test_replay_scan_more_cells_than_sms(cuda):
    """240 cells on 132 SMs: bit-equal to the step loop, each block on the
    cell of its place in the launch order (w_cb != 0 rows, GreedyDual's,
    the rest), which puts those rows' cells in the first wave."""
    c = _replay_cases.make("lognormal")
    c = dict(c, weights=np.concatenate([c["weights"]] * 3))   # 240 cells
    work = _replay_kernel_against_step_loop(_replay_on_card(c, cuda))
    block = work[..., WORK_COLUMNS.index("block")].cpu().numpy()
    slow = np.asarray(c["weights"])[:, 5] != 0
    assert block[slow].max() < block[~slow].min()


def test_replay_scan_map_and_slots_in_device_memory(cuda):
    """N = 2^17: the map lives in device memory, and the budget-N cell's
    table outgrows shared memory and moves there."""
    rng = np.random.default_rng(11)
    N, T = 2**17, 20_000
    c = dict(weights=_replay_cases.weights()[[0, 4, 7]],
             ids=rng.integers(0, N, T), costs=rng.lognormal(-12, 1.5, (1, N)),
             sizes=np.ones(N), budgets=np.array([N, 12_000]))
    x = _replay_on_card(c, cuda)
    layout = replay_scan_module.plan(
        6, N, _build.library().replay_scan_shared_limit())
    assert not layout["map_shared"] and layout["slots_shared"] < N
    work = _replay_kernel_against_step_loop(x)
    assert int(work[..., 2].max()) > layout["slots_shared"]
    assert int(work[..., 1, 0].sum()) > 0      # budget 12,000 scores there


def _bytes_sweep(c: dict, device=None, **kw):
    return sweep_torch(c["weights"], c["ids"], c["costs"], c["budgets"],
                       num_objects=c["costs"].shape[1], sizes=c["sizes"],
                       return_hits=True, budget_unit="bytes", device=device,
                       **kw)


def _most_resident(sizes, budget) -> int:
    """The most objects that fit in `budget` bytes: the smallest sizes'."""
    return int(np.searchsorted(np.cumsum(np.sort(sizes)), budget,
                               side="right"))


def _bytes_against_reference(c: dict, runs: int = 2, plain: str = "cpu"):
    """The byte kernel's grid `runs` times against the plain reference and
    the plain step loop on `plain`: dollars' bits, hits, victims and
    fetch-throughs, the counts repeating and no cell's table past the most
    objects its budget holds. Returns the last run's work."""
    _, _, victims, fetched, _ = replay_bytes_ref.replay_grid(
        c["ids"], c["costs"], c["sizes"], c["weights"], c["budgets"])
    want_d, want_h = _bytes_sweep(c, plain, use_kernel=False)
    works = []
    for _ in range(runs):
        prof = {}
        d, h = _bytes_sweep(c, profile=prof)
        work = prof["work"]
        np.testing.assert_array_equal(d.view(np.int32),
                                      want_d.view(np.int32))
        np.testing.assert_array_equal(h, want_h)
        assert work.shape == h.shape + (len(BYTE_WORK_COLUMNS),)
        np.testing.assert_array_equal(work[..., 5], victims.numpy())
        np.testing.assert_array_equal(work[..., 6], fetched.numpy())
        for k, b in enumerate(c["budgets"]):
            assert (work[..., k, 2] <= _most_resident(c["sizes"], b)).all()
        # every victim is a scored step's; the clock's columns are times
        assert (work[..., 5] <= work[..., 0]).all()
        assert (work[..., 4] <= work[..., 3]).all()
        # the bounds leave slots out only in rows with w_cb > 0
        rescanned, scored = work[..., 7], work[..., 1]
        assert (rescanned <= scored).all()
        off = ~(np.asarray(c["weights"])[:, 5] > 0)
        np.testing.assert_array_equal(rescanned[off], scored[off])
        _check_launch(work, BYTE_WORK_COLUMNS, c["weights"])
        works.append(work)
    # the counts and the launch order repeat; the clock's columns are times
    for work in works[1:]:
        np.testing.assert_array_equal(work[..., :3], works[0][..., :3])
        np.testing.assert_array_equal(work[..., 5:9], works[0][..., 5:9])
    return works[-1]


@pytest.mark.parametrize("name", _replay_cases.BYTE_CASES)
def test_replay_bytes_matches_step_loop(cuda, name):
    """The byte kernel (one `replay_bytes` launch a grid, no
    `replay_scan`) bit-equal to the plain step loop on the CPU, twice, with
    the plain reference's victims and fetch-throughs in its new work
    columns."""
    c = _replay_cases.make_bytes(name)
    ops.reset_launch_counts()
    work = _bytes_against_reference(c)
    counts = ops.launch_counts()
    assert counts["replay_bytes"] == 2 and counts["replay_scan"] == 0
    if name == "pareto":
        # budget 0 fetches every request through; at half the largest size
        # the objects larger than the budget are
        assert (work[..., 0, 6] == len(c["ids"])).all()
        assert (work[..., 1, 6] > 0).all()


def test_replay_bytes_more_cells_than_sms(cuda):
    """270 byte cells on 132 SMs: bit-equal to the plain step loop and the
    plain reference, each block on the cell of its place in the launch
    order, the w_cb != 0 rows' cells in the first wave."""
    c = _replay_cases.make_bytes("pareto")
    c = dict(c, weights=np.concatenate([c["weights"]] * 3))   # 270 cells
    work = _bytes_against_reference(c)
    block = work[..., BYTE_WORK_COLUMNS.index("block")]
    slow = np.asarray(c["weights"])[:, 5] != 0
    assert block[slow].max() < block[~slow].min() and block[slow].size < 132


def test_replay_bytes_table_in_device_memory(cuda):
    """Tables past the shared slots: 20,000 objects of 1-4 bytes under a
    budget that holds ~12,000, so those cells' tables move to device
    memory; the other budget's stay in shared memory."""
    rng = np.random.default_rng(12)
    N, T = 20_000, 20_000
    ids = np.concatenate([rng.permutation(N)[:15_000],
                          rng.integers(0, N, T - 15_000)]).astype(np.int32)
    sizes = rng.integers(1, 5, N).astype(np.float64)
    c = dict(weights=_replay_cases.weights()[[0, 3, 5, 6]], ids=ids,
             costs=rng.lognormal(-12.0, 1.5, (1, N)), sizes=sizes,
             budgets=np.array([30_000, 8_000], np.int64))
    layout = replay_scan_module.plan(
        8, N, _build.library().replay_bytes_shared_limit(), by_bytes=True)
    assert layout["slots_shared"] < _most_resident(sizes, c["budgets"][0])
    work = _bytes_against_reference(c, runs=1)
    assert int(work[..., 0, 2].max()) > layout["slots_shared"]
    assert int(work[..., 1, 2].max()) <= layout["slots_shared"]
    assert (work[..., 0, 5] > 0).all()


def test_replay_bytes_bounds_on_spilled_cost_belady_tables(cuda):
    """wiki_cdn_like at 2 and 4 % of its catalog's bytes, 60,000 objects:
    cost-Belady's table outgrows the shared slots at 4 %, and its many
    one-hit objects tie at -3.4e38, told apart by their touches. Its
    evicting steps score fewer slots than they consider, from the group
    bounds, and the grid keeps its bits; LRU's score them all. The plain
    step loop runs on the card (it equals the CPU's, which takes minutes
    at 100,000 requests)."""
    tr = wiki_cdn_like(n_objects=60_000, n_requests=100_000, seed=3)
    sizes = np.ceil(tr.sizes)
    rows = ["lru", "cost_belady"]
    c = dict(weights=stack_policy_weights(rows), ids=tr.ids,
             costs=miss_costs(sizes, PRICE_VECTORS["s3_internet"])[None],
             sizes=sizes, budgets=np.array([int(0.02 * sizes.sum()),
                                            int(0.04 * sizes.sum())]))
    assert (next_use_indices(tr.ids) >= len(tr.ids)).mean() > 0.3
    layout = replay_scan_module.plan(
        len(rows) * 2, 60_000, _build.library().replay_bytes_shared_limit(),
        by_bytes=True)
    work = _bytes_against_reference(c, runs=1, plain="cuda")[:, 0]
    cb = rows.index("cost_belady")
    spilled = work[cb, :, 2] > layout["slots_shared"]
    assert spilled[1]
    assert (work[cb, spilled, 7] < work[cb, spilled, 1]).all()
    np.testing.assert_array_equal(work[:cb, :, 7], work[:cb, :, 1])


def test_replay_bytes_unit_sizes_equal_page_kernel(cuda):
    """Every size 1 and budgets of B bytes: the page kernel's grid at B
    pages, bit for bit (the six policies and the mixed row)."""
    c = _replay_cases.make_bytes("unit")
    c["weights"] = c["weights"][:7]
    d, h = _bytes_sweep(c)
    pd, ph = sweep_torch(c["weights"], c["ids"], c["costs"],
                         c["budgets"].astype(np.int32),
                         num_objects=c["costs"].shape[1], sizes=c["sizes"],
                         return_hits=True)
    np.testing.assert_array_equal(d.view(np.int32), pd.view(np.int32))
    np.testing.assert_array_equal(h, ph)


def test_replay_bytes_wrapper_rejects_bad_inputs(cuda):
    c = _replay_cases.make_bytes("ties")
    x = _replay_on_card(dict(c, budgets=c["budgets"].astype(np.int32)), cuda)
    with pytest.raises(ValueError):      # float sizes, int32 budgets
        replay_bytes_cuda(**x)
    x["sizes"] = x["sizes"].to(torch.int32)
    with pytest.raises(ValueError):      # int32 budgets
        replay_bytes_cuda(**x)
    x["budgets"] = x["budgets"].to(torch.int64)
    d, h, work = replay_bytes_cuda(**x)
    want_d, want_h = _bytes_sweep(c, "cpu")
    np.testing.assert_array_equal(d.cpu().numpy().view(np.int32),
                                  want_d.view(np.int32))
    np.testing.assert_array_equal(h.cpu().numpy(), want_h)


_TILE = 4096   # the replaced design's tile; the carry tree has radix 256
_SCAN_T = [1, 31, 4095, 4096, 4097, 200_000, 2**24 + 3,
           # tile boundaries (2048-item tiles up to 2^21 items, 4096 above), the
           # carry tree's level-1 nodes (256 tiles) and the switch of tile size
           2 * _TILE - 1, 2 * _TILE, 2 * _TILE + 1,
           2**19 - 1, 2**19, 2**19 + 1, 2**20 - 1, 2**20, 2**20 + 1,
           2**21, 2**21 + 1, 3 * 2**20 - 1, 3 * 2**20, 3 * 2**20 + 1]


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("T", _SCAN_T)
def test_scan_kernels_match_plain_on_integer_deltas(cuda, T, dtype):
    """Integer-valued deltas keep every partial sum exact in float32, so the
    kernels equal the plain versions bit for bit; two runs give equal bits."""
    rng = np.random.default_rng(T)
    d = torch.tensor(rng.integers(-3, 4, T).astype(np.float32), device=cuda)
    d = d.to(torch.int32) if dtype == "int32" else d
    z = torch.tensor(rng.integers(0, 8, T).astype(np.float32), device=cuda)
    occ, ex = occupancy_feasible_cuda(d, z)
    occ2, ex2 = occupancy_feasible_cuda(d, z)
    scan = interval_occupancy_cuda(d)
    w_occ, w_ex = ref.occupancy_feasible_ref(d, z)
    assert torch.equal(occ, w_occ) and torch.equal(scan, w_occ)
    assert torch.equal(ex, w_ex)
    assert torch.equal(_bits(occ), _bits(occ2)) and \
        torch.equal(_bits(ex), _bits(ex2))


def _byte_deltas(rng, T, dtype):
    """Range-adds of a schedule of byte-sized intervals (sizes up to the
    94 MB of wiki_cdn_like's largest object) in float64, cast to the
    kernel's input type."""
    n = max(1, T // 4)
    t = rng.integers(0, T, n)
    u = np.minimum(t + rng.geometric(1e-3, n), T)
    size = np.minimum(rng.lognormal(11.5, 2.5, n), 9.4e7)
    d = np.zeros(T)
    np.add.at(d, t, size)
    np.add.at(d, u[u < T], -size[u < T])
    if dtype == "int32":
        return np.rint(d).astype(np.int32)
    return d.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("T", _SCAN_T)
def test_scan_kernels_within_rounding_bound_on_byte_sizes(cuda, T, dtype):
    """With byte sizes partial sums round. Each occ[p] must lie within
    k * 2^-24 * sum_{q<=p} |d_q| of the exact prefix sum (k from the
    kernel's source), and the excess within that bound plus one rounding
    of occ - zcap. The float32 plain version is no yardstick here: PyTorch's
    scan on the card chains its tiles and has no such bound."""
    rng = np.random.default_rng(T + 1)
    d = _byte_deltas(rng, T, dtype)
    d32 = d.astype(np.float32).astype(np.float64)   # what the kernel adds
    exact = np.cumsum(d32)
    z = (exact + rng.normal(0, 1e6, T)).astype(np.float32)
    d_t = torch.tensor(d, device=cuda)
    occ, ex = occupancy_feasible_cuda(d_t, torch.tensor(z, device=cuda))
    occ2, ex2 = occupancy_feasible_cuda(d_t, torch.tensor(z, device=cuda))
    scan = interval_occupancy_cuda(d_t)
    assert torch.equal(_bits(occ), _bits(occ2)) and \
        torch.equal(_bits(ex), _bits(ex2))
    assert torch.equal(_bits(scan), _bits(occ))
    got = occ.cpu().numpy().astype(np.float64)
    bound = error_chain(T) * 2.0**-24 * np.cumsum(np.abs(d32))
    assert (np.abs(got - exact) <= bound).all(), \
        float(np.max(np.abs(got - exact) - bound))
    gap = got - z.astype(np.float64)
    ex_exact = float(np.max(exact - z.astype(np.float64)))
    ex_bound = float(bound.max() + 2.0**-24 * np.abs(gap).max())
    assert abs(float(ex) - ex_exact) <= ex_bound


def test_scan_kernels_repeat_bits_on_byte_sizes(cuda):
    """50 calls at 2^24 + 3 items of byte sizes give equal bits: carries
    have a fixed association, whatever order the blocks publish in."""
    T = 2**24 + 3
    rng = np.random.default_rng(3)
    d = torch.tensor(_byte_deltas(rng, T, "float32"), device=cuda)
    z = torch.tensor(rng.normal(0, 1e9, T).astype(np.float32), device=cuda)
    occ, ex = occupancy_feasible_cuda(d, z)
    first = interval_occupancy_cuda(d)
    for _ in range(50):
        o2, e2 = occupancy_feasible_cuda(d, z)
        assert torch.equal(_bits(o2), _bits(occ)) and \
            torch.equal(_bits(e2), _bits(ex))
        assert torch.equal(_bits(interval_occupancy_cuda(d)), _bits(first))
    assert torch.equal(_bits(first), _bits(occ))


def test_scan_kernels_three_tree_levels(cuda):
    """Past 256^2 tiles (2^28 items) the carry tree has a third level, whose
    nodes are formed by the block that completes their last child."""
    T = 65536 * _TILE + _TILE + 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    d = torch.randint(-3, 4, (T,), generator=gen, device=cuda,
                      dtype=torch.int32)
    z = torch.randint(0, 8, (T,), generator=gen, device=cuda,
                      dtype=torch.int32).float()
    occ, ex = occupancy_feasible_cuda(d, z)
    w_occ, w_ex = ref.occupancy_feasible_ref(d, z)
    assert torch.equal(occ, w_occ) and torch.equal(ex, w_ex)
    assert torch.equal(interval_occupancy_cuda(d.float()), w_occ)


def test_scan_kernels_interleaved_sizes_and_streams(cuda):
    """The scratch the wrapper keeps (one per device, stream and size) is
    left ready for the next call, whatever sizes and streams come between."""
    rng = np.random.default_rng(9)
    sizes = [5000, 300_001, 5000, 1, 300_001, 4097]
    data = [torch.tensor(rng.integers(-3, 4, T).astype(np.float32),
                         device=cuda) for T in sizes]
    side = torch.cuda.Stream()
    for rep in range(3):
        for d in data:
            with torch.cuda.stream(side if rep == 1 else
                                   torch.cuda.current_stream()):
                got = interval_occupancy_cuda(d)
                want = ref.interval_occupancy_ref(d)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("T", _SCAN_T + [2**26])
def test_scan_error_chain_no_looser_than_reduce_then_scan(cuda, T):
    """k of the rounding bound is no larger than that of the three-kernel
    reduce-then-scan this design replaced, 2*ceil(tiles/1024) + 36."""
    tiles = -(-T // _TILE)
    assert error_chain(T) <= 2 * -(-tiles // 1024) + 36


def test_scan_kernels_nan_and_bad_inputs(cuda):
    d = torch.tensor([1.0, float("nan"), 2.0], device=cuda)
    z = torch.zeros(3, device=cuda)
    _, ex = occupancy_feasible_cuda(d, z)
    _, w_ex = ref.occupancy_feasible_ref(d, z)
    assert bool(torch.isnan(ex)) and bool(torch.isnan(w_ex))
    empty = torch.zeros(0, device=cuda)
    with pytest.raises(ValueError):
        occupancy_feasible_cuda(empty, empty)
    with pytest.raises(ValueError):
        interval_occupancy_cuda(empty)
    with pytest.raises(ValueError):
        interval_occupancy_cuda(torch.zeros(4, dtype=torch.float64,
                                            device=cuda))
    with pytest.raises(ValueError):
        occupancy_feasible_cuda(torch.zeros(4, device=cuda),
                                torch.zeros(5, device=cuda))
    with pytest.raises(ValueError):
        interval_occupancy_cuda(torch.zeros(8, device=cuda)[::2])


def test_cost_foo_validate_on_card_matches_cpu(cuda):
    tr = zipf_trace(n_objects=120, n_requests=6000, sigma=1.2,
                    mean_size=32 * 1024, seed=11)
    costs = miss_costs(tr.sizes, PRICE_VECTORS["gcs_internet"])
    B = float(np.quantile(tr.sizes, 0.8) * 30)
    ops.reset_launch_counts()
    card = cost_foo(tr, costs, B, policies=("gdsf",), validate=True)
    assert ops.launch_counts()["occupancy_feasible"] == 1
    host = cost_foo(tr, costs, B, policies=("gdsf",), validate=True,
                    device="cpu")
    assert (card.lower, card.upper, card.bracket) == \
        (host.lower, host.upper, host.bracket)



@pytest.mark.parametrize("arch,capacity", [("phi4-mini-3.8b", 3400),
                                           ("gemma3-4b", 13000)])
def test_serve_engine_on_card_matches_cpu(cuda, arch, capacity):
    """The smoke-config engine on the card bills exactly what the same
    engine bills on the CPU (the bill depends only on the keys and the
    blobs' lengths), and its bf16 prefill and decode logits agree with the
    CPU's within bf16 tolerance (rtol 2e-2, atol 1e-2: a few units in the
    last place of an 8-bit mantissa, the two devices sum in other orders)."""
    model = get_model(get_config(arch, smoke=True))
    host = model.init(0, device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    kw = dict(prefix_cache_bytes=capacity, govern=True, governor_window=4)
    engines = {"cpu": ServeEngine(model, host, device="cpu", **kw),
               "cuda": ServeEngine(model, card, **kw)}
    rng = np.random.default_rng(3)
    pool = [rng.integers(0, 256, n).astype(np.int32) for n in (8, 8, 16, 16)]
    rounds = [[pool[i] for i in rng.choice(4, 3)] for _ in range(8)]
    for engine in engines.values():
        for r, prompts in enumerate(rounds):
            engine.serve([Request(10 * r + j, p, 3)
                          for j, p in enumerate(prompts)])
    a, b = engines["cpu"], engines["cuda"]
    assert b.store.meter.snapshot() == a.store.meter.snapshot()
    assert (b.cache.hits, b.cache.misses) == (a.cache.hits, a.cache.misses)
    assert b.audit() == a.audit()
    assert b.governance_snapshot()["metrics"] == \
        a.governance_snapshot()["metrics"]
    assert {k: len(v) for k, v in b.store._data.items()} == \
        {k: len(v) for k, v in a.store._data.items()}
    tokens = torch.from_numpy(np.stack(pool[2:]).astype(np.int64))
    nxt = torch.tensor([5, 7])
    got = {}
    for dev, params in (("cpu", host), ("cuda", card)):
        prefill, caches = model.prefill(params, {"tokens": tokens.to(dev)})
        decode, _ = model.decode_step(params, nxt.to(dev),
                                      _grow(model, caches, 18), 16)
        got[dev] = [x.float().cpu().numpy() for x in (prefill, decode)]
    for on_card, on_host in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(on_card, on_host, rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("S", [1, 512, 2304])
def test_moe_layer_full_width_same_bits_twice(cuda, S):
    """One qwen2-moe-a2.7b MoE layer at full width (60 experts of 2048 x
    1408, top-4, 4 shared) on the card: two calls on the same input give
    the same bits, on the decode gather (S = 1) and on the dispatch (C = 42
    and 192 slots an expert), where the combine adds each token's
    contributions in a fixed order with no atomics."""
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = init_params(moe.moe_ffn_defs(cfg), gen, cfg.param_dtype)
    B = 4 if S < 2304 else 1
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=cuda) \
        .to(cfg.param_dtype)
    a = moe.moe_ffn_apply(cfg, p, x)
    b = moe.moe_ffn_apply(cfg, p, x.clone())
    torch.cuda.synchronize()
    assert a.shape == x.shape and bool(torch.isfinite(a.float()).all())
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-large-v3",
                                  "recurrentgemma-9b", "xlstm-125m"])
def test_family_smoke_on_card_matches_cpu(cuda, arch):
    """The vlm, encdec, hybrid and xlstm families at their smoke configs,
    float32 with TF32 off, on the card against the CPU on the same weights
    and inputs: forward, prefill (logits and every cache or state) and two
    decode steps after `_grow`, within rtol = atol = 1e-4 (the two devices
    sum products in other orders); the caches given to decode are left
    unchanged."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=torch.float32)
    model = get_model(cfg)
    host = model.init(0, device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    rng = np.random.default_rng(5)
    S = 24
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, S)))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 30, cfg.d_model)).astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = {}
        for dev, params in (("cpu", host), ("cuda", card)):
            b = {k: v.to(dev) for k, v in batch.items()}
            outs = [model.forward(params, b)]
            logits, caches = model.prefill(params, b)
            outs.append(logits)
            outs += [t for layer in caches for t in layer]
            caches = _grow(model, caches, S + 2)
            tok = torch.tensor([3, 5], device=dev)
            for step in range(2):
                kept = [t.clone() for layer in caches for t in layer]
                logits, new = model.decode_step(params, tok, caches, S + step)
                assert all(torch.equal(a, b) for a, b in
                           zip(kept, [t for layer in caches for t in layer]))
                outs.append(logits)
                outs += [t for layer in new for t in layer]
                caches = new
            got[dev] = [t.float().cpu().numpy() for t in outs]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert len(got["cuda"]) == len(got["cpu"])
    for on_card, on_host in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(on_card, on_host, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: one step on the card against the CPU, and crash-and-resume


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "xlstm-125m"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """A smoke config in float32 with TF32 off: the loss and every
    gradient leaf on the card against the CPU within 2^-12 (of the loss,
    of the leaf's max |g|), then one update of each optimizer from the same
    parameters and the CPU's gradients within 2^-16 of the leaf's max |p|
    (chip_smoke.py's train_numerics tolerances)."""
    import dataclasses
    from repro_torch.train import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.models.common import tree_leaves
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=torch.float32)
    model = get_model(cfg)
    host = model.init(0, device="cpu")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda t: t.to(dev), host)
            got[dev] = value_and_grad(
                lambda p, b: model.loss_fn(p, b), params,
                {k: v.to(dev) for k, v in batch.items()})
        (hl, hg), (cl, cg) = got["cpu"], got["cuda"]
        assert abs(float(cl) - float(hl)) <= 2.0 ** -12 * abs(float(hl))
        for c, h in zip(tree_leaves(cg), tree_leaves(hg)):
            assert float((c.cpu() - h).abs().max()) <= \
                2.0 ** -12 * float(h.abs().max())
        for name in ("adamw", "adafactor", "sgd"):
            opt = make_optimizer(OptimizerConfig(name=name, lr=1e-3))
            new = {}
            for dev in ("cpu", "cuda"):
                p = tree_map(lambda t: t.to(dev), host)
                g = tree_map(lambda t: t.to(dev), hg)
                new[dev], _ = opt.update(g, opt.init(p), p)
            for c, h, p in zip(tree_leaves(new["cuda"]),
                               tree_leaves(new["cpu"]), tree_leaves(host)):
                assert float((c.cpu() - h).abs().max()) <= \
                    2.0 ** -16 * float(p.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_train_crash_resume_on_card_is_bit_identical(cuda, tmp_path,
                                                      monkeypatch):
    """tests/test_fault_tolerance.py's crash-and-resume at the smoke config
    on the card, with PyTorch's deterministic algorithms on: the resumed
    run's final loss, parameters and optimizer state equal an
    uninterrupted run's bit for bit."""
    from repro_torch.egress import EgressCache, ObjectStore
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import (DataPipeline, DriverConfig,
                                   FailureInjector, OptimizerConfig,
                                   ShardedTokenDataset, TrainDriver,
                                   make_optimizer, make_train_step)

    def setup(path):
        cfg = get_config("xlstm-125m", smoke=True)
        model = get_model(cfg)
        opt = make_optimizer(OptimizerConfig(name="adamw", lr=1e-3))
        params = model.init(0, device=cuda)
        store = ObjectStore("s3_internet")
        ds = ShardedTokenDataset(store, num_shards=4, shard_tokens=2048,
                                 vocab=cfg.vocab_size).register()
        cache = EgressCache(store, capacity_bytes=4 * 2048 * 4,
                            policy="gdsf")
        return TrainDriver(
            DriverConfig(checkpoint_dir=str(path), max_steps=12,
                         checkpoint_every=4),
            make_train_step(model, opt), params, opt.init(params),
            DataPipeline(ds, cache, batch_size=2, seq_len=16), device=cuda)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ref = setup(tmp_path / "ref")
        ref_out = ref.run()
        crash = setup(tmp_path / "crash")
        crash.failure = FailureInjector(fail_at=(9,))
        with pytest.raises(RuntimeError, match="injected node failure"):
            crash.run()
        resumed = setup(tmp_path / "crash")
        assert resumed.resume() and resumed.step == 8
        out = resumed.run()
    finally:
        torch.use_deterministic_algorithms(was)
    assert out["steps"] == ref_out["steps"] == 12
    assert out["final_loss"] == ref_out["final_loss"]
    for a, b in zip(tree_leaves([ref.params, ref.opt_state]),
                    tree_leaves([resumed.params, resumed.opt_state])):
        assert a.device.type == "cuda" and b.device.type == "cuda"
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# sharding: DTensor on a 1x1 mesh of the card, and the stacked layout

_NCCL_STEP = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh, start_process_group
from repro_torch.models import get_model
from repro_torch.models.common import set_activation_mesh, tree_leaves
from repro_torch.parallel import batch_spec, distribute, make_rules
from repro_torch.train import OptimizerConfig, make_optimizer, make_train_step
from repro_torch.train.trainer import train_state_shardings
arch, opt_name = sys.argv[1], sys.argv[2]
start_process_group("nccl")
mesh = make_mesh((1, 1), ("data", "model"), "cuda")
model = get_model(get_config(arch, smoke=True))
opt = make_optimizer(OptimizerConfig(name=opt_name))
rules = make_rules(mesh)
ps, osd, _, _ = train_state_shardings(rules, model, opt)
params = model.init(0, device="cuda")
state = opt.init(params)
toks = torch.randint(0, model.cfg.vocab_size, (4, 16),
                     generator=torch.Generator().manual_seed(2)).cuda()
batch = {"tokens": toks, "labels": toks}
l0, p0, s0 = make_train_step(model, opt, microbatches=2)(params, state, batch)
set_activation_mesh(mesh)
step = make_train_step(model, opt, microbatches=2, grad_shardings=ps)
l1, p1, s1 = step(distribute(params, ps), distribute(state, osd),
                  distribute(batch, batch_spec(rules, batch)))
print(json.dumps(dict(loss=[float(l0), float(l1)], equal=all(
    torch.equal(a, b.full_tensor())
    for a, b in zip(tree_leaves([p0, s0]), tree_leaves([p1, s1]))))))
"""


@pytest.mark.parametrize("arch,opt", [("phi4-mini-3.8b", "adafactor"),
                                      ("qwen2-moe-a2.7b", "adamw")])
def test_sharded_step_on_card_mesh_bit_equal(cuda, arch, opt):
    """A smoke config's two-microbatch step with DTensor parameters on a
    1x1 mesh of the card (an nccl group of one rank, in a subprocess: one
    default group a process) against the plain step: loss and every new
    leaf bit-equal."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, "-c", _NCCL_STEP, arch, opt],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["loss"][0] == out["loss"][1] and out["equal"]


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen2-moe-a2.7b",
                                  "kimi-k2-1t-a32b"])
def test_stacked_loss_on_card_equals_loss_fn(cuda, arch):
    """The scanned loss on the stacked layout equals `loss_fn` bit for bit
    on the card, and the round trip between the layouts is exact."""
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    model = get_model(get_config(arch, smoke=True))
    params = model.init(0, device=cuda)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 32), device=cuda)
    batch = {"tokens": toks, "labels": toks}
    sp = transformer.params_to_stacked(model.cfg, params)
    assert torch.equal(transformer.loss_fn_scanned(model.cfg, sp, batch),
                       model.loss_fn(params, batch))
    back = transformer.stacked_to_params(model.cfg, sp)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
