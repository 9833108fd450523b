"""The port's CUDA kernels and its replay on the card, against their plain
PyTorch versions. Every test is marked `cuda` and skips where torch sees no
card. This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (POLICY_WEIGHTS, PRICE_VECTORS, cost_foo,
                              miss_costs, sweep_torch, zipf_trace)
from repro_torch.core.trace import next_use_indices
from repro_torch.kernels import ops, ref
from repro_torch.kernels.evict_argmin import evict_argmin_cuda
from repro_torch.kernels.interval_occupancy import (error_chain,
                                                    interval_occupancy_cuda,
                                                    occupancy_feasible_cuda)
from repro_torch.kernels import _build
from repro_torch.kernels.next_use import next_use_cuda, plan

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
    either way, or all below 1000 (N far above the largest id)."""
    if kind == "below1000":
        return rng.integers(0, 1000, T).astype(np.int32)
    ids = rng.integers(0, N, T)
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
     pytest.param(200_000, 2**30, "below1000", id="N-far-above-ids")])
def test_next_use_kernel_matches_plain(cuda, T, N, kind):
    rng = np.random.default_rng(T + N)
    ids = _next_use_ids(rng, T, N, kind)
    ids_t = torch.tensor(ids, device=cuda)
    got = next_use_cuda(ids_t, N)
    assert torch.equal(got, ref.next_use_ref(ids_t, N))
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))


def test_next_use_kernel_three_passes(cuda):
    N = 2**17 + 5                     # ids past 2^16: three digit passes
    rng = np.random.default_rng(3)
    ids = _next_use_ids(rng, 300_001, N, "uniform")
    got = next_use_cuda(torch.tensor(ids, device=cuda), N)
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))


def _one_wave_items():
    return int(_build.library().next_use_one_wave_items())


@pytest.mark.parametrize("where", ["one-wave limit", "direct", "direct limit",
                                   "grouped", "grouped, ragged large tile"])
def test_next_use_kernel_paths(cuda, where):
    limit = _one_wave_items()
    T, path = {"one-wave limit": (limit, "one_wave"),
               "direct": (limit + 1, "direct"),
               "direct limit": (2**22, "direct"),
               "grouped": (2**22 + 1, "grouped"),
               "grouped, ragged large tile": (2**24 + 3, "grouped")}[where]
    N = 2**20
    assert plan(T, N, limit)["path"] == path
    rng = np.random.default_rng(T)
    ids = _next_use_ids(rng, T, N, "uniform")
    got = next_use_cuda(torch.tensor(ids, device=cuda), N)
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))


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
    assert ops.launch_counts() == {"evict_argmin": 250, "next_use": 1,
                                   "interval_occupancy": 0,
                                   "occupancy_feasible": 0}
    plain = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24,
                        use_kernel=False)
    want = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24,
                       device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


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

