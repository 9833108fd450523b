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
from repro_torch.kernels.next_use import next_use_cuda, shared_table_entries

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


@pytest.mark.parametrize("T,N", [(200_000, 20_000), (1, 1), (1000, 1),
                                 (4097, 4097), (5000, 100_000)])
def test_next_use_kernel_matches_plain(cuda, T, N):
    rng = np.random.default_rng(T + N)
    ids = rng.integers(0, N, T).astype(np.int32)
    ids_t = torch.tensor(ids, device=cuda)
    got = next_use_cuda(ids_t, N)
    assert torch.equal(got, ref.next_use_ref(ids_t, N))
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))


def test_next_use_kernel_global_table(cuda):
    N = shared_table_entries() + 1           # one past the shared table
    rng = np.random.default_rng(1)
    ids = rng.integers(0, N, 30_001).astype(np.int32)
    got = next_use_cuda(torch.tensor(ids, device=cuda), N)
    np.testing.assert_array_equal(got.cpu().numpy(), next_use_indices(ids, N))


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


_SCAN_T = [1, 31, 4095, 4096, 4097, 200_000, 2**24 + 3]


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

