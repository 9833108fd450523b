"""The port's CUDA kernels and its replay on the card, against their plain
PyTorch versions. Every test is marked `cuda` and skips where torch sees no
card. This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import POLICY_WEIGHTS, sweep_torch
from repro_torch.core.trace import next_use_indices
from repro_torch.kernels import ops, ref
from repro_torch.kernels.evict_argmin import evict_argmin_cuda
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
    assert ops.launch_counts() == {"evict_argmin": 250, "next_use": 1}
    plain = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24,
                        use_kernel=False)
    want = sweep_torch(policies, ids, cost_matrix, budgets, num_objects=24,
                       device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
