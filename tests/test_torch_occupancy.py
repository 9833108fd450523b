"""The port's occupancy scans on the CPU: the plain versions against the JAX
package's Pallas kernels (interpret mode) and jnp oracles on the reference's
own shape cases, and the dispatch. Integer-valued deltas make every partial
sum exact in float32, so occupancy and excess must be bit-equal. The CUDA
kernel is held against the plain versions in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import exact_opt_uniform
from repro_torch.kernels import ops, ref
from repro_torch.kernels.interval_occupancy import (interval_occupancy_cuda,
                                                    occupancy_feasible_cuda)

_JNP = {"float32": jnp.float32, "int32": jnp.int32}
_TORCH = {"float32": torch.float32, "int32": torch.int32}


# the cases of tests/test_kernels.py::test_interval_occupancy_shapes
@pytest.mark.parametrize("T,block_t,dtype", [
    (100, 32, "float32"), (4096, 1024, "float32"), (777, 256, "float32"),
    (2000, 512, "int32"),
])
def test_interval_occupancy_matches_pallas(T, block_t, dtype):
    rng = np.random.default_rng(T)
    deltas = rng.integers(-3, 4, T).astype(np.float32)
    d_j = jnp.asarray(deltas).astype(_JNP[dtype])
    pallas = np.asarray(jops.interval_occupancy(d_j, block_t=block_t))
    oracle = np.asarray(jref.interval_occupancy_ref(d_j)).astype(np.float32)
    got = ops.interval_occupancy(torch.tensor(deltas).to(_TORCH[dtype]))
    assert got.dtype == torch.float32 and got.shape == (T,)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), oracle)


# the cases of tests/test_kernels.py::test_occupancy_feasible_shapes
@pytest.mark.parametrize("T,block_t,dtype", [
    (100, 32, "float32"), (4096, 1024, "float32"), (777, 256, "float32"),
    (2000, 512, "int32"), (1, 8, "float32"), (2049, 2048, "float32"),
])
def test_occupancy_feasible_matches_pallas(T, block_t, dtype):
    rng = np.random.default_rng(T * 7 + 1)
    deltas = rng.integers(-3, 4, T).astype(np.float32)
    zcap = rng.integers(0, 8, T).astype(np.float32)
    d_j = jnp.asarray(deltas).astype(_JNP[dtype])
    p_occ, p_ex = jops.occupancy_feasible(d_j, jnp.asarray(zcap),
                                          block_t=block_t)
    w_occ, w_ex = jref.occupancy_feasible_ref(d_j, jnp.asarray(zcap))
    occ, ex = ops.occupancy_feasible(torch.tensor(deltas).to(_TORCH[dtype]),
                                     torch.tensor(zcap))
    assert occ.dtype == ex.dtype == torch.float32 and ex.dim() == 0
    np.testing.assert_array_equal(occ.numpy(), np.asarray(p_occ))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(w_occ))
    assert float(ex) == float(p_ex) == float(w_ex)


def test_occupancy_feasible_sign():
    """excess <= 0 iff the schedule fits under zcap at every instant."""
    deltas = np.array([2.0, 1.0, -1.0, 3.0], np.float32)
    zcap_ok = np.array([5.0, 5.0, 5.0, 5.0], np.float32)
    zcap_bad = np.array([5.0, 5.0, 5.0, 4.0], np.float32)
    _, ex_ok = ops.occupancy_feasible(torch.tensor(deltas),
                                      torch.tensor(zcap_ok))
    _, ex_bad = ops.occupancy_feasible(torch.tensor(deltas),
                                       torch.tensor(zcap_bad))
    _, p_bad = jops.occupancy_feasible(jnp.asarray(deltas),
                                       jnp.asarray(zcap_bad), block_t=2)
    assert float(ex_ok) <= 0.0       # occ = [2,3,2,5] fits under 5
    assert float(ex_bad) == float(p_bad) == 1.0   # 5 vs cap 4


def test_occupancy_of_opt_schedule_respects_budget():
    """The port's exact optimum's schedule, through the port's scan, is
    feasible at every serving instant (tests/test_kernels.py's case)."""
    rng = np.random.default_rng(7)
    T, N, B = 2000, 100, 12
    ids = rng.integers(0, N, T).astype(np.int32)
    costs = rng.lognormal(0, 2, N)
    r = exact_opt_uniform(ids, costs, B, return_selected=True)
    deltas = np.zeros(T, np.float32)
    for iv in r.selected:
        deltas[iv.t + 1] += 1
        if iv.u < T:
            deltas[iv.u] -= 1
    occ = ops.interval_occupancy(torch.tensor(deltas))
    pallas = np.asarray(jops.interval_occupancy(jnp.asarray(deltas)))
    np.testing.assert_array_equal(occ.numpy(), pallas)
    assert float(occ.max()) <= B - 1 + 1e-6


def test_dispatch_on_cpu_uses_plain_version():
    ops.reset_launch_counts()
    deltas = torch.tensor([1.0, 2.0, -3.0])
    zcap = torch.tensor([1.0, 2.0, 0.5])
    assert ops.interval_occupancy(deltas).tolist() == [1.0, 3.0, 0.0]
    occ, ex = ops.occupancy_feasible(deltas, zcap)
    assert occ.tolist() == [1.0, 3.0, 0.0] and float(ex) == 1.0
    occ, ex = ops.occupancy_feasible(deltas, zcap, use_kernel=False)
    assert float(ex) == 1.0
    assert ops.launch_counts() == {"evict_argmin": 0, "next_use": 0,
                                   "interval_occupancy": 0,
                                   "occupancy_feasible": 0, "replay_scan": 0,
                                   "replay_bytes": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    deltas, zcap = torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError):
        interval_occupancy_cuda(deltas)
    with pytest.raises(ValueError):
        occupancy_feasible_cuda(deltas, zcap)
    with pytest.raises(ValueError):
        ops.interval_occupancy(deltas, use_kernel=True)
    with pytest.raises(ValueError):
        ops.occupancy_feasible(deltas, zcap, use_kernel=True)
    assert interval_occupancy_cuda.launches == 0
    assert occupancy_feasible_cuda.launches == 0


def test_empty_schedule_raises():
    """T = 0 has no max: the plain version raises, as the kernel's wrapper
    does on the card."""
    empty = torch.zeros(0)
    with pytest.raises((RuntimeError, IndexError, ValueError)):
        ops.occupancy_feasible(empty, empty)
