"""The port's kernels on the CPU: plain versions against the JAX package's
oracles and Pallas kernels (interpret mode), and the dispatch. The CUDA
kernels are held against the plain versions in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.trace import next_use_indices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.evict_argmin import evict_argmin_cuda
from repro_torch.kernels.next_use import next_use_cuda

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _argmin_inputs(rng, N, dtype, p_mask=0.5):
    scores = rng.standard_normal(N).astype(np.float32)
    touch = rng.integers(0, 10_000, N).astype(np.int32)
    mask = rng.random(N) < p_mask
    return scores, touch, mask


def _port_argmin(scores, touch, mask, dtype):
    s = torch.tensor(scores).to(_TORCH[dtype])
    return ref.evict_argmin_ref(s, torch.tensor(touch), torch.tensor(mask))


# the shapes of tests/test_kernels.py::test_evict_argmin_shapes
@pytest.mark.parametrize("N,block_n,dtype", [
    (128, 64, "float32"), (1000, 256, "float32"), (8192, 2048, "float32"),
    (555, 128, "bfloat16"), (2048, 512, "bfloat16"),
])
def test_evict_argmin_plain_matches_reference(N, block_n, dtype):
    rng = np.random.default_rng(N)
    scores, touch, mask = _argmin_inputs(rng, N, dtype)
    if not mask.any():
        mask[0] = True
    s = jnp.asarray(scores).astype(_JNP[dtype])
    wi, wv = jref.evict_argmin_ref(s, jnp.asarray(touch), jnp.asarray(mask))
    pi, pv = jops.evict_argmin(s, jnp.asarray(touch), jnp.asarray(mask),
                               block_n=block_n)
    gi, gv = _port_argmin(scores, touch, mask, dtype)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    assert int(gi) == int(wi) == int(pi)
    np.testing.assert_allclose(float(gv), np.float32(wv), rtol=1e-6)
    np.testing.assert_allclose(float(gv), np.float32(pv), rtol=1e-6)


def test_evict_argmin_lexicographic_ties():
    scores = torch.zeros(512)
    touch = torch.arange(512, 0, -1, dtype=torch.int32)  # last entry oldest
    gi, _ = ref.evict_argmin_ref(scores, touch, torch.ones(512, dtype=bool))
    assert int(gi) == 511
    # equal score and touch: the smaller index wins; -0.0 ties with 0.0
    scores = torch.tensor([0.0, -0.0, 0.0, 1.0])
    touch = torch.tensor([5, 3, 3, 0], dtype=torch.int32)
    gi, gv = ref.evict_argmin_ref(scores, touch, torch.ones(4, dtype=bool))
    assert int(gi) == 1 and float(gv) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evict_argmin_empty_mask(dtype):
    rng = np.random.default_rng(5)
    scores, touch, _ = _argmin_inputs(rng, 128, dtype)
    mask = np.zeros(128, bool)
    gi, gv = _port_argmin(scores, touch, mask, dtype)
    wi, _ = jref.evict_argmin_ref(jnp.asarray(scores).astype(_JNP[dtype]),
                                  jnp.asarray(touch), jnp.asarray(mask))
    assert float(gv) > 1e37
    assert int(gi) == int(wi) == int(np.argmin(touch))


def test_evict_argmin_nan_row_matches_reference():
    scores = np.array([3.0, np.nan, -1.0, 2.0], np.float32)
    touch = np.array([4, 3, 2, 1], np.int32)
    mask = np.ones(4, bool)
    wi, _ = jref.evict_argmin_ref(jnp.asarray(scores), jnp.asarray(touch),
                                  jnp.asarray(mask))
    gi, gv = _port_argmin(scores, touch, mask, "float32")
    assert int(gi) == int(wi) == 0 and float(gv) == 3.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared_touch", [True, False])
def test_evict_argmin_batch_matches_rows(dtype, shared_touch):
    rng = np.random.default_rng(11)
    C, N = 7, 300
    scores = rng.integers(-4, 4, (C, N)).astype(np.float32)  # many ties
    touch = rng.integers(0, 50, N if shared_touch else (C, N)).astype(np.int32)
    mask = rng.random((C, N)) < 0.3
    mask[2] = False                                           # an empty row
    s = torch.tensor(scores).to(_TORCH[dtype])
    bi, bv = ref.evict_argmin_ref(s, torch.tensor(touch), torch.tensor(mask))
    assert bi.shape == (C,) and bv.shape == (C,)
    for c in range(C):
        tc = touch if shared_touch else touch[c]
        ri, rv = ref.evict_argmin_ref(s[c], torch.tensor(tc),
                                      torch.tensor(mask[c]))
        assert int(bi[c]) == int(ri) and float(bv[c]) == float(rv)


# the shapes of tests/test_kernels.py::test_next_use_shapes
@pytest.mark.parametrize("T,N", [
    (64, 8), (100, 5), (1000, 37), (4096, 513), (777, 13), (1, 1),
    (2048, 2048), (50, 1),
])
def test_next_use_plain_matches_reference(T, N):
    rng = np.random.default_rng(T * 31 + N)
    ids = rng.integers(0, N, T).astype(np.int32)
    got = ref.next_use_ref(torch.tensor(ids), N)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), next_use_indices(ids, N))


@pytest.mark.parametrize("T,N,block_t", [(100, 5, 32), (777, 13, 128),
                                         (1, 1, 8)])
def test_next_use_plain_matches_pallas(T, N, block_t):
    rng = np.random.default_rng(T + N)
    ids = rng.integers(0, N, T).astype(np.int32)
    want = np.asarray(jops.next_use(jnp.asarray(ids), N, block_t=block_t))
    np.testing.assert_array_equal(ref.next_use_ref(torch.tensor(ids), N),
                                  want)


def test_dispatch_on_cpu_uses_plain_version():
    ops.reset_launch_counts()
    s, tch = torch.zeros(8), torch.zeros(8, dtype=torch.int32)
    m = torch.ones(8, dtype=bool)
    gi, _ = ops.evict_argmin(s, tch, m)
    assert int(gi) == 0
    ids = torch.tensor([0, 1, 0], dtype=torch.int32)
    assert ops.next_use(ids, 2).tolist() == [2, 3, 3]
    assert ops.launch_counts() == {"evict_argmin": 0, "next_use": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    s, tch = torch.zeros(8), torch.zeros(8, dtype=torch.int32)
    m = torch.ones(8, dtype=bool)
    with pytest.raises(ValueError):
        evict_argmin_cuda(s, tch, m)
    with pytest.raises(ValueError):
        ops.evict_argmin(s, tch, m, use_kernel=True)
    with pytest.raises(ValueError):
        next_use_cuda(torch.zeros(4, dtype=torch.int32), 1)
