"""The port's replay (`policies_torch`) against the JAX replay and the host
heap reference, on the CPU with the plain kernel versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Trace, simulate
from repro.core.policies_jax import POLICY_WEIGHTS as JAX_WEIGHTS
from repro.core.policies_jax import _simulate as jax_simulate
from repro.core.policies_jax import simulate_jax, stack_policy_weights, sweep_jax
from repro.core.trace import next_use_indices
from repro_torch.core import policies_torch as pt

POLICIES = ["lru", "lfu", "gds", "gdsf", "belady", "cost_belady"]
SEEDS = dict(zip(POLICIES, range(101, 107)))


def _rand(rng, T, N):
    ids = rng.integers(0, N, T).astype(np.int32)
    # power-of-two costs: every score the policies form is exact in f32
    costs = 2.0 ** rng.integers(0, 12, N)
    return ids, costs


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_weights_match(policy):
    np.testing.assert_array_equal(pt.POLICY_WEIGHTS[policy].as_array(),
                                  JAX_WEIGHTS[policy].as_array())


@pytest.mark.parametrize("policy", POLICIES)
def test_trajectory_matches_jax_step_for_step(policy):
    rng = np.random.default_rng(SEEDS[policy])
    for T, N, B in [(180, 16, 5), (120, 9, 1), (90, 30, 12)]:
        ids, costs = _rand(rng, T, N)
        nxt = next_use_indices(ids).astype(np.int32)
        w = JAX_WEIGHTS[policy].as_array()
        d_j, h_j, (dol_j, hit_j) = jax_simulate(
            jnp.asarray(ids), jnp.asarray(nxt), jnp.asarray(costs, jnp.float32),
            jnp.ones(N, jnp.float32), jnp.int32(B), jnp.asarray(w), N,
            use_pallas=False, trace_steps=True)
        d_t, h_t, (dol_t, hit_t) = pt._simulate(
            torch.tensor(ids), torch.tensor(nxt),
            torch.tensor(costs, dtype=torch.float32), torch.ones(N), B,
            torch.tensor(w), N, trace_steps=True)
        np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
        np.testing.assert_array_equal(dol_t.numpy(), np.asarray(dol_j))
        assert float(d_t) == float(d_j) and int(h_t) == int(h_j)


def test_multi_policy_sweep_matches_jax():
    """The inputs of test_policies_jax.py::test_multi_policy_sweep_matches_per_cell."""
    rng = np.random.default_rng(7)
    ids, costs = _rand(rng, 250, 24)
    cost_matrix = np.stack([costs, 8 * costs, costs / 4, 64 * costs])
    budgets = np.array([2, 4, 8, 12])
    want = sweep_jax(POLICIES, ids, cost_matrix, budgets, num_objects=24)
    got = pt.sweep_torch(POLICIES, ids, cost_matrix, budgets, num_objects=24,
                         device="cpu")
    assert got.shape == (6, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_single_policy_sweep_and_weight_stack():
    rng = np.random.default_rng(8)
    ids, costs = _rand(rng, 120, 10)
    sizes = 2.0 ** rng.integers(0, 4, 10)
    cm = np.stack([costs, 2 * costs])
    single = pt.sweep_torch("gdsf", ids, cm, np.array([3, 5]), num_objects=10,
                            sizes=sizes, device="cpu")
    assert single.shape == (2, 2)
    np.testing.assert_array_equal(
        single, sweep_jax("gdsf", ids, cm, np.array([3, 5]), num_objects=10,
                          sizes=sizes))
    stack = stack_policy_weights(["lru", "belady"])
    out = pt.sweep_torch(stack, ids, costs[None, :], np.array([3]),
                         num_objects=10, device="cpu")
    names = pt.sweep_torch(["lru", "belady"], ids, costs[None, :],
                           np.array([3]), num_objects=10, device="cpu")
    assert out.shape == (2, 1, 1)
    np.testing.assert_array_equal(out, names)
    with pytest.raises(ValueError):
        pt.sweep_torch(np.zeros((2, 5), np.float32), ids, costs[None, :],
                       np.array([3]), num_objects=10, device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_hits_match_host_reference(policy):
    rng = np.random.default_rng(SEEDS[policy] + 50)
    for trial in range(4):
        T = int(rng.integers(50, 200))
        N = int(rng.integers(5, 30))
        B = int(rng.integers(1, max(2, N // 2)))
        ids, costs = _rand(rng, T, N)
        want = simulate(policy, Trace(ids=ids, sizes=np.ones(N)), costs,
                        float(B))
        d, h = pt.simulate_torch(policy, ids, costs, B, num_objects=N,
                                 device="cpu")
        assert h == want.hits, f"{policy} trial={trial}"
        assert d == want.dollars, f"{policy} trial={trial}"


@pytest.mark.parametrize("policy", POLICIES)
def test_lognormal_costs_match_host_reference(policy):
    rng = np.random.default_rng(2024)
    T, N, B = 400, 40, 8
    ids = rng.integers(0, N, T).astype(np.int32)
    costs = rng.lognormal(-12.0, 1.5, N)
    want = simulate(policy, Trace(ids=ids, sizes=np.ones(N)), costs, float(B))
    d, h = pt.simulate_torch(policy, ids, costs, B, num_objects=N,
                             device="cpu")
    assert h == want.hits
    assert d == pytest.approx(want.dollars, rel=1e-5)
    dj, hj = simulate_jax(policy, ids, costs, B, num_objects=N,
                          use_pallas=False)
    assert h == hj and d == pytest.approx(dj, rel=1e-6)


def test_profile_keys():
    rng = np.random.default_rng(3)
    ids, costs = _rand(rng, 60, 8)
    prof = {}
    out = pt.sweep_torch(["lru", "gds"], ids, np.stack([costs, costs]),
                         np.array([2, 3, 4]), num_objects=8, device="cpu",
                         profile=prof)
    assert set(prof) == {"compile_s", "execute_s", "cells"}
    assert prof["cells"] == out.size == 12
    assert prof["execute_s"] > 0 and prof["compile_s"] >= 0


def test_no_profiler_no_spans(monkeypatch):
    """With no profiler running a sweep opens no profiler range at all."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range was built")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    rng = np.random.default_rng(4)
    ids, costs = _rand(rng, 40, 6)
    for profile in (None, {}):
        pt.sweep_torch("lfu", ids, costs[None], np.array([2, 3]),
                       num_objects=6, device="cpu", profile=profile)


def test_spans_nest_in_phase_order():
    """Under a profiler the CPU path's five spans nest in the call's order,
    on the host and none of them a user annotation (which the profiler
    would copy onto a card's timeline)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    ids, costs = _rand(rng, 50, 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.sweep_torch(["lru", "belady"], ids, np.stack([costs, 2 * costs]),
                       np.array([2, 4]), num_objects=7, device="cpu")
    spans = sorted((e.time_range.start, e.time_range.end, e.name, e)
                   for e in prof.events()
                   if e.name.startswith("repro_torch."))
    names = [n for _, _, n, _ in spans]
    assert names == ["repro_torch.sweep", "repro_torch.sweep.prepare",
                     "repro_torch.sweep.next_use", "repro_torch.sweep.replay",
                     "repro_torch.sweep.copy_back"]
    (lo, hi, _, _), children = spans[0], spans[1:]
    for (a, b, _, _), (c, _, _, _) in zip(children, children[1:]):
        assert a <= b <= c
    assert lo <= children[0][0] and children[-1][1] <= hi
    for *_, e in spans:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not getattr(e, "is_user_annotation", False)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids = np.array([0, 1, 0], np.int32)
    costs = np.ones(2)
    with pytest.raises(RuntimeError):
        pt.sweep_torch("lru", ids, costs[None], np.array([1]), num_objects=2)
    with pytest.raises(RuntimeError):
        pt.simulate_torch("lru", ids, costs, 1, num_objects=2)
    assert pt.simulate_torch("lru", ids, costs, 1, num_objects=2,
                             device="cpu") == (3.0, 0)
