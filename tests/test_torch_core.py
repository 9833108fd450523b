"""The port's copies of the host modules against the JAX package's originals,
and the carry of the reference's inputs into tensors."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.policies_jax import stack_policy_weights as jax_stack
import repro_torch.core as tc
from repro_torch.core import carry
from repro_torch.core import opt_exact as t_opt
from repro.core import opt_exact as r_opt


@pytest.mark.parametrize("name", sorted(rc.PRICE_VECTORS))
def test_price_vectors_match(name):
    a, b = rc.PRICE_VECTORS[name], tc.PRICE_VECTORS[name]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.crossover_bytes == b.crossover_bytes
    assert rc.crossover_bytes(a) == tc.crossover_bytes(b)
    sizes = np.random.default_rng(1).lognormal(6.0, 2.0, 300)
    np.testing.assert_array_equal(rc.miss_costs(sizes, a),
                                  tc.miss_costs(sizes, b))
    assert a.miss_cost_scalar(1234.5) == b.miss_cost_scalar(1234.5)
    ids = np.random.default_rng(2).integers(0, 300, 2000)
    assert rc.heterogeneity(ids, rc.miss_costs(sizes, a)) == \
        tc.heterogeneity(ids, tc.miss_costs(sizes, b))


_GENERATORS = [
    ("zipf_trace", dict(seed=3)),
    ("zipf_trace", dict(seed=4, size_dist="uniform", alpha=1.1)),
    ("two_class_trace", dict(seed=5)),
    ("twemcache_like", dict(n_objects=500, n_requests=4000, seed=6)),
    ("wiki_cdn_like", dict(n_objects=900, n_requests=3000, seed=7)),
]


@pytest.mark.parametrize("gen,kw", _GENERATORS)
def test_trace_generators_bit_equal(gen, kw):
    a, b = getattr(rc, gen)(**kw), getattr(tc, gen)(**kw)
    assert a.name == b.name
    assert a.ids.dtype == b.ids.dtype and a.sizes.dtype == b.sizes.dtype
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.sizes, b.sizes)
    assert a.reuse_fraction() == b.reuse_fraction()
    np.testing.assert_array_equal(rc.next_use_indices(a.ids),
                                  tc.next_use_indices(b.ids))


def _instance(seed, T=300, N=25):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N, T).astype(np.int32), rng.lognormal(-14, 1.2, N)


@pytest.mark.parametrize("seed,B", [(0, 1), (1, 3), (2, 6), (3, 12)])
def test_exact_opt_uniform_matches(seed, B):
    ids, costs = _instance(seed)
    a = rc.exact_opt_uniform(ids, costs, B, return_selected=True)
    b = tc.exact_opt_uniform(ids, costs, B, return_selected=True)
    assert a.dollars == b.dollars and a.savings == b.savings
    assert a.hits == b.hits


@pytest.mark.parametrize("seed", [10, 11])
def test_exact_opt_uniform_sweep_matches(seed):
    ids, costs = _instance(seed, T=600, N=40)
    budgets = np.array([1, 2, 4, 8, 16])
    a = rc.exact_opt_uniform_sweep(ids, costs, budgets)
    b = tc.exact_opt_uniform_sweep(ids, costs, budgets)
    np.testing.assert_array_equal(a.dollars, b.dollars)
    np.testing.assert_array_equal(a.hits, b.hits)


def test_brute_force_oracles_and_lp_match():
    ids, costs = _instance(20, T=14, N=5)
    for B in (1, 2, 3):
        assert r_opt.dp_opt_uniform(ids, costs, B) == \
            t_opt.dp_opt_uniform(ids, costs, B)
    sizes = np.random.default_rng(21).uniform(1, 4, 5)
    a, b = r_opt.lp_opt(ids, costs, sizes, 5.0), t_opt.lp_opt(ids, costs,
                                                              sizes, 5.0)
    assert a[0] == pytest.approx(b[0], rel=1e-12)


def test_regret_table_matches():
    tr_a = rc.twemcache_like(n_objects=150, n_requests=1500, seed=9)
    tr_b = tc.twemcache_like(n_objects=150, n_requests=1500, seed=9)
    costs = rc.miss_costs(tr_a.sizes, rc.PRICE_VECTORS["s3_internet"])
    tr_a = rc.Trace(ids=tr_a.ids, sizes=np.ones(150))
    tr_b = tc.Trace(ids=tr_b.ids, sizes=np.ones(150))
    assert rc.regret_table(tr_a, costs, 16) == tc.regret_table(tr_b, costs, 16)
    assert rc.regret(3.0, 2.0) == tc.regret(3.0, 2.0)


@pytest.mark.parametrize("policy", ["lru", "lfu", "gds", "gdsf", "belady",
                                    "cost_belady"])
def test_host_policies_match(policy):
    tr = rc.zipf_trace(n_objects=60, n_requests=800, seed=12)
    costs = rc.miss_costs(tr.sizes, rc.PRICE_VECTORS["gcs_internet"])
    cap = float(np.quantile(tr.sizes, 0.5) * 8)
    a = rc.simulate(policy, tr, costs, cap)
    b = tc.simulate(policy, tc.Trace(ids=tr.ids, sizes=tr.sizes), costs, cap)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert rc.total_cost_no_cache(tr, costs) == tc.total_cost_no_cache(tr, costs)


def test_carry_weight_stack_round_trip():
    names = ["lru", "lfu", "gds", "gdsf", "belady", "cost_belady"]
    ref = jax_stack(names)
    got = carry.weight_stack(ref, "cpu")
    assert got.dtype == torch.float32 and got.shape == (6, 6)
    np.testing.assert_array_equal(carry.to_numpy(got), ref)
    np.testing.assert_array_equal(tc.stack_policy_weights(names), ref)
    with pytest.raises(ValueError):
        carry.weight_stack(np.zeros((2, 5)), "cpu")


def test_carry_trace_and_costs():
    tr = rc.twemcache_like(n_objects=100, n_requests=500, seed=1)
    cm = np.stack([rc.miss_costs(tr.sizes, pv)
                   for pv in rc.PRICE_VECTORS.values()])
    ids, sizes = carry.trace_tensors(tr.ids, tr.sizes, "cpu")
    assert ids.dtype == torch.int32 and sizes.dtype == torch.float32
    np.testing.assert_array_equal(carry.to_numpy(ids), tr.ids)
    np.testing.assert_array_equal(carry.to_numpy(sizes),
                                  tr.sizes.astype(np.float32))
    c = carry.cost_matrix(cm, "cpu")
    assert c.shape == (4, 100) and c.dtype == torch.float32
    np.testing.assert_array_equal(carry.to_numpy(c), cm.astype(np.float32))
    _, ones = carry.trace_tensors(tr.ids, None, "cpu", num_objects=100)
    assert ones.shape == (100,) and bool((ones == 1).all())


@pytest.mark.parametrize("gen,kw", _GENERATORS)
def test_interval_arrays_and_caps_match(gen, kw):
    """build_interval_arrays, interval_deltas and zcap_profile, which
    cost-FOO builds its LP and its schedule check from, equal the
    originals."""
    tr = getattr(rc, gen)(**kw)
    costs = rc.miss_costs(tr.sizes, rc.PRICE_VECTORS["gcs_internet"])
    a = r_opt.build_interval_arrays(tr.ids, costs, tr.sizes)
    b = t_opt.build_interval_arrays(tr.ids, costs, tr.sizes)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    t, u, _, _, size = a
    T = len(tr.ids)
    keep = np.random.default_rng(1).random(len(t)) < 0.5
    np.testing.assert_array_equal(
        r_opt.interval_deltas(t[keep], u[keep], size[keep], T),
        t_opt.interval_deltas(t[keep], u[keep], size[keep], T))
    for B in (float(np.median(tr.sizes)), float(tr.sizes.sum())):
        np.testing.assert_array_equal(r_opt.zcap_profile(tr.ids, tr.sizes, B),
                                      t_opt.zcap_profile(tr.ids, tr.sizes, B))

