"""The port's cost-FOO against the JAX package's on the traces and budgets
of tests/test_cost_foo.py. Both are the same float64 host code (the
interval arrays, the HiGHS LP, the segment-tree rounding), so the bracket
and the solver counters must be equal exactly; only the schedule check
differs: the reference replays it through interpreted Pallas, the port
(with device="cpu") through the plain PyTorch scan."""
import importlib

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc

# the modules (the packages' `cost_foo` names the function)
r_cf = importlib.import_module("repro.core.cost_foo")
t_cf = importlib.import_module("repro_torch.core.cost_foo")

_COUNTERS = ("requests", "paid_intervals", "epochs", "crossing_intervals",
             "rounded_intervals")


def _zipf(price, q, mult, **kw):
    tr = rc.zipf_trace(**kw)
    costs = rc.miss_costs(tr.sizes, rc.PRICE_VECTORS[price])
    return tr, costs, float(np.quantile(tr.sizes, q) * mult)


def _uniform(seed, T, N, B, sigma):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, T).astype(np.int32)
    costs = rng.lognormal(0, sigma, N)
    return rc.Trace(ids=ids, sizes=np.ones(N)), costs, float(B)


def _instance(case):
    """(trace, costs, B, policies) of one case of tests/test_cost_foo.py."""
    kind, arg = case
    if kind == "lower_below_upper":
        tr = rc.zipf_trace(n_objects=80, n_requests=1200,
                           mean_size=32 * 1024, seed=2)
        costs = rc.miss_costs(tr.sizes, rc.PRICE_VECTORS["gcs_internet"])
        return tr, costs, float(np.sort(tr.sizes)[-20:].sum()), \
            ("gdsf", "gds", "cost_belady", "belady")
    if kind == "tight":
        return (*_zipf("s3_internet", 0.8, 25, n_objects=100,
                       n_requests=1500, sigma=1.5, mean_size=64 * 1024,
                       seed=arg), ("gdsf", "gds", "cost_belady", "belady"))
    if kind == "uniform_exact":
        return (*_uniform(3, 500, 30, 8, 2.0),
                ("gdsf", "belady", "cost_belady"))
    if kind == "uniform_lp":
        return (*_uniform(4, 400, 25, 6, 1.5),
                ("gdsf", "belady", "cost_belady"))
    if kind == "rounding":
        return (*_zipf("s3_internet", 0.8, 18, n_objects=60, n_requests=900,
                       sigma=1.4, mean_size=48 * 1024, seed=arg), ("gdsf",))
    if kind == "epochs":
        return (*_zipf("gcs_internet", 0.8, 30, n_objects=120,
                       n_requests=6000, sigma=1.2, mean_size=32 * 1024,
                       seed=11), ("gdsf",))
    if kind == "covering":
        return (*_zipf("s3_internet", 0.8, 15, n_objects=50, n_requests=1200,
                       mean_size=16 * 1024, seed=7), ("gdsf",))
    assert kind == "validate"
    return (*_zipf("s3_internet", 0.8, 12, n_objects=40, n_requests=800,
                   mean_size=24 * 1024, seed=5), ("gdsf",))


_CASES = ([("lower_below_upper", None)] + [("tight", s) for s in range(6)]
          + [("uniform_exact", None), ("uniform_lp", None)]
          + [("rounding", s) for s in range(4)]
          + [("epochs", None), ("covering", None), ("validate", None)])


def _port_trace(tr):
    return tc.Trace(ids=tr.ids, sizes=tr.sizes)


@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("epoch_len", [None, 1500])
@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cost_foo_matches_reference(case, epoch_len, validate):
    tr, costs, B, policies = _instance(case)
    a = rc.cost_foo(tr, costs, B, policies=policies, epoch_len=epoch_len,
                    validate=validate)
    b = tc.cost_foo(_port_trace(tr), costs, B, policies=policies,
                    epoch_len=epoch_len, validate=validate,
                    device="cpu" if validate else None)
    assert (b.lower, b.upper, b.total_no_cache, b.bracket) == \
        (a.lower, a.upper, a.total_no_cache, a.bracket)
    for key in _COUNTERS:
        assert b.profile.get(key) == a.profile.get(key), key
    assert b.lower <= b.upper + 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_rounding_matches_reference(seed):
    """The fixed seeds of test_segment_tree_rounding_matches_reference."""
    tr, costs, B, _ = _instance(("rounding", seed))
    _, _, x, paid = rc.lp_opt(tr.ids, costs, tr.sizes, B)
    want = rc.round_fractional(tr.ids, tr.sizes, B, x, paid,
                               return_accepted=True)
    got = tc.round_fractional(tr.ids, tr.sizes, B, x, paid,
                              return_accepted=True)
    assert got == want
    assert tc.round_fractional_reference(tr.ids, tr.sizes, B, x, paid) == \
        rc.round_fractional_reference(tr.ids, tr.sizes, B, x, paid) == \
        want[0]


def _schedule(case):
    """A rounded schedule of one case, in the arrays _validate_schedule
    takes: (pt, pu, pz, accepted, zcap, T, B)."""
    tr, costs, B, _ = _instance(case)
    _, _, x, paid = rc.lp_opt(tr.ids, costs, tr.sizes, B)
    _, accepted = rc.round_fractional(tr.ids, tr.sizes, B, x, paid,
                                      return_accepted=True)
    pt = np.array([iv.t for iv in paid], np.int64)
    pu = np.array([iv.u for iv in paid], np.int64)
    pz = np.array([iv.size for iv in paid], np.float64)
    zcap = rc.zcap_profile(tr.ids, tr.sizes, B)
    return pt, pu, pz, accepted, zcap, len(tr.ids), B


def _lowered_cap(pt, pu, pz, accepted, zcap, T, B):
    """zcap lowered at the schedule's tightest instant to one accepted
    object's size below the occupancy there."""
    acc = np.asarray(accepted, np.int64)
    occ = np.cumsum(rc.interval_deltas(pt[acc], pu[acc], pz[acc], T))
    p = int(np.argmax(occ[1:] - zcap[1:])) + 1
    bad = zcap.copy()
    bad[p] = occ[p] - float(pz[acc].max())
    return bad


@pytest.mark.parametrize("case", [("validate", None), ("epochs", None)],
                         ids=lambda c: c[0])
def test_infeasible_schedule_raises_like_reference(case):
    pt, pu, pz, accepted, zcap, T, B = _schedule(case)
    assert accepted
    # the feasible schedule passes both checks
    r_cf._validate_schedule(pt, pu, pz, accepted, zcap, T, B, None)
    t_cf._validate_schedule(pt, pu, pz, accepted, zcap, T, B, None,
                            torch.device("cpu"))
    bad = _lowered_cap(pt, pu, pz, accepted, zcap, T, B)
    with pytest.raises(AssertionError, match="exceeds zcap"):
        r_cf._validate_schedule(pt, pu, pz, accepted, bad, T, B, None)
    with pytest.raises(AssertionError, match="exceeds zcap"):
        t_cf._validate_schedule(pt, pu, pz, accepted, bad, T, B, None,
                                torch.device("cpu"))


def test_validate_without_a_card_raises(monkeypatch):
    """validate=True resolves its device: with none named and no card it
    raises instead of carrying on on the CPU; validate=False stays on the
    host and needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr, costs, B, policies = _instance(("validate", None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.cost_foo(_port_trace(tr), costs, B, policies=policies,
                    validate=True)
    r = tc.cost_foo(_port_trace(tr), costs, B, policies=policies)
    assert r.lower <= r.upper + 1e-9
