"""Hypothesis properties of the port's cost-FOO rounding: the port's mirror
of tests/test_cost_foo_property.py.

The segment-tree `round_fractional` must be bit-identical to the quadratic
`round_fractional_reference` (and to the JAX package's), and its accepted
schedule must respect zcap everywhere, checked through the port's own
`ops.occupancy_feasible` (its plain version on the CPU). Sizes are drawn
integer-valued, so all occupancy arithmetic is exact. `_round_arrays`
returns the accepted intervals as a list of indices.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as rc  # noqa: E402
from repro_torch.core import (build_interval_arrays,  # noqa: E402
                              interval_deltas, lp_opt, round_fractional,
                              round_fractional_reference, zcap_profile)
from repro_torch.core.cost_foo import _round_arrays, _round_tol  # noqa: E402
from repro_torch.core.opt_exact import Interval  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _draw_instance(data):
    T = data.draw(st.integers(4, 60))
    N = data.draw(st.integers(2, 8))
    ids = np.array(data.draw(st.lists(st.integers(0, N - 1),
                                      min_size=T, max_size=T)), np.int32)
    sizes = np.array(data.draw(st.lists(st.integers(1, 9),
                                        min_size=N, max_size=N)), np.float64)
    B = float(data.draw(st.integers(1, 30)))
    return ids, sizes, B


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_segment_tree_rounding_bit_identical(data):
    """Fast rounding == quadratic reference == the JAX package's, bit for
    bit, on any fractional x."""
    ids, sizes, B = _draw_instance(data)
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    costs = rng.lognormal(0.0, 1.0, len(sizes))
    t, u, obj, save, size = build_interval_arrays(ids, costs, sizes)
    if len(t) == 0:
        return
    x = rng.random(len(t))
    paid = [Interval(int(tt), int(uu), int(oo), float(sv), float(sz))
            for tt, uu, oo, sv, sz in zip(t, u, obj, save, size)]
    fast = round_fractional(ids, sizes, B, x, paid, return_accepted=True)
    assert fast[0] == round_fractional_reference(ids, sizes, B, x, paid)
    assert fast == rc.round_fractional(ids, sizes, B, x, paid,
                                       return_accepted=True)


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_rounded_schedule_never_exceeds_zcap(data):
    """The accepted schedule's occupancy respects zcap at every serving
    instant, through the port's occupancy_feasible scan."""
    ids, sizes, B = _draw_instance(data)
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    t, u, obj, save, size = build_interval_arrays(
        ids, np.ones_like(sizes), sizes)
    if len(t) == 0:
        return
    x = rng.random(len(t))
    T = len(ids)
    zcap = zcap_profile(ids, sizes, B)
    tol = _round_tol(B)
    _, accepted = _round_arrays(t, u, save, size, x, zcap, tol)
    if not accepted:
        return
    acc = np.asarray(accepted, np.int64)
    deltas = interval_deltas(t[acc], u[acc], size[acc], T)
    occ, excess = ops.occupancy_feasible(
        torch.tensor(deltas.astype(np.float32)),
        torch.tensor(zcap.astype(np.float32)))
    np.testing.assert_array_equal(occ.numpy(), np.cumsum(deltas))
    assert float(excess) <= tol
    assert (np.cumsum(deltas)[1:] <= zcap[1:] + tol).all()


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_rounding_lp_solution_bounded_by_lp(data):
    """Rounding the LP's own x never beats the LP bound."""
    ids, sizes, B = _draw_instance(data)
    _, lp_savings, x, paid = lp_opt(ids, np.ones_like(sizes), sizes, B)
    if not paid:
        return
    saved = round_fractional(ids, sizes, B, x, paid)
    assert saved <= lp_savings + 1e-9 * max(1.0, lp_savings)
