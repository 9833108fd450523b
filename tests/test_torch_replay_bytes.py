"""The byte replay (`sweep_torch(..., budget_unit="bytes")`) on the CPU: its
plain step loop against the plain reference `replay_bytes_ref` bit for bit,
against the host policies of both packages, against the page replay where
every size is 1, and the judge's copy (`portbench/reference_bytes.py`)
against the plain reference. The kernel itself is held to the step loop on
the card in `tests/test_torch_cuda.py`."""
import numpy as np
import pytest

from portbench import reference_bytes
from repro.core import Trace as RefTrace
from repro.core import simulate as ref_simulate
from repro_torch.core import Trace, replay_bytes_ref, simulate
from repro_torch.core import policies_torch as pt
from repro_torch.kernels.replay_scan import (BYTE_SLOT_WORDS, BYTE_WORK_COLUMNS,
                                             STAGE_BYTES, WORK_COLUMNS, plan)

import _replay_cases as cases

POLICIES = cases.POLICIES


def _sweep(c, weights=None, **kw):
    return pt.sweep_torch(c["weights"] if weights is None else weights,
                          c["ids"], c["costs"], c["budgets"],
                          num_objects=c["costs"].shape[1], sizes=c["sizes"],
                          device="cpu", return_hits=True, budget_unit="bytes",
                          **kw)


def _bits(d):
    return np.asarray(d, np.float32).view(np.int32)


@pytest.mark.parametrize("name", cases.BYTE_CASES)
def test_step_loop_matches_plain_reference(name):
    """Every weight row (the six policies, a mixed row and a reversed
    Belady, whose never-again objects score 3.4e38 and so are never
    evicted) on grids with fetch-through, misses that evict several
    victims, GreedyDual's L carried across them, and ties."""
    c = cases.make_bytes(name)
    d, h = _sweep(c)
    rd, rh, victims, fetched, multi = replay_bytes_ref.replay_grid(
        c["ids"], c["costs"], c["sizes"], c["weights"], c["budgets"])
    np.testing.assert_array_equal(_bits(d), _bits(rd.numpy()))
    np.testing.assert_array_equal(h, rh.numpy())
    if name == "pareto":
        assert (fetched[..., 0] == len(c["ids"])).all()   # budget 0
        assert (fetched[..., 1] > 0).all()   # objects past half the largest
    if name == "multi_victim":
        gd = [POLICIES.index("gds"), POLICIES.index("gdsf")]
        assert (multi[gd] > 0).all() and (multi[:6] > 0).all()
    if name != "unit":
        # the reversed Belady row finds nothing to evict and fetches through
        assert (fetched[-1, :, 1:] > 0).any()


@pytest.mark.parametrize("policy", POLICIES)
def test_hits_match_both_host_references(policy):
    """Whole-byte sizes and list-price costs: hits equal to the host copy's
    and the reference package's `simulate` (float64 scores), dollars within
    rel 1e-5."""
    rng = np.random.default_rng(300 + POLICIES.index(policy))
    T, N = 600, 60
    ids = rng.integers(0, N, T).astype(np.int32)
    sizes = np.ceil(np.clip((rng.pareto(1.0, N) + 1.0) * 500.0, 64.0, 2e6))
    costs = 0.4e-6 + sizes * 0.09e-9
    budgets = np.array([int(sizes.max() // 3), int(sizes.sum() // 50),
                        int(sizes.sum() // 10), int(sizes.sum() // 3)])
    d, h = pt.sweep_torch(policy, ids, costs[None], budgets, num_objects=N,
                          sizes=sizes, device="cpu", return_hits=True,
                          budget_unit="bytes")
    for k, b in enumerate(budgets):
        mine = simulate(policy, Trace(ids=ids, sizes=sizes), costs, float(b))
        theirs = ref_simulate(policy, RefTrace(ids=ids, sizes=sizes), costs,
                              float(b))
        assert h[0, k] == mine.hits == theirs.hits
        assert d[0, k] == pytest.approx(mine.dollars, rel=1e-5)
        assert mine.dollars == theirs.dollars


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unit_sizes_are_the_page_replay(seed):
    """Every size 1 and B bytes: the page replay of B pages, bit for bit
    (the six policies and the mixed row)."""
    c = cases.make_bytes("unit", seed)
    w = c["weights"][:7]
    d, h = _sweep(c, weights=w)
    pd, ph = pt.sweep_torch(w, c["ids"], c["costs"],
                            c["budgets"].astype(np.int32),
                            num_objects=c["costs"].shape[1], sizes=c["sizes"],
                            device="cpu", return_hits=True)
    np.testing.assert_array_equal(_bits(d), _bits(pd))
    np.testing.assert_array_equal(h, ph)


@pytest.mark.parametrize("name", cases.BYTE_CASES)
def test_judge_reference_matches_plain_reference(name):
    """portbench's numpy copy, in float32, on the six policies."""
    c = cases.make_bytes(name)
    w = c["weights"][:6]
    d, h = reference_bytes.replay_grid(c["ids"], c["costs"], c["sizes"], w,
                                       c["budgets"])
    rd, rh, *_ = replay_bytes_ref.replay_grid(c["ids"], c["costs"],
                                              c["sizes"], w, c["budgets"])
    np.testing.assert_array_equal(_bits(d), _bits(rd.numpy()))
    np.testing.assert_array_equal(h, rh.numpy())


def test_judge_reference_in_processes_and_bf16():
    c = cases.make_bytes("pareto")
    w = c["weights"][:6]
    one = reference_bytes.replay_grid(c["ids"], c["costs"], c["sizes"], w,
                                      c["budgets"])
    two = reference_bytes.replay_grid(c["ids"], c["costs"], c["sizes"], w,
                                      c["budgets"], workers=3)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    low_d, _ = reference_bytes.replay_grid(c["ids"], c["costs"], c["sizes"],
                                           w, c["budgets"], precision="bf16")
    assert (_bits(low_d) != _bits(one[0])).any()


def test_entry_checks_its_byte_inputs():
    c = cases.make_bytes("ties")
    with pytest.raises(ValueError):      # no such unit
        pt.sweep_torch("lru", c["ids"], c["costs"], c["budgets"],
                       sizes=c["sizes"], device="cpu",
                       budget_unit="kilobytes")
    with pytest.raises(ValueError):      # no sizes
        pt.sweep_torch("lru", c["ids"], c["costs"], c["budgets"],
                       device="cpu", budget_unit="bytes")
    for bad in (c["sizes"] + 0.5, -c["sizes"], c["sizes"] * 2.0**31):
        with pytest.raises(ValueError):  # sizes not whole bytes below 2^31
            pt.sweep_torch("lru", c["ids"], c["costs"], c["budgets"],
                           sizes=bad, device="cpu", budget_unit="bytes")
    for bad in ([-1], [2.5]):
        with pytest.raises(ValueError):  # budgets not whole and >= 0
            pt.sweep_torch("lru", c["ids"], c["costs"], np.array(bad),
                           sizes=c["sizes"], device="cpu",
                           budget_unit="bytes")
    # budgets past 2^31 bytes are whole int64s: everything fits
    d, h = pt.sweep_torch("lru", c["ids"], c["costs"], np.array([2**40]),
                          sizes=c["sizes"], device="cpu", return_hits=True,
                          budget_unit="bytes")
    assert h[0, 0] == len(c["ids"]) - len(np.unique(c["ids"]))


def test_profile_and_spans_on_the_cpu():
    """The CPU's byte replay returns the page replay's profile keys (no
    counters) and opens the same five spans."""
    from torch.profiler import ProfilerActivity, profile
    c = cases.make_bytes("ties")
    prof = {}
    with profile(activities=[ProfilerActivity.CPU]) as tr:
        _sweep(c, profile=prof)
    assert set(prof) == {"compile_s", "execute_s", "cells"}
    assert prof["cells"] == c["weights"].shape[0] * 2 * 3
    names = sorted((e.time_range.start, e.name) for e in tr.events()
                   if e.name.startswith("repro_torch."))
    assert [n for _, n in names] == [
        "repro_torch.sweep", "repro_torch.sweep.prepare",
        "repro_torch.sweep.next_use", "repro_torch.sweep.replay",
        "repro_torch.sweep.copy_back"]


def test_byte_layout():
    assert BYTE_WORK_COLUMNS[:5] == WORK_COLUMNS
    assert BYTE_WORK_COLUMNS[5:] == ("victims", "fetch_through")
    limit = 232_448 - 272
    # few objects fit shared memory whole; many get regions of N slots
    # (rounded up to even), eight words a slot, as the page layout's seven
    small = plan(96, 100, limit, by_bytes=True)
    assert small["slots_shared"] == 100 and small["slot_words"] == 0
    big = plan(96, 60_001, limit, by_bytes=True)
    assert not big["map_shared"]
    assert big["slots_shared"] == (limit - STAGE_BYTES) // (4 *
                                                             BYTE_SLOT_WORDS)
    assert big["slot_words"] == 96 * BYTE_SLOT_WORDS * 60_002
    assert big["shared_bytes"] == STAGE_BYTES + 4 * BYTE_SLOT_WORDS * \
        big["slots_shared"]
    pages = plan(96, 60_001, limit)
    assert pages["slots_shared"] > big["slots_shared"]
    assert pages["slot_words"] == 96 * 7 * 60_002
