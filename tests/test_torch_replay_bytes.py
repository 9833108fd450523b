"""The byte replay (`sweep_torch(..., budget_unit="bytes")`) on the CPU: its
plain step loop against the plain reference `replay_bytes_ref` bit for bit,
against the host policies of both packages, against the page replay where
every size is 1, and the judge's copy (`portbench/reference_bytes.py`)
against the plain reference. The kernel itself is held to the step loop on
the card in `tests/test_torch_cuda.py`."""
import numpy as np
import pytest
import torch
from hypothesis import assume, example, given, settings
from hypothesis import strategies as st

from portbench import reference_bytes
from repro.core import Trace as RefTrace
from repro.core import simulate as ref_simulate
from repro_torch.core import Trace, replay_bytes_ref, simulate
from repro_torch.core import policies_torch as pt
from repro_torch.core.trace import next_use_indices
from repro_torch.kernels import ref
from repro_torch.kernels.replay_scan import (BOUND_GROUP, BYTE_SLOT_WORDS,
                                             BYTE_WORK_COLUMNS, STAGE_BYTES,
                                             WORK_COLUMNS, plan)

import _replay_cases as cases

POLICIES = cases.POLICIES
f32 = np.float32
BIG = f32(3.4e38)
NO_KEY = np.uint64(2**64 - 1)


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
    """Every weight row (the six policies, a mixed row, a reversed Belady,
    whose never-again objects score 3.4e38 and so are never evicted, and a
    reversed cost-Belady) on grids with fetch-through, misses that evict
    several victims, GreedyDual's L carried across them, ties, and
    cost-Belady terms that overflow at the touch."""
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
    if name not in ("unit", "zero_cost"):
        # the reversed Belady row finds nothing to evict and fetches through
        assert (fetched[7, :, 1:] > 0).any()
    if name == "zero_cost":
        # at the free objects' touches the term overflows, or is finite
        terms = _touch_terms(c, price=1)[c["costs"][1][c["ids"]] == 0]
        assert (~np.isfinite(terms)).any() and np.isfinite(terms).any()


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
    """portbench's numpy copy, in float32, on the six policies (those the
    case has)."""
    c = cases.make_bytes(name)
    six = cases.weights()[:6]
    w = c["weights"][(c["weights"][:, None] == six[None]).all(-1).any(-1)]
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
    # the page counters, the byte replay's three, then both kernels' launch
    launch = ("block", "start_ns", "end_ns")
    assert BYTE_WORK_COLUMNS[:5] == WORK_COLUMNS[:5]
    assert BYTE_WORK_COLUMNS[5:8] == ("victims", "fetch_through",
                                      "rescanned_slots")
    assert BYTE_WORK_COLUMNS[8:] == WORK_COLUMNS[5:] == launch
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
    # one 8-byte bound a group of BOUND_GROUP slots of N, for every cell
    assert big["bound_words"] == 96 * 2 * -(-60_001 // BOUND_GROUP)
    assert small["bound_words"] == 96 * 2 * 4
    assert plan(1, 1, limit, by_bytes=True)["bound_words"] == 2
    # the page layout is as it was: no bounds
    pages = plan(96, 60_001, limit)
    assert set(pages) == {"map_shared", "slots_shared", "shared_bytes",
                          "map_words", "slot_words"}
    assert not pages["map_shared"]
    assert pages["slots_shared"] == (limit - STAGE_BYTES) // (4 * 7)
    assert pages["shared_bytes"] == STAGE_BYTES + 28 * pages["slots_shared"]
    assert pages["map_words"] == 96 * 60_001
    assert pages["slots_shared"] > big["slots_shared"]
    assert pages["slot_words"] == 96 * 7 * 60_002


# The byte kernel's cost-Belady bounds (csrc/replay_scan.cu, bounded_min),
# modelled in numpy float32 in the kernel's order of operations.


def _order_image(x):
    """argmin_rule.cuh's order_image: uint32 words in the floats' order,
    -0.0 folded onto 0.0, NaN to 0, below every other."""
    x = np.atleast_1d(np.asarray(x, f32))
    b = (x + f32(0)).view(np.uint32)
    img = np.where(b >> np.uint32(31) == 1, ~b, b | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0), img).astype(np.uint32)


def _cb(nu, size, negcf, tf, T):
    """cost-Belady's term at step tf (csrc/replay_scan.cu, cost_belady)."""
    gap = np.maximum(np.asarray(nu).astype(f32) - np.asarray(tf, f32), f32(1))
    with np.errstate(all="ignore"):
        return np.where(np.asarray(nu) >= T, -BIG, (size * gap) / negcf)


def _key(sb, nu, size, negcf, tf, T, w_cb, touch):
    """A slot's 64-bit key at step tf: the order image of its score, then
    its touch."""
    with np.errstate(all="ignore"):
        score = np.asarray(sb, f32) + f32(w_cb) * _cb(nu, size, negcf, tf, T)
    return (_order_image(score).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(touch).astype(np.uint64)


def _touch_terms(c, price, w_cb=f32(1)):
    """w_cb * cb of each request of a case at its own step."""
    ids = c["ids"]
    T = len(ids)
    size = c["sizes"].astype(f32)[ids]
    negcf = -np.maximum(c["costs"][price].astype(f32), f32(1e-30))[ids]
    with np.errstate(all="ignore"):
        return w_cb * _cb(next_use_indices(ids), size, negcf,
                          np.arange(T).astype(f32), T)


def _bounded_cell(c, w, p, budget):
    """One cell of a row with w_cb > 0 as the byte kernel replays it: a
    dense table (the last slot fills a victim's place), a bound for every
    BOUND_GROUP slots, 0 at the start and lowered by each touch, append and
    move, the evicting step's search of the least bound below the best
    exact key, and the full scan that rewrites every bound while a cached
    slot's term was not finite at its touch. Every group's bound is checked
    at or below its slots' keys, and the search's key equal to the full
    scan's, at each evicting step. Returns dollars, hits, victims,
    fetch-throughs, and the slots considered and scored on the evicting
    steps."""
    ids, T = c["ids"], len(c["ids"])
    nxt = next_use_indices(ids)
    rank = ref.frequency_rank_ref(torch.tensor(ids)).numpy()
    cost = c["costs"][p].astype(f32)
    whole = c["sizes"].astype(np.int64)
    size = whole.astype(f32)
    cos = cost / np.maximum(size, f32(1e-30))
    negcf = -np.maximum(cost, f32(1e-30))
    w = np.asarray(w, f32)
    gd = (w[2] + w[3]) > 0
    N = len(cost)
    bounds = np.zeros(-(-N // BOUND_GROUP), np.uint64)
    slot_of = np.full(N, -1)
    obj, nu, touch = (np.zeros(N, np.int64) for _ in range(3))
    sb, flag = np.zeros(N, f32), np.zeros(N, bool)
    st = dict(used=0, held=0, bad=0, infl=f32(0))
    dollars, hits, victims, fetched, scored, rescanned = f32(0), 0, 0, 0, 0, 0

    def keys(s, tf):
        o = obj[s]
        return _key(sb[s], nu[s], size[o], negcf[o], tf, T, w[5], touch[s])

    def score(v, tf):
        o = obj[v]
        with np.errstate(all="ignore"):
            return sb[v] + w[5] * _cb(nu[v], size[o], negcf[o], tf, T)[()]

    def lower(s, tf):
        g = s // BOUND_GROUP
        bounds[g] = min(bounds[g], keys(np.array([s]), tf)[0])

    def place(s, t):
        i, tf, fi = ids[t], f32(t), f32(rank[t])
        L = st["infl"] if gd else f32(0)
        bel = -BIG if nxt[t] >= T else -f32(nxt[t])
        with np.errstate(all="ignore"):
            sb[s] = (((w[0] * tf + w[1] * fi) + w[2] * (L + cos[i]))
                     + w[3] * (L + fi * cos[i])) + w[4] * bel
            bad = not np.isfinite(w[5] * _cb(nxt[t], size[i], negcf[i], tf,
                                             T))
        st["bad"] += int(bad) - int(flag[s])
        obj[s], nu[s], touch[s], flag[s] = i, nxt[t], t, bad

    for t in range(T):
        i, tf = ids[t], f32(t)
        if slot_of[i] >= 0:
            hits += 1
            place(slot_of[i], t)
            lower(slot_of[i], tf)
            continue
        dollars = f32(dollars + cost[i])
        admit = whole[i] <= budget
        while admit and st["held"] + whole[i] > budget:
            u = st["used"]
            scored += u
            full = keys(np.arange(u), tf)
            groups = -(-u // BOUND_GROUP)
            for g in range(groups):
                assert bounds[g] <= full[g * BOUND_GROUP:][:BOUND_GROUP].min()
            if st["bad"] == 0:
                best, v = NO_KEY, -1
                while groups and bounds[:groups].min() < best:
                    g = int(np.argmin(bounds[:groups]))
                    s = np.arange(g * BOUND_GROUP, min(u, (g + 1) *
                                                       BOUND_GROUP))
                    k = keys(s, tf)
                    bounds[g] = k.min()
                    rescanned += len(s)
                    if k.min() < best:
                        best, v = k.min(), int(s[np.argmin(k)])
                assert best == full.min()
            else:
                rescanned += u
                for g in range(groups):
                    bounds[g] = full[g * BOUND_GROUP:][:BOUND_GROUP].min()
                best, v = full.min(), int(np.argmin(full))
            if best >> np.uint64(32) == 0:    # a NaN: the plain victim 0
                v = slot_of[0]
                vscore = score(v, tf) if v >= 0 else BIG
                evict = vscore < BIG
            elif gd:
                vscore = score(v, tf)
                evict = vscore < BIG
            else:
                evict = best >> np.uint64(32) < _order_image(BIG)[0]
            if not evict:
                admit = False
                break
            if gd:
                st["infl"] = vscore
            last = u - 1                        # drop_slot
            st["bad"] -= int(flag[v])
            st["held"] -= whole[obj[v]]
            slot_of[obj[v]] = -1
            if v != last:
                for a in (obj, nu, touch, sb, flag):
                    a[v] = a[last]
                slot_of[obj[v]] = v
                lower(v, tf)
            st["used"] = last
            victims += 1
        if not admit:
            fetched += 1
            continue
        s = st["used"]
        st["used"] += 1
        st["held"] += whole[i]
        slot_of[i] = s
        flag[s] = False
        place(s, t)
        lower(s, tf)
    return dollars, hits, victims, fetched, scored, rescanned


@pytest.mark.parametrize("name", cases.BYTE_CASES)
def test_group_bounds_find_the_full_scans_victim(name):
    """The byte kernel's bounded cost-Belady search, modelled, against the
    plain reference in every row with w_cb > 0 (cost-Belady, and the mixed
    row, whose never-again objects' term 2 * -3.4e38 overflows, so it also
    falls back to the full scan): dollars' bits, hits, victims and
    fetch-throughs equal, and fewer slots scored where tables span
    several groups."""
    c = cases.make_bytes(name)
    rows = np.flatnonzero(c["weights"][:, 5] > 0)
    rd, rh, rv, rf, _ = replay_bytes_ref.replay_grid(
        c["ids"], c["costs"], c["sizes"], c["weights"][rows], c["budgets"])
    scored = rescanned = 0
    for a, q in enumerate(rows):
        for p in range(len(c["costs"])):
            for k, b in enumerate(c["budgets"]):
                d, h, v, f, n, m = _bounded_cell(c, c["weights"][q], p, int(b))
                assert _bits(d) == _bits(rd[a, p, k].item())
                assert (h, v, f) == (rh[a, p, k], rv[a, p, k], rf[a, p, k])
                assert m <= n
                scored, rescanned = scored + n, rescanned + m
    if name not in ("ties", "unit"):   # their evicting tables: one group
        assert rescanned < scored


@settings(max_examples=400, deadline=None)
@given(size=st.integers(0, 2**31 - 1),
       cost=st.floats(0.0, 3.3999999521443642e38, width=32)
       | st.floats(0.0, 1.1754942106924411e-38, width=32),
       w_cb=st.floats(1.401298464324817e-45, 3.3999999521443642e38,
                      width=32),
       sb=st.floats(width=32),
       touch=st.integers(0, 2**30), span=st.integers(1, 3000),
       never=st.booleans())
@example(size=0, cost=1.0, w_cb=1.0, sb=-0.0, touch=0, span=5, never=False)
@example(size=1, cost=3.4e38, w_cb=1e-38, sb=0.0, touch=7, span=900,
         never=False)
@example(size=2**31 - 1, cost=1e-45, w_cb=1.0, sb=0.0, touch=0, span=1,
         never=False)
def test_bounded_key_never_falls_before_next_use(size, cost, w_cb, sb, touch,
                                                 span, never):
    """What the byte kernel's bounds rest on: under w_cb > 0, a cached
    slot's key (the order image of sb + w_cb * cb(t), then its touch), in
    float32 in the kernel's order, never falls from its touch to its next
    use, whenever w_cb * cb was finite at the touch. Sizes are whole bytes;
    costs include zero and subnormals (floored at 1e-30), scores -0.0 and
    subnormal results; next uses past the trace's end keep -3.4e38."""
    nu = touch + span
    T = nu if never else nu + 1
    size_f = f32(size)
    negcf = -np.maximum(f32(cost), f32(1e-30))
    with np.errstate(all="ignore"):
        at_touch = f32(w_cb) * _cb(nu, size_f, negcf, f32(touch), T)[()]
    assume(np.isfinite(at_touch))
    steps = np.arange(touch, nu)
    k = _key(sb, nu, size_f, negcf, steps.astype(f32), T, w_cb, touch)
    assert (k[1:] >= k[:-1]).all()
