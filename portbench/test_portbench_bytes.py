"""The `sweep_counted` job kind and the four readers it feeds: both budget
units on the CPU at a size a test run holds (sound runs correct, the
bfloat16 control and a planted fault not), the byte budgets as shares of
each trace's catalog, the readers as pure functions on synthetic records,
and on a card (marked `cuda`) a short run of each new cell."""
import json

import numpy as np
import pytest

from portbench import frozen, run, spec
from portbench.devtrace import DeviceTrace, RunRecord

CELLS = ["cdn_bytes.panel96", "memcache.frontier192"]
KIND = spec.job_kind("sweep_counted")


def _tiny(name):
    cell = spec.load_cell(name)
    small = (dict(n_objects=900, n_requests=2000,
                  budgets=cell.traffic["budgets"])
             if name.startswith("cdn_bytes") else
             dict(n_objects=300, n_requests=2000,
                  budgets=[4, 8, 12, 16, 24, 32, 48, 64]))
    return spec.Cell(
        name=name + ".tiny", chips=1,
        config={**cell.config, "n_objects": small["n_objects"],
                "n_requests": small["n_requests"]},
        traffic={**cell.traffic, "budgets": small["budgets"],
                 "warmup_jobs": 1},
        end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def _run(cell, seed=2**31 + 11):
    return run.run_cell(cell, seed, 0.0, False, device="cpu", workers=1)


@pytest.mark.parametrize("name", CELLS)
def test_cells_run_the_new_kind(name):
    cell = spec.load_cell(name)
    assert cell.traffic["job"] == "sweep_counted" and cell.traffic["budgets"]
    unit = cell.traffic["budget_unit"]
    assert unit == ("catalog_share" if name.startswith("cdn_bytes")
                    else "pages")
    assert {m["name"] for m in cell.per_layer} >= {
        "replay_scan.evict_cycles_per_victim", "replay_scan.cell_balance"}
    assert ("replay_bytes.ms_per_grid" in {m["name"] for m in cell.per_layer}
            ) == (unit == "catalog_share")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(_tiny(name))
    assert r["correct"] and r["failed"] == 0
    assert list(r["checks"]) == ["hits_off", "dollars_off"]
    assert r["details"]["cells_compared"] == (96 if "96" in name else 192)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = _tiny(name)
    state = KIND.draw(cell.config, cell.traffic, 5)
    checks, details = KIND.control(state, 4)
    assert details["jobs_compared"] == 1
    assert any(v > lim for v, lim in checks.values())


def test_byte_budgets_are_shares_of_each_catalog():
    cell = _tiny("cdn_bytes.panel96")
    state = KIND.draw(cell.config, cell.traffic, 2**33 + 5)
    assert state.unit == "bytes" and len(state.pool) == 4
    shares = cell.traffic["budgets"]
    for k, (ids, sizes, costs) in enumerate(state.pool):
        assert (sizes == np.ceil(sizes)).all() and (sizes >= 1).all()
        np.testing.assert_array_equal(
            costs, np.stack([frozen.miss_costs(sizes, p)
                             for p in cell.traffic["prices"]]))
        catalog = int(sizes.sum())
        assert KIND.budget_of(state, k).tolist() == [int(s * catalog)
                                                     for s in shares]
    # the smallest budget fetches the largest objects through
    ids, sizes, _ = state.pool[0]
    assert sizes.max() > KIND.budget_of(state, 0)[0]
    pages = _tiny("memcache.frontier192")
    state = KIND.draw(pages.config, pages.traffic, 3)
    assert state.unit == "pages"
    assert KIND.budget_of(state, 1).tolist() == pages.traffic["budgets"]


def _byte_fault(real):
    def replay(weights, ids, nxt, costs, sizes, budgets, use_kernel,
               trace_steps=False):
        d, h, _ = real(weights, ids, nxt, costs, sizes.float(), budgets,
                       use_kernel)
        return d, h, None     # the page replay in the byte replay's place
    return replay


def test_fault_is_not_correct(monkeypatch):
    from repro_torch.core import policies_torch
    monkeypatch.setattr(policies_torch, "_replay",
                        _byte_fault(policies_torch._replay))
    r = _run(_tiny("cdn_bytes.panel96"))
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_a_program_without_byte_budgets_fails_in_setup(monkeypatch):
    """The parent's `sweep_torch` has no `budget_unit`: the byte cell's
    set-up raises at its first warm-up job, and the page cell runs."""
    from repro_torch.core import policies_torch
    real = policies_torch.sweep_torch

    def old(policy, ids, cost_matrix, budgets, num_objects=None, sizes=None,
            use_kernel=None, profile=None, device=None, return_hits=False):
        return real(policy, ids, cost_matrix, budgets, num_objects, sizes,
                    use_kernel, profile, device, return_hits)
    monkeypatch.setattr(policies_torch, "sweep_torch", old)
    with pytest.raises(TypeError):
        _run(_tiny("cdn_bytes.panel96"))
    assert _run(_tiny("memcache.frontier192"))["correct"]


def _judged(name, traced):
    """A tiny cell's set-up, one job (under a profiler when `traced`) and
    the judge: the state."""
    from torch.profiler import ProfilerActivity, profile
    cell = _tiny(name)
    state = KIND.setup(cell.config, cell.traffic, 7, device="cpu")
    assert not state.traced          # the warm-up is not watched
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            out = KIND.run(state, 0)
    else:
        out = KIND.run(state, 0)
    assert state.traced == traced
    KIND.judge(state, [(0, out)])
    return state


def test_cpu_run_counts_nothing():
    """On the CPU the program returns no counters: the readers read None."""
    state = _judged("memcache.frontier192", traced=True)
    assert state.facts["work"] == [None] * 4
    rec = RunRecord(jobs=[], window_s=1.0, setup_s=1.0, facts=state.facts)
    for name in ("replay_scan.evict_cycles_per_victim",
                 "replay_scan.cell_balance"):
        assert spec.metric_reader(name).read(rec) is None


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_takes_no_counters(name, monkeypatch):
    """Only a traced run reads the counters, so an untraced one makes no
    `profile=` call after its window."""
    calls = []
    monkeypatch.setattr(KIND, "counters", lambda state: calls.append(1))
    state = _judged(name, traced=False)
    assert calls == [] and "work" not in state.facts
    rec = RunRecord(jobs=[], window_s=1.0, setup_s=1.0, facts=state.facts)
    for m in ("replay_scan.evict_cycles_per_victim",
              "replay_scan.cell_balance"):
        assert spec.metric_reader(m).read(rec) is None


PAGE_COLS = ("scored_steps", "slots_scored", "peak_slots", "cycles",
             "evict_cycles")
BYTE_COLS = PAGE_COLS + ("victims", "fetch_through")


def _work(rows, cols):
    """(2, 1, 2, len(cols)) int64 counters from four cells' rows."""
    return np.array(rows, np.int64).reshape(2, 1, 2, len(cols))


def _read(name, facts, trace=None):
    rec = RunRecord(jobs=[], window_s=2.0, setup_s=1.0, facts=facts,
                    trace=trace)
    return spec.metric_reader(name).read(rec)


def test_counter_readers():
    # page columns: the slowest cell (cycles 400) spent 300 on 100 steps
    pages = _work([[10, 0, 0, 100, 50], [100, 0, 0, 400, 300],
                   [0, 0, 0, 200, 0], [20, 0, 0, 300, 10]], PAGE_COLS)
    # byte columns: the slowest (cycles 900) spent 600 on 40 victims,
    # whatever its scored steps
    byte = _work([[50, 0, 0, 900, 600, 40, 3], [1, 0, 0, 300, 0, 1, 0],
                  [0, 0, 0, 300, 0, 0, 9], [5, 0, 0, 300, 5, 5, 0]],
                 BYTE_COLS)
    facts = dict(work=[pages, pages], work_columns=PAGE_COLS)
    assert _read("replay_scan.evict_cycles_per_victim", facts) == \
        pytest.approx(3.0)
    assert _read("replay_scan.cell_balance", facts) == \
        pytest.approx(100 * 250 / 400)
    facts = dict(work=[byte], work_columns=BYTE_COLS)
    assert _read("replay_scan.evict_cycles_per_victim", facts) == \
        pytest.approx(15.0)
    assert _read("replay_scan.cell_balance", facts) == \
        pytest.approx(100 * 450 / 900)
    # a slowest cell with no victim reads nothing
    idle = _work([[0, 0, 0, 900, 0, 0, 0]] * 4, BYTE_COLS)
    assert _read("replay_scan.evict_cycles_per_victim",
                 dict(work=[idle], work_columns=BYTE_COLS)) is None
    for facts in ({}, dict(work=[None, None], work_columns=PAGE_COLS),
                  dict(work=[], work_columns=PAGE_COLS)):
        assert _read("replay_scan.evict_cycles_per_victim", facts) is None
        assert _read("replay_scan.cell_balance", facts) is None


FACTS = dict(T=1000, N=100, Q=6, P=4, K=4, cells=96)


def test_byte_kernel_readers():
    trace = DeviceTrace(
        window=(0.0, 2.0),
        device=[("void (anonymous namespace)::replay_bytes_kernel<false>("
                 "(anonymous namespace)::Params)", 0.1, 0.5),
                ("replay_bytes_kernel<true>(Params)", 1.2, 1.4),
                ("replay_scan_kernel<true>(Params)", 1.5, 1.9)],
        spans=[("portbench.job", 0.0, 1.0), ("portbench.job", 1.0, 2.0)])
    assert _read("replay_bytes.ms_per_grid", FACTS, trace) == \
        pytest.approx(300.0)
    rb = spec.metric_reader("replay_bytes.roofline")
    moved = 12 * 1000 + 4 * 4 * 100 + 4 * 100 + 24 * 6 + 8 * 4 + 8 * 96
    assert rb.bound_seconds(FACTS) == max(moved / 3.35e12,
                                          4 * 96 * 1000 / 67e12)
    assert _read("replay_bytes.roofline", FACTS, trace) == pytest.approx(
        100 * rb.bound_seconds(FACTS) / 0.3)
    # no trace, or a trace without the kernel: nothing to read
    page_only = DeviceTrace(window=trace.window, device=trace.device[2:],
                            spans=trace.spans)
    for tr in (None, page_only):
        assert _read("replay_bytes.ms_per_grid", FACTS, tr) is None
        assert _read("replay_bytes.roofline", FACTS, tr) is None
    # the page kernel's readers do not count the byte kernel
    assert _read("replay_scan.ms_per_grid", FACTS, trace) == \
        pytest.approx(200.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_short_run_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")
    cell = spec.load_cell(name)
    r = run.run_cell(cell, 2**31 + 101, 2.0, trace)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
    json.dumps(r)
