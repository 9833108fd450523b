"""The launch columns' reader and the `cdn.frontier192` cell: the
`replay_scan.span_over_slowest` arithmetic on synthetic `work` arrays, the
cell's tiny run on the CPU (sound runs correct, the bfloat16 control not,
no counters read), and on a card (marked `cuda`) a short run of it."""
import json

import numpy as np
import pytest

from portbench import run, spec
from portbench.devtrace import RunRecord
from portbench.test_portbench_bytes import KIND, _judged, _run, _tiny

CELL = "cdn.frontier192"
SPAN = "replay_scan.span_over_slowest"


def _read(name, facts):
    rec = RunRecord(jobs=[], window_s=2.0, setup_s=1.0, facts=facts)
    return spec.metric_reader(name).read(rec)


# a card's %globaltimer reading, in ns: past the integers a float holds
T0 = 1_760_000_000_123_456_789
LAUNCH_COLS = ("cycles", "block", "start_ns", "end_ns")


def _launch(spans):
    """(2, 1, 2, 4) work of four cells from their (start, end) in ns after
    T0, in LAUNCH_COLS order."""
    rows = [[e - s, b, T0 + s, T0 + e] for b, (s, e) in enumerate(spans)]
    return np.array(rows, np.int64).reshape(2, 1, 2, len(LAUNCH_COLS))


# one wave: every cell starts at once, the longest sets the span
ONE_WAVE = _launch([(0, 100), (0, 80), (1, 61), (0, 100)])
# two back-to-back waves: cells 2 and 3 wait for cells 1 and 0 to end
TWO_WAVES = _launch([(0, 100), (0, 60), (60, 150), (100, 130)])


@pytest.mark.parametrize("works, columns, want", [
    ([ONE_WAVE], LAUNCH_COLS, 1.0),
    # 150 / 100, and over two pool traces the mean of 1.0 and 1.5
    ([TWO_WAVES], LAUNCH_COLS, 1.5),
    ([ONE_WAVE, None, TWO_WAVES], LAUNCH_COLS, 1.25),
    # a kernel without the launch columns; no counted call; no columns
    ([ONE_WAVE[..., :2]], LAUNCH_COLS[:2], None),
    ([None, None], LAUNCH_COLS, None),
    ([ONE_WAVE], None, None),
], ids=["one_wave", "two_waves", "mean_over_traces", "no_launch_columns",
        "no_counted_call", "no_columns"])
def test_span_over_slowest(works, columns, want):
    got = _read(SPAN, dict(work=works, work_columns=columns))
    assert got == (want if want is None else pytest.approx(want, abs=1e-12))


def test_cell_runs_the_counted_kind():
    cell = spec.load_cell(CELL)
    assert cell.traffic["job"] == "sweep_counted"
    assert cell.traffic["budget_unit"] == "pages"
    names = {m["name"] for m in cell.per_layer}
    assert SPAN in names and "replay_bytes.ms_per_grid" not in names


def test_sound_run_is_correct():
    r = _run(_tiny(CELL))
    assert r["correct"] and r["failed"] == 0
    assert list(r["checks"]) == ["hits_off", "dollars_off"]
    assert r["details"]["cells_compared"] == 192


def test_control_fails():
    cell = _tiny(CELL)
    state = KIND.draw(cell.config, cell.traffic, 5)
    checks, details = KIND.control(state, 4)
    assert details["jobs_compared"] == 1
    assert any(v > lim for v, lim in checks.values())


@pytest.mark.parametrize("traced", [False, True])
def test_cpu_run_reads_no_launch(traced):
    """On the CPU the program returns no counters, and an untraced run asks
    for none: the reader reads None."""
    state = _judged(CELL, traced)
    assert state.facts.get("work") == ([None] * 4 if traced else None)
    rec = RunRecord(jobs=[], window_s=1.0, setup_s=1.0, facts=state.facts)
    assert spec.metric_reader(SPAN).read(rec) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_short_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")
    cell = spec.load_cell(CELL)
    r = run.run_cell(cell, 2**31 + 101, 2.0, trace)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
    json.dumps(r)
