"""The metric arithmetic on synthetic records: rate, p90, idle share,
exposed host time, the kernels' shares and the breakdown."""
import json

import pytest

from portbench import devtrace, spec
from portbench.devtrace import DeviceTrace, Job, RunRecord

FACTS = dict(T=1000, N=100, Q=6, P=4, K=4, cells=96,
             replay_bytes=3 * 4000 + 1600 + 400 + 144 + 16 + 768,
             next_use_bytes=8000)


def read(name, run):
    return spec.metric_reader(name).read(run)


def _trace():
    # two jobs of 1 s each; device busy 0.1-0.4 and 0.3-0.5 (overlapping)
    # in the first, 1.2-1.9 in the second; a user annotation covering all
    device = [("void (anonymous namespace)::replay_scan_kernel<true>("
               "(anonymous namespace)::Params)", 0.1, 0.4),
              ("first_pass<512, 4>(int const*)", 0.3, 0.5),
              ("replay_scan_kernel<false>(Params)", 1.2, 1.9),
              ("Memcpy DtoH (Device -> Pageable)", 1.95, 1.96)]
    spans = [("portbench.job", 0.0, 1.0), ("portbench.job", 1.0, 2.0),
             ("portbench.frequency_rank", 0.6, 0.9)]
    return DeviceTrace(window=(0.0, 2.0), device=device, spans=spans)


def test_rate_and_p90():
    jobs = [Job(i, i + s, 96e6) for i, s in
            enumerate([0.1 * k for k in range(1, 11)])]
    run = RunRecord(jobs=jobs, window_s=12.0, setup_s=3.5, facts=FACTS)
    assert read("replay_rate", run) == pytest.approx(10 * 96 / 12.0)
    # inclusive quantiles of 0.1..1.0: 0.91
    assert read("grid_p90_s", run) == pytest.approx(0.91)
    assert read("setup_s", run) == 3.5
    for name in ("device.idle_share", "sweep_host.exposed_ms",
                 "next_use.roofline", "replay_scan.roofline"):
        assert read(name, run) is None        # untraced: nothing to read
    empty = RunRecord(jobs=[], window_s=0.0, setup_s=1.0, facts=FACTS)
    assert read("replay_rate", empty) is None
    assert read("grid_p90_s", empty) is None


def test_trace_metrics():
    run = RunRecord(jobs=[], window_s=2.0, setup_s=1.0, facts=FACTS,
                    trace=_trace())
    # busy: 0.1-0.5, 1.2-1.9, 1.95-1.96 = 1.11 s of 2
    assert read("device.idle_share", run) == pytest.approx(44.5)
    # exposed: job 1 1.0 - 0.4, job 2 1.0 - 0.71; mean 0.445 s
    assert read("sweep_host.exposed_ms", run) == pytest.approx(445.0)
    assert read("replay_scan.ms_per_grid", run) == pytest.approx(500.0)
    nu = spec.metric_reader("next_use.roofline")
    assert read("next_use.roofline", run) == pytest.approx(
        100 * nu.bound_seconds(FACTS) / 0.1)
    rs = spec.metric_reader("replay_scan.roofline")
    assert read("replay_scan.roofline", run) == pytest.approx(
        100 * rs.bound_seconds(FACTS) / 0.5)


def test_replay_scan_count_ignores_work_counters():
    rs = spec.metric_reader("replay_scan.roofline")
    base = rs.bound_seconds(FACTS)
    # the kernel's work counters (slots scored, cycles) are not inputs
    busy = dict(FACTS, scored_steps=10**9, slots_scored=10**12,
                peak_slots=10**5, cycles=10**10, evict_cycles=10**9)
    assert rs.bound_seconds(busy) == base
    assert base == max(FACTS["replay_bytes"] / 3.35e12,
                       4 * 96 * 1000 / 67e12)
    # it grows with cells and requests only
    assert rs.bound_seconds(dict(FACTS, N=10**6)) == base


def test_breakdown_and_names():
    b = devtrace.breakdown(_trace())
    assert b["device_ops"][0] == ["replay_scan_kernel<false>",
                                  pytest.approx(0.7)]
    gaps = dict(b["idle_gaps"])
    # a gap goes whole to the innermost span open at its middle
    assert gaps["portbench.frequency_rank"] == pytest.approx(0.7)
    assert gaps["portbench.job (outside the named calls)"] == \
        pytest.approx(0.1 + 0.05 + 0.04)
    json.dumps(b)
    assert devtrace.kernel_base("void (anonymous namespace)::radix_pass"
                                "<512, 4, 0>(int const*)") == "radix_pass"
    assert devtrace.union([(0, 1), (0.5, 2), (3, 4), (4, 4)]) == \
        [(0, 2), (3, 4)]
