"""The comparison that decides `correct` fails its control and each fault
this cell can have, at a size a test run holds; and passes a sound run.

The faults are planted in the program's own replay (on the CPU its plain
step loop, `policies_torch._replay`) and the rest of a run is driven by
`run.run_cell`, without the look for a card. The fault of an exchange
between chips left out does not apply: every cell runs on one chip.
"""
import pytest
import torch

from portbench import spec
from portbench.run import run_cell


def _tiny(name="memcache.panel96"):
    cell = spec.load_cell(name)
    small = (dict(n_objects=300, n_requests=2000, budgets=[8, 16, 40, 100])
             if name.startswith("memcache") else
             dict(n_objects=900, n_requests=2000, budgets=[10, 20, 60, 150]))
    return spec.Cell(
        name=name + ".tiny", chips=1,
        config={**cell.config, "n_objects": small["n_objects"],
                "n_requests": small["n_requests"]},
        traffic={**cell.traffic, "budgets": small["budgets"],
                 "warmup_jobs": 1},
        end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def _run(cell, seed=2**31 + 7):
    # a window of 0 s runs one job; the judge compares it (trace 0)
    return run_cell(cell, seed, 0.0, False, device="cpu", workers=1)


@pytest.mark.parametrize("name", ["memcache.panel96", "cdn.panel96"])
def test_control_fails(name):
    cell = _tiny(name)
    kind = spec.job_kind(cell.traffic["job"])
    state = kind.draw(cell.config, cell.traffic, 5)
    checks, details = kind.control(state, 4)
    assert details["jobs_compared"] == 1
    assert any(v > lim for v, lim in checks.values())


def test_sound_run_is_correct():
    r = _run(_tiny())
    assert r["correct"] and r["failed"] == 0
    assert list(r["checks"]) == ["hits_off", "dollars_off"]
    assert r["details"]["cells_compared"] == 96


def _unchanged(real):
    def replay(weights, ids, nxt, costs, sizes, budgets, use_kernel,
               trace_steps=False):
        d, h, _ = real(weights, ids[:0], nxt[:0], costs, sizes, budgets,
                       use_kernel)
        return d, h, None     # the replay's state as it started
    return replay


def _half_batch(real):
    def replay(weights, ids, nxt, costs, sizes, budgets, use_kernel,
               trace_steps=False):
        half = weights.shape[0] // 2
        d, h, _ = real(weights[:half], ids, nxt, costs, sizes, budgets,
                       use_kernel)
        rest = weights.shape[0] - half     # the mean of the half replayed
        rest_d = d.mean(0, keepdim=True).expand(rest, *d.shape[1:])
        rest_h = h.float().mean(0, keepdim=True).round().int().expand(
            rest, *h.shape[1:])
        return torch.cat([d, rest_d]), torch.cat([h, rest_h]), None
    return replay


def _altered(real):
    def replay(weights, ids, nxt, costs, sizes, budgets, use_kernel,
               trace_steps=False):
        d, h, _ = real(weights, ids, nxt, costs, sizes, budgets, use_kernel)
        d = d.clone()
        d.view(-1)[7] = torch.nextafter(d.view(-1)[7],
                                        torch.tensor(float("inf")))
        return d, h, None     # one answer one ulp off where it is made
    return replay


def _raises(real):
    calls = []

    def replay(*a, **k):      # the warm-up job passes, the window's fails
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("the replay failed")
        return real(*a, **k)
    return replay


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _raises],
                         ids=["state_unchanged", "half_batch", "altered",
                              "raises"])
def test_fault_is_not_correct(fault, monkeypatch):
    from repro_torch.core import policies_torch
    monkeypatch.setattr(policies_torch, "_replay",
                        fault(policies_torch._replay))
    r = _run(_tiny())
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
