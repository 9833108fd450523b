"""Job kind `sweep_counted`: `sweep_grid`'s closed loop of grid jobs, in
page or byte budgets, with the replay kernel's counters read after the
window.

A job is one call of `repro_torch.core.policies_torch.sweep_torch` over the
traffic's policy panel x list price vectors x budgets, on one trace of a
pool drawn from the seed, ending with its dollars and hit counts as numpy
arrays on the host. The traffic's `budget_unit`:

  pages          budgets are pages, and a job is `sweep_grid`'s job, the
                 same call; the judge is `sweep_grid`'s (`reference.py`).
  catalog_share  budgets are shares of each pool trace's catalog: sizes
                 are rounded up to whole bytes, costs c_i = f + s_i * e
                 come from those sizes, and a trace's budgets are
                 floor(share x its catalog's bytes). A job replays the
                 byte budgets (`budget_unit="bytes"`), and the judge is
                 `reference_bytes.py`.

Both judges are exact: every job of the window on the trace the seed draws
is compared in every cell, dollars bit for bit and hits exactly.

After the window of a traced run (in `judge`, before the reference runs)
the kind makes one more call per pool trace with `profile=`, the same
kernel on the same inputs, and keeps each call's `profile["work"]` in
`state.facts["work"]` (with `facts["work_columns"]`), which a run hands its
metric readers; only a traced run reads them, so an untraced one makes no
such call. A run is traced when a profiler watches its jobs. The timed
jobs make the same calls as in an untraced run.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench import frozen, reference_bytes, spec

grid = spec.job_kind("sweep_grid")

# the program's calls inside a job that a traced run wraps in spans (a name
# the program lacks is left out)
SPANS = grid.SPANS + [("repro_torch.core.policies_torch",
                       "replay_bytes_cuda")]

LIMITS = grid.LIMITS


@dataclasses.dataclass
class State:
    pool: list            # [(ids int32 (T,), sizes float64 (N,), costs (P, N))]
    policies: list
    budgets: np.ndarray   # pages; for bytes, the first trace's (budget_of)
    check_seed: int
    facts: dict
    device: str | None    # None: the program's default, the card
    unit: str = "pages"   # "pages" or "bytes"
    shares: tuple = ()    # bytes: the budgets as shares of the catalog
    sweep: object = None  # the program's entry
    traced: bool = False  # a profiler watched a job of the window
    setup_parts: dict = dataclasses.field(default_factory=dict)


def budget_of(state: State, k: int) -> np.ndarray:
    """The budgets of pool trace k: pages, or bytes of its catalog."""
    if state.unit == "pages":
        return state.budgets
    catalog = int(np.asarray(state.pool[k][1], np.int64).sum())
    return np.array([int(s * catalog) for s in state.shares], np.int64)


def draw(config: dict, traffic: dict, seed: int,
         device: str | None = None) -> State:
    """The cell's inputs from `seed`, as `sweep_grid` draws them; for byte
    budgets with whole-byte sizes and the costs of those. Touches no
    device."""
    unit = traffic.get("budget_unit", "pages")
    if unit not in ("pages", "catalog_share"):
        raise ValueError(f"budget_unit {unit!r}: pages or catalog_share")
    g = grid.draw(config, traffic, seed, device)
    facts = dict(g.facts)
    if unit == "pages":
        return State(pool=g.pool, policies=g.policies, budgets=g.budgets,
                     check_seed=g.check_seed, facts=facts, device=device)
    prices = list(traffic["prices"])
    pool = []
    for ids, sizes, _ in g.pool:
        whole = np.ceil(sizes)
        costs = np.stack([frozen.miss_costs(whole, p) for p in prices])
        pool.append((ids, whole, costs))
    state = State(pool=pool, policies=g.policies, budgets=g.budgets,
                  check_seed=g.check_seed, facts=facts, device=device,
                  unit="bytes",
                  shares=tuple(float(s) for s in traffic["budgets"]))
    state.budgets = budget_of(state, 0)
    return state


def setup(config: dict, traffic: dict, seed: int,
          device: str | None = None) -> State:
    """`draw`, then import the program and warm it up on every shape the
    jobs use."""
    t0 = time.perf_counter()
    state = draw(config, traffic, seed, device)
    t1 = time.perf_counter()
    from repro_torch.core.policies_torch import sweep_torch
    state.sweep = sweep_torch
    t2 = time.perf_counter()
    for j in range(int(traffic["warmup_jobs"])):
        run(state, j)
    state.setup_parts = dict(inputs=t1 - t0, import_program=t2 - t1,
                             warmup=time.perf_counter() - t2)
    return state


def work(state: State) -> float:
    """Cell-requests a job replays."""
    return grid.work(state)


def _call(state: State, k: int, **extra):
    ids, sizes, costs = state.pool[k]
    if state.unit == "bytes":
        extra["budget_unit"] = "bytes"
    return state.sweep(state.policies, ids, costs, budget_of(state, k),
                       num_objects=len(sizes), sizes=sizes,
                       return_hits=True, device=state.device, **extra)


def run(state: State, j: int):
    """Job j: the grid of trace j mod pool, (dollars, hits) on the host."""
    from torch.autograd import profiler
    state.traced = state.traced or profiler._is_profiler_enabled
    return _call(state, j % len(state.pool))


def counters(state: State) -> None:
    """One `profile=` call per pool trace: its `work` (None where the
    program returns none, as on the CPU) into `state.facts`."""
    from repro_torch.kernels import replay_scan
    works = []
    for k in range(len(state.pool)):
        prof: dict = {}
        _call(state, k, profile=prof)
        works.append(prof.get("work"))
    state.facts["work"] = works
    state.facts["work_columns"] = (
        getattr(replay_scan, "BYTE_WORK_COLUMNS", None)
        if state.unit == "bytes" else replay_scan.WORK_COLUMNS)


def reference_grid(state: State, k: int, precision: str = "float32",
                   workers: int = 1):
    """The plain replay of pool trace k in every cell."""
    if state.unit == "pages":
        return grid.reference_grid(state, k, precision, workers)
    ids, sizes, costs = state.pool[k]
    return reference_bytes.replay_grid(
        ids, costs, sizes, frozen.policy_weights(state.policies),
        budget_of(state, k), precision=precision, workers=workers)


def judge(state: State, outputs: list, workers: int = 1,
          expected=None) -> tuple[dict, dict]:
    """The counters (in a traced run, while the program is at hand), then
    `sweep_grid`'s comparison of the window's outputs against this unit's
    reference."""
    if state.traced and state.sweep is not None:
        counters(state)
    if outputs and expected is None:
        k = grid.compared_trace(state, [j for j, _ in outputs])
        expected = reference_grid(state, k, workers=workers)
    return grid.judge(state, outputs, expected=expected)


def free(state: State) -> None:
    """The program keeps no state between calls but the caching
    allocator's blocks, which the run empties; the entry stays for the
    counters' calls."""


def reference_workers() -> int:
    return grid.reference_workers()


def control(state: State, jobs: int, workers: int = 1) -> tuple[dict, dict]:
    """The judge's numbers for the control: the reference in bfloat16 put
    in the program's place for jobs 0..jobs-1."""
    k = grid.compared_trace(state, list(range(jobs)))
    expected = reference_grid(state, k, workers=workers)
    low = reference_grid(state, k, precision="bf16", workers=workers)
    outputs = [(j, low) for j in range(jobs) if j % len(state.pool) == k]
    return judge(state, outputs, expected=expected)
