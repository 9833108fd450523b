"""Job kind `sweep_grid`: the paper's measurement loop as a user runs it.

A job is one call of `repro_torch.core.policies_torch.sweep_torch` over the
traffic's policy panel x list price vectors x page budgets, on one trace of
the cell's configuration, ending with its dollars and hit counts as numpy
arrays on the host. Set-up draws a pool of traces from the seed, each with
its (P, N) cost matrix c_i = f + s_i * e, and the jobs take them in turn;
the program receives only these arrays.

The judge: the plain replay (`portbench/reference.py`) of one trace drawn
from the seed, in every cell, against every job of the window on that
trace. Dollars must agree bit for bit and hits exactly.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from portbench import frozen, reference

# the program's calls inside a job that a traced run wraps in spans
SPANS = [("repro_torch.core.policies_torch", "_prepare"),
         ("repro_torch.core.policies_torch", "frequency_rank"),
         ("repro_torch.core.policies_torch", "replay_scan_cuda"),
         ("repro_torch.kernels.ops", "next_use"),
         ("repro_torch.core.carry", "to_numpy")]

# cells whose dollars (float32 bits) or hits differ from the reference, over
# every compared job: an exact comparison
LIMITS = {"hits_off": 0, "dollars_off": 0}


@dataclasses.dataclass
class State:
    pool: list            # [(ids int32 (T,), sizes float64 (N,), costs (P, N))]
    policies: list
    budgets: np.ndarray
    check_seed: int
    facts: dict
    device: str | None    # None: the program's default, the card
    sweep: object = None  # the program's entry
    setup_parts: dict = dataclasses.field(default_factory=dict)


def draw(config: dict, traffic: dict, seed: int,
         device: str | None = None) -> State:
    """The cell's inputs from `seed`: the pool of traces and their cost
    matrices, and the check's seed. Touches no device."""
    gen = frozen.GENERATORS[config["generator"]]
    N, T = int(config["n_objects"]), int(config["n_requests"])
    prices = list(traffic["prices"])
    n_pool = int(traffic["pool"])
    words = np.random.SeedSequence(seed % 2**64).generate_state(
        n_pool + 1, dtype=np.uint64)
    pool = []
    for k in range(n_pool):
        ids, sizes = gen(N, T, int(words[k]))
        costs = np.stack([frozen.miss_costs(sizes, p) for p in prices])
        pool.append((ids, sizes, costs))
    budgets = np.asarray(traffic["budgets"], dtype=np.int64)
    Q, P, K = len(traffic["policies"]), len(prices), len(budgets)
    ids_bytes = 4 * T
    facts = dict(T=T, N=N, Q=Q, P=P, K=K, cells=Q * P * K,
                 # the replay's inputs and outputs, each byte once: ids,
                 # next(t) and the frequency rank (int32 a request), float32
                 # costs and sizes, the weights and budgets; dollars and hits
                 replay_bytes=3 * ids_bytes + 4 * P * N + 4 * N + 24 * Q
                 + 4 * K + 8 * Q * P * K,
                 next_use_bytes=2 * ids_bytes)
    return State(pool=pool, policies=list(traffic["policies"]),
                 budgets=budgets, check_seed=int(words[n_pool]),
                 facts=facts, device=device)


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
    return float(state.facts["T"] * state.facts["cells"])


def run(state: State, j: int):
    """Job j: the grid of trace j mod pool, (dollars, hits) on the host."""
    ids, sizes, costs = state.pool[j % len(state.pool)]
    return state.sweep(state.policies, ids, costs, state.budgets,
                       num_objects=len(sizes), sizes=sizes,
                       return_hits=True, device=state.device)


def compared_trace(state: State, jobs: list) -> int:
    """The pool trace whose jobs the judge compares, drawn from the seed
    among the traces the window ran."""
    ran = sorted({j % len(state.pool) for j in jobs})
    return ran[int(np.random.default_rng(state.check_seed)
                   .integers(len(ran)))]


def reference_grid(state: State, k: int, precision: str = "float32",
                   workers: int = 1):
    """The plain replay of pool trace k in every cell."""
    ids, sizes, costs = state.pool[k]
    return reference.replay_grid(ids, costs, sizes,
                                 frozen.policy_weights(state.policies),
                                 state.budgets, precision=precision,
                                 workers=workers)


def judge(state: State, outputs: list, workers: int = 1,
          expected=None) -> tuple[dict, dict]:
    """({number: (value, limit)}, {detail: value}) over the window's
    outputs [(j, (dollars, hits))]: every job on the compared trace against
    the reference (`expected`, or worked out here)."""
    if not outputs:       # no answer came: every cell is off
        cells = state.facts["cells"]
        return ({name: (cells, limit) for name, limit in LIMITS.items()},
                {"trace_compared": None, "jobs_compared": 0,
                 "cells_compared": 0})
    k = compared_trace(state, [j for j, _ in outputs])
    ref_d, ref_h = expected if expected is not None else \
        reference_grid(state, k, workers=workers)
    ref_bits = np.asarray(ref_d, np.float32).view(np.int32)
    hits_off = dollars_off = jobs = 0
    for j, (d, h) in outputs:
        if j % len(state.pool) != k:
            continue
        jobs += 1
        d = np.asarray(d)
        h = np.asarray(h)
        if d.shape != ref_d.shape or h.shape != ref_h.shape:
            hits_off += ref_h.size
            dollars_off += ref_d.size
            continue
        hits_off += int((h.astype(np.int64) != ref_h).sum())
        dollars_off += int((d.astype(np.float32).view(np.int32)
                            != ref_bits).sum())
    if jobs == 0:         # no answer came on the compared trace
        hits_off = dollars_off = ref_h.size
    return ({"hits_off": (hits_off, LIMITS["hits_off"]),
             "dollars_off": (dollars_off, LIMITS["dollars_off"])},
            {"trace_compared": k, "jobs_compared": jobs,
             "cells_compared": jobs * int(ref_h.size)})


def free(state: State) -> None:
    """The program keeps no state between calls but the caching
    allocator's blocks, which the run empties."""
    state.sweep = None


def reference_workers() -> int:
    return max(1, min(8, len(os.sched_getaffinity(0))))


def control(state: State, jobs: int, workers: int = 1) -> tuple[dict, dict]:
    """The judge's numbers for the control: the reference in bfloat16 put
    in the program's place for jobs 0..jobs-1."""
    k = compared_trace(state, list(range(jobs)))
    expected = reference_grid(state, k, workers=workers)
    low = reference_grid(state, k, precision="bf16", workers=workers)
    outputs = [(j, low) for j in range(jobs) if j % len(state.pool) == k]
    return judge(state, outputs, expected=expected)
