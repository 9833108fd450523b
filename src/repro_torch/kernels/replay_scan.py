"""Wrapper of the CUDA `replay_scan` kernel (`csrc/replay_scan.cu`).

The port of the reference's replay scan: `src/repro/core/policies_jax.py`,
`_simulate`'s `lax.scan` (whose step calls the Pallas `evict_argmin`),
vmapped over the (policy x price vector x budget) grid by `sweep_jax`. One
launch replays every cell; its plain version is the port's step loop,
`repro_torch.core.policies_torch._replay(use_kernel=False)`, which
`policies_torch.sweep_torch` takes on the CPU.

`replay_bytes_cuda` launches the same source's byte replay
(`replay_bytes_kernel`): budgets in bytes, each object taking its
whole-byte size, a miss evicting until the object fits or fetching it
through; its plain version is `_replay` given the sizes as integers.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["replay_scan_cuda", "replay_bytes_cuda",
           "plan", "STATIC_WARPS", "FULL_WARPS",
           "WORK_COLUMNS", "BYTE_WORK_COLUMNS", "BOUND_GROUP"]

CHUNK = 512                       # requests a block stages at once
# id, next use, cost, size, -cost, c/s, f * c/s, w_t*t + w_f*f (or the whole
# score part fixed at a touch), w_bel * bel
STAGE_BYTES = CHUNK * 9 * 4
# (image of sb, touch) as one 8-byte key, object, next use, sb, size, -cost
SLOT_WORDS = 7
# and in the byte replay the whole-byte size
BYTE_SLOT_WORDS = 8
# The warps that score an evicting step, (one, per) as csrc/replay_scan.cu's
# kStaticOne/Per and kFullOne/Per ("The warps follow the table"): one while the
# table holds at most `one` slots, else one for each `per` slots (2 to 16),
# for rows whose score is fixed at the touch (w_cb == 0: one 8-byte key a
# slot, no division) and for the rest (six words and a division a slot).
STATIC_WARPS = (1024, 320)
FULL_WARPS = (128, 128)
_COUNTERS = ("scored_steps", "slots_scored", "peak_slots", "cycles",
             "evict_cycles")
# Last in every cell's row, its launch. One block fills an SM, so a grid of
# more cells than SMs replays in waves, and blocks start in index order:
# there block b replays the b-th cell in (class, policy row, price, budget)
# order, the rows with w_cb != 0 first, then GreedyDual's (w_gd + w_gdsf >
# 0), then those whose score is fixed at the touch, so the slowest rows
# start in the first wave; in a grid of one wave block b replays cell b.
# `block` is the block that replayed the cell, `start_ns` and `end_ns` the
# card's %globaltimer at its start and end (a launch's span over its
# longest cell's own time: 1.0 where no cell waited for an SM).
_LAUNCH = ("block", "start_ns", "end_ns")
WORK_COLUMNS = _COUNTERS + _LAUNCH
# the byte replay's: also the evictions, the misses fetched through (not
# admitted: larger than the budget, or nothing below 3.4e38 to evict) and
# the slots its evicting steps scored (`slots_scored` less those that the
# cost-Belady rows' group bounds left out), before the launch's
BYTE_WORK_COLUMNS = _COUNTERS + ("victims", "fetch_through",
                                 "rescanned_slots") + _LAUNCH
# slots under one lower bound in the byte replay (csrc/replay_scan.cu's
# kGroup)
BOUND_GROUP = 32


def plan(cells: int, num_objects: int, shared_limit: int,
         by_bytes: bool = False) -> dict:
    """The layout of a launch over `cells` cells of `num_objects` objects
    when a block may take `shared_limit` bytes of dynamic shared memory;
    `by_bytes`: the byte replay's, with `BYTE_SLOT_WORDS` a slot.

    The object -> slot map goes to shared memory when it takes at most half
    of what the staging leaves, else to a (cells, N) int32 region of device
    memory (`map_words`). The slot table holds `slots_shared` slots in the
    shared memory left over; when that is fewer than N (a cache can grow to
    all N objects when no score is below 3.4e38), each cell gets a region of
    N slots in device memory (`slot_words`, N rounded up to even so that
    every region's keys are 8-byte aligned), into which its table moves if
    it outgrows the shared one. A byte cache never holds more than N
    objects either. `shared_bytes`: the dynamic shared memory a block
    takes. The byte replay's layout also has `bound_words`: each cell's
    lower bounds of its cost-Belady keys, one 8-byte key for every
    `BOUND_GROUP` slots of N, in device memory.
    """
    N = num_objects
    words = BYTE_SLOT_WORDS if by_bytes else SLOT_WORDS
    room = shared_limit - STAGE_BYTES
    map_bytes = -(-4 * N // 16) * 16
    map_shared = map_bytes <= room // 2
    if map_shared:
        room -= map_bytes
    slots_shared = min(N, room // (4 * words))
    if slots_shared < 1:
        raise ValueError(f"replay_scan: {shared_limit} bytes of shared memory "
                         "hold no slot")
    layout = dict(map_shared=map_shared, slots_shared=slots_shared,
                  shared_bytes=(STAGE_BYTES + (map_bytes if map_shared else 0)
                                + 4 * words * slots_shared),
                  map_words=0 if map_shared else cells * N,
                  slot_words=(0 if slots_shared == N
                              else cells * words * (N + N % 2)))
    if by_bytes:
        layout["bound_words"] = cells * 2 * -(-N // BOUND_GROUP)
    return layout


def _check(weights, ids, nxt, rank, costs, sizes, budgets,
           by_bytes: bool = False) -> None:
    named = [("weights", weights, torch.float32, 2),
             ("ids", ids, torch.int32, 1), ("nxt", nxt, torch.int32, 1),
             ("rank", rank, torch.int32, 1),
             ("costs", costs, torch.float32, 2),
             ("sizes", sizes, torch.int32 if by_bytes else torch.float32, 1),
             ("budgets", budgets, torch.int64 if by_bytes else torch.int32,
              1)]
    for name, x, dtype, dim in named:
        if x.dtype != dtype or x.dim() != dim or not x.is_contiguous():
            raise ValueError(f"replay_scan_cuda: {name} must be a contiguous "
                             f"{dim}-d {dtype} tensor")
    T, (P, N) = ids.shape[0], costs.shape
    if weights.shape[1] != 6:
        raise ValueError("replay_scan_cuda: weights must have shape (Q, 6)")
    if nxt.shape != (T,) or rank.shape != (T,) or sizes.shape != (N,):
        raise ValueError("replay_scan_cuda: nxt and rank must have the ids' "
                         "shape, sizes (N,) for costs (P, N)")
    cells = weights.shape[0] * P * budgets.shape[0]
    if N < 1 or cells < 1 or cells >= 2**31 or T >= 2**31:
        raise ValueError("replay_scan_cuda: unsupported shape: "
                         f"{cells} cells, N={N}, T={T}")
    for name, x, _, _ in named:
        if not x.is_cuda:
            raise ValueError(f"replay_scan_cuda: {name} is not a CUDA tensor")
        if x.device != ids.device:
            raise ValueError("replay_scan_cuda: tensors on different devices")


def _launch(weights, ids, nxt, rank, costs, sizes, budgets,
            by_bytes: bool = False):
    """One launch of `replay_scan_kernel`, or `by_bytes` of
    `replay_bytes_kernel`, on checked inputs: (dollars, hits, work)."""
    lib = _build.library()
    launch, limit, columns = (
        (lib.replay_bytes_launch, lib.replay_bytes_shared_limit,
         BYTE_WORK_COLUMNS) if by_bytes else
        (lib.replay_scan_launch, lib.replay_scan_shared_limit, WORK_COLUMNS))
    Q, (P, N), K, T = weights.shape[0], costs.shape, budgets.shape[0], \
        ids.shape[0]
    dev = ids.device
    with torch.cuda.device(dev):
        layout = plan(Q * P * K, N, limit(), by_bytes=by_bytes)
        # the step loop's per-object columns, by the same ops, from the
        # sizes' float32 values (the byte sizes' conversion; else no copy)
        size_f = sizes.to(torch.float32)
        c_over_s = costs / torch.clamp_min(size_f, 1e-30)
        neg_cost_floor = -torch.clamp_min(costs, 1e-30)
        dollars = torch.empty((Q, P, K), dtype=torch.float32, device=dev)
        hits = torch.empty((Q, P, K), dtype=torch.int32, device=dev)
        work = torch.empty((Q, P, K, len(columns)), dtype=torch.int64,
                           device=dev)
        map_g = torch.empty(layout["map_words"], dtype=torch.int32,
                            device=dev)
        slots_g = torch.empty(layout["slot_words"], dtype=torch.int32,
                              device=dev)
        regions = [map_g.data_ptr() if map_g.numel() else None,
                   slots_g.data_ptr() if slots_g.numel() else None]
        if by_bytes:
            bounds = torch.empty(layout["bound_words"], dtype=torch.int32,
                                 device=dev)
            regions.append(bounds.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ids.data_ptr(), nxt.data_ptr(), rank.data_ptr(),
            weights.data_ptr(), costs.data_ptr(), c_over_s.data_ptr(),
            neg_cost_floor.data_ptr(), sizes.data_ptr(), budgets.data_ptr(),
            dollars.data_ptr(), hits.data_ptr(), work.data_ptr(), *regions,
            T, N, Q, P, K, int(layout["map_shared"]), layout["slots_shared"],
            layout["shared_bytes"], stream)
    if err != 0:
        name = "replay_bytes" if by_bytes else "replay_scan"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return dollars, hits, work


def replay_scan_cuda(weights: torch.Tensor, ids: torch.Tensor,
                     nxt: torch.Tensor, rank: torch.Tensor,
                     costs: torch.Tensor, sizes: torch.Tensor,
                     budgets: torch.Tensor):
    """Replay every (policy, price vector, budget) cell over the trace, on
    the card, in one launch.

    weights (Q, 6) float32; ids, nxt (next(t)) and rank (from
    `ops.next_use(..., with_rank=True)`) (T,) int32, ids in [0, N) (the
    kernel does not check); costs (P, N) and sizes (N,) float32; budgets
    (K,) int32; all contiguous CUDA tensors on one device. Returns dollars
    (Q, P, K) float32 and hits (Q, P, K) int32,
    bit-equal to `_replay(use_kernel=False)` on the same inputs, and work
    (Q, P, K, 8) int64, columns `WORK_COLUMNS`: the steps that scored the
    cache, the slots on them (the cache's size on each), the largest cache
    held, the cell's clock64() cycles from start to end and those spent from
    reaching an evicting step to its victim, then the block that replayed
    the cell (past one wave, slowest rows first; see `WORK_COLUMNS`) and the
    block's start and end in ns. Launches one kernel on the current stream, does not
    synchronise, and raises if the launch is refused.
    """
    _check(weights, ids, nxt, rank, costs, sizes, budgets)
    out = _launch(weights, ids, nxt, rank, costs, sizes, budgets)
    replay_scan_cuda.launches += 1
    return out


replay_scan_cuda.launches = 0


def replay_bytes_cuda(weights: torch.Tensor, ids: torch.Tensor,
                      nxt: torch.Tensor, rank: torch.Tensor,
                      costs: torch.Tensor, sizes: torch.Tensor,
                      budgets: torch.Tensor):
    """The byte replay of every cell, on the card, in one launch of
    `replay_bytes_kernel`.

    As `replay_scan_cuda`, but sizes (N,) int32 in whole bytes (>= 0) and
    budgets (K,) int64 in bytes (>= 0). Returns dollars (Q, P, K) float32
    and hits (Q, P, K) int32, bit-equal to `_replay(use_kernel=False)` on
    the same inputs (its byte replay, which these integer sizes select),
    and work (Q, P, K, 11) int64, columns `BYTE_WORK_COLUMNS`. Launches one
    kernel on the current stream, does not synchronise, and raises if the
    launch is refused.
    """
    _check(weights, ids, nxt, rank, costs, sizes, budgets, by_bytes=True)
    out = _launch(weights, ids, nxt, rank, costs, sizes, budgets,
                  by_bytes=True)
    replay_bytes_cuda.launches += 1
    return out


replay_bytes_cuda.launches = 0
