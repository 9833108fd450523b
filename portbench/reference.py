"""The plain reference of the policy replay: what decides `correct`.

A straightforward replay of the paper's exact, page-uniform semantics, one
cell at a time, written from the model and not from the program: it
imports numpy and the standard library alone, and works out next(t) and
the request frequencies again from the trace.

A cell is (policy weights w, per-object costs c and sizes s, a budget of
B pages). Each request of object i at step t counts a hit if i is cached;
else it bills c_i and inserts i, first evicting, when B pages are held,
the cached object of least score, ties to the earliest touch. Every
request (hit or insert) touches i and fixes the part of its score that
does not move with time:

    static = w_t*t + w_f*f + w_gd*(L + c/s) + w_gdsf*(L + f*c/s)
    fixed  = static + w_bel*bel,     bel = -next(t), or -BIG if never again

where f counts the requests of i so far (this one included) and L, the
GreedyDual inflation, takes the score of each evicted victim while
w_gd + w_gdsf > 0. At an eviction at step t a cached object scores
fixed + w_cb*cb, cb = s*max(next - t, 1)/(-c), or -BIG if never again.
Every operation rounds to float32 in that order (no fused multiply-add),
and the bill is a float32 running sum in request order, so a replay that
follows the model gives these bits exactly.

Cells whose score is fixed at the touch (w_cb = 0) replay with a heap;
the others score every cached object at each eviction. `precision="bf16"`
rounds every operation, and the bill, to bfloat16 instead: the control,
the nearest precision below the float32 the configuration states.
"""
from __future__ import annotations

import contextlib
import heapq
import pickle
import select
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["next_use", "request_counts", "replay_cell", "replay_grid",
           "BIG", "PRECISIONS"]

# the checkout's root, from which a worker imports this module
ROOT = Path(__file__).resolve().parent.parent

BIG = float(np.float32(3.4e38))
BIG_BF16 = 3.3895313892515355e38      # the largest finite bfloat16
PRECISIONS = ("float32", "bf16")

_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


def _r_f32(x: float) -> float:
    # a float64 sum, product or quotient of two float32 values rounds to
    # the float32 result when rounded once more (53 >= 2 * 24 + 2)
    return _F32.unpack(_F32.pack(x))[0]


def _r_bf16(x: float) -> float:
    b = _U32.unpack(_F32.pack(x))[0]
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return _F32.unpack(_U32.pack(b))[0]


def _v_bf16(a: np.ndarray) -> np.ndarray:
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def next_use(ids: np.ndarray) -> np.ndarray:
    """next(t): the step of the next request of ids[t], or T if none."""
    ids = np.asarray(ids).tolist()
    T = len(ids)
    seen: dict[int, int] = {}
    out = [T] * T
    for t in range(T - 1, -1, -1):
        i = ids[t]
        out[t] = seen.get(i, T)
        seen[i] = t
    return np.asarray(out, dtype=np.int64)


def request_counts(ids: np.ndarray) -> np.ndarray:
    """f(t): the requests of ids[t] in ids[:t+1]."""
    counts: dict[int, int] = {}
    out = []
    for i in np.asarray(ids).tolist():
        counts[i] = counts.get(i, 0) + 1
        out.append(counts[i])
    return np.asarray(out, dtype=np.int64)


class _Arith:
    """Rounding of one precision: scalars (`r`) and float32 arrays (`v`)."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.bf16 = precision == "bf16"
        self.r = _r_bf16 if self.bf16 else _r_f32
        # BIG itself rounds up to infinity in bfloat16
        self.big = BIG_BF16 if self.bf16 else BIG

    def v(self, a) -> np.ndarray:
        a = np.asarray(a, np.float32)
        return _v_bf16(a) if self.bf16 else a

    def add(self, a, b):
        return self.v(self.v(a) + self.v(b))

    def mul(self, a, b):
        return self.v(self.v(a) * self.v(b))

    def div(self, a, b):
        return self.v(self.v(a) / self.v(b))


def _bill(cost_t: np.ndarray, miss: np.ndarray, ar: _Arith) -> float:
    """The running sum of the missed requests' costs, in request order."""
    billed = cost_t[miss]
    if not ar.bf16:
        return float(np.add.accumulate(billed, dtype=np.float32)[-1]) \
            if billed.size else 0.0
    total = 0.0
    for c in ar.v(billed).tolist():
        total = _r_bf16(total + c)
    return total


def replay_cell(ids: np.ndarray, nxt: np.ndarray, freq: np.ndarray,
                costs: np.ndarray, sizes: np.ndarray, weights, budget: int,
                precision: str = "float32") -> tuple[float, int]:
    """Replay one cell. ids, nxt, freq (T,); costs, sizes (N,) float64 (cast
    to float32 here); weights (w_t, w_f, w_gd, w_gdsf, w_bel, w_cb).
    Returns (dollars, hits)."""
    ar = _Arith(precision)
    r = ar.r
    ids = np.asarray(ids, np.int64)
    T, N = len(ids), len(costs)
    w_t, w_f, w_gd, w_gdsf, w_bel, w_cb = (float(x) for x in
                                           ar.v(np.asarray(weights)))
    c32 = ar.v(np.asarray(costs, np.float32))
    s32 = ar.v(np.asarray(sizes, np.float32))
    cos = ar.div(c32, np.maximum(s32, np.float32(1e-30)))
    negc = -ar.v(np.maximum(c32, np.float32(1e-30)))
    tf = ar.v(np.arange(T, dtype=np.float32))
    f32 = ar.v(freq.astype(np.float32))
    never = nxt >= T
    # the parts of a touch's score that do not depend on L, per step
    ab = ar.add(ar.mul(w_t, tf), ar.mul(w_f, f32))
    bel = np.where(never, np.float32(-ar.big),
                   -ar.v(nxt.astype(np.float32)))
    wbel = ar.mul(w_bel, bel)
    cos_t = cos[ids]
    fcos_t = ar.mul(f32, cos_t)
    gd_active = (w_gd + w_gdsf) > 0
    if gd_active:
        fixed_t = None
    else:           # L stays 0
        static = ar.add(ar.add(ab, ar.mul(w_gd, cos_t)),
                        ar.mul(w_gdsf, fcos_t))
        fixed_t = ar.add(static, wbel).tolist()
    ab_l, wbel_l = ab.tolist(), wbel.tolist()
    cos_l, fcos_l = cos_t.tolist(), fcos_t.tolist()
    ids_l = ids.tolist()

    def fixed(t: int, L: float) -> float:
        if fixed_t is not None:
            return fixed_t[t]
        g1 = r(w_gd * r(L + cos_l[t])) if w_gd else 0.0
        g2 = r(w_gdsf * r(L + fcos_l[t])) if w_gdsf else 0.0
        return r(r(r(ab_l[t] + g1) + g2) + wbel_l[t])

    if w_cb == 0.0:
        miss = _replay_heap(ids_l, T, N, budget, fixed, gd_active)
    else:
        miss = _replay_scan(ids_l, T, N, budget, fixed, gd_active, ar, w_cb,
                            nxt, never, s32, negc)
    hits = T - int(miss.sum())
    return _bill(c32[ids], miss, ar), hits


def _replay_heap(ids_l, T, N, budget, fixed, gd_active) -> np.ndarray:
    """Scores fixed at the touch: a heap of (score, touch, object), entries
    of an object's earlier touches left in it and skipped when popped."""
    cached = bytearray(N)
    touch = [-1] * N
    miss = bytearray(T)
    heap: list = []
    used, L = 0, 0.0
    for t in range(T):
        i = ids_l[t]
        if not cached[i]:
            miss[t] = 1
            if used >= budget:
                while True:
                    s, tt, j = heapq.heappop(heap)
                    if cached[j] and touch[j] == tt:
                        break
                if s >= BIG:
                    raise ValueError("every cached object scores BIG: the "
                                     "cache would outgrow its budget")
                cached[j] = 0
                used -= 1
                if gd_active:
                    L = s
            used += 1
            cached[i] = 1
        touch[i] = t
        heapq.heappush(heap, (fixed(t, L), t, i))
    return np.frombuffer(miss, dtype=bool)


def _replay_scan(ids_l, T, N, budget, fixed, gd_active, ar, w_cb, nxt,
                 never, s32, negc) -> np.ndarray:
    """Scores that move with time: every cached object scored at each
    eviction, from a slot table."""
    cap = max(int(budget), 1)
    slot_of = np.full(N, -1, dtype=np.int64)
    obj = np.full(cap, -1, dtype=np.int64)
    s_touch = np.zeros(cap, dtype=np.int64)
    s_fixed = np.zeros(cap, dtype=np.float32)
    s_next = np.zeros(cap, dtype=np.float32)
    s_never = np.zeros(cap, dtype=bool)
    s_size = np.zeros(cap, dtype=np.float32)
    s_negc = np.zeros(cap, dtype=np.float32)
    nxt_f = ar.v(nxt.astype(np.float32))
    wcb = np.float32(w_cb)
    neg_big = np.float32(-ar.big)
    miss = np.zeros(T, dtype=bool)
    used, L = 0, 0.0
    free = list(range(cap - 1, -1, -1))
    for t in range(T):
        i = ids_l[t]
        k = slot_of[i]
        if k < 0:
            miss[t] = True
            if used >= budget:
                live = obj >= 0
                gap = np.maximum(ar.v(s_next - np.float32(t)), np.float32(1))
                cb = np.where(s_never, neg_big,
                              ar.div(ar.mul(s_size, gap), s_negc))
                raw = np.where(live, ar.add(s_fixed, ar.mul(wcb, cb)),
                               np.float32(BIG))
                low = raw.min()
                ties = np.nonzero(raw <= low)[0]
                k = int(ties[np.argmin(s_touch[ties])])
                if low >= BIG:
                    raise ValueError("every cached object scores BIG: the "
                                     "cache would outgrow its budget")
                slot_of[obj[k]] = -1
                obj[k] = -1
                free.append(k)
                used -= 1
                if gd_active:
                    L = float(low)
            k = free.pop()
            used += 1
            slot_of[i] = k
            obj[k] = i
            s_size[k] = s32[i]
            s_negc[k] = negc[i]
        s_touch[k] = t
        s_fixed[k] = fixed(t, L)
        s_next[k] = nxt_f[t]
        s_never[k] = never[t]
    return miss


def _cell_job(data: dict, cell) -> tuple:
    q, p, b = cell
    d, h = replay_cell(data["ids"], data["nxt"], data["freq"],
                       data["costs"][p], data["sizes"], data["weights"][q],
                       int(data["budgets"][b]), data["precision"])
    return cell, d, h


def _worker() -> None:
    """A child of `_grid_in_processes`: the grid's data, then one cell at a
    time on standard input until None; one result each on standard
    output."""
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    data = pickle.load(stdin)
    while (cell := pickle.load(stdin)) is not None:
        pickle.dump(_cell_job(data, cell), stdout)
        stdout.flush()


def _grid_in_processes(data: dict, cells: list, workers: int) -> list:
    """`_cell_job` over `cells` on `workers` child processes, each handed
    the next cell when it returns one. Plain pipes, no multiprocessing:
    nothing (such as its resource tracker) outlives the call, and every
    child has ended before it returns, on every path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench.reference import _worker; _worker()")
    procs = []
    try:
        for _ in range(min(workers, len(cells))):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(ROOT)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        todo, results, busy = list(cells), [], {}

        def hand(proc):
            pickle.dump(todo.pop(0) if todo else None, proc.stdin)
            proc.stdin.flush()

        for proc in procs:
            pickle.dump(data, proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            if todo:
                busy[proc.stdout.fileno()] = proc
            hand(proc)
        while busy:
            ready, _, _ = select.select(list(busy), [], [])
            for fd in ready:
                proc = busy.pop(fd)
                results.append(pickle.load(proc.stdout))
                if todo:
                    busy[fd] = proc
                hand(proc)
        for proc in procs:
            proc.stdin.close()
            if proc.wait() != 0:
                raise RuntimeError(f"reference worker exited {proc.returncode}")
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for f in (proc.stdin, proc.stdout):
                with contextlib.suppress(OSError):
                    f.close()


def replay_grid(ids: np.ndarray, costs: np.ndarray, sizes: np.ndarray,
                weights: np.ndarray, budgets, precision: str = "float32",
                workers: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Every (policy, price vector, budget) cell: dollars (Q, P, K) float32
    and hits (Q, P, K) int64. costs (P, N) float64; weights (Q, 6).
    `workers` > 1 spreads the cells over that many child processes, all
    ended before it returns."""
    ids = np.asarray(ids, np.int64)
    data = dict(ids=ids, nxt=next_use(ids), freq=request_counts(ids),
                costs=np.asarray(costs, np.float64),
                sizes=np.asarray(sizes, np.float64),
                weights=np.asarray(weights, np.float64),
                budgets=np.asarray(budgets, np.int64), precision=precision)
    Q, P, K = len(data["weights"]), len(data["costs"]), len(data["budgets"])
    # the cells that score at each eviction take longest: start them first
    cells = sorted(np.ndindex(Q, P, K),
                   key=lambda c: (data["weights"][c[0]][5] == 0, c))
    dollars = np.zeros((Q, P, K), np.float32)
    hits = np.zeros((Q, P, K), np.int64)
    if workers <= 1:
        results = [_cell_job(data, c) for c in cells]
    else:
        results = _grid_in_processes(data, cells, workers)
    for c, d, h in results:
        dollars[c], hits[c] = d, h
    return dollars, hits
