"""The plain reference of the byte replay: what decides `correct` in the
cells whose budgets are bytes.

A straightforward replay of the paper's byte-budget semantics (its CDN
arm), one cell at a time, written from the model and not from the program:
numpy, the standard library and `reference.py`'s helpers (next(t), the
frequencies, the rounding of each precision, the bill), which work out
everything again from the trace.

A cell is (policy weights w, per-object costs c, whole-byte sizes s, a
budget of B bytes). Each request of object i at step t counts a hit if i is
cached. Else it bills c_i, and if s_i > B it is fetched through (not
admitted, nothing evicted, L unchanged); otherwise, while the bytes held
plus s_i exceed B, the cached object of least score is evicted (ties to
the earliest touch), its bytes leave the cache and, while w_gd + w_gdsf >
0, L takes its score; where no cached object scores below 3.4e38 the miss
is fetched through instead. Then i is admitted. Scores are
`reference.py`'s, with the sizes' float32 values in the cost terms: a
touch (hit or admission) fixes

    fixed = static + w_bel*bel,  static = w_t*t + w_f*f + w_gd*(L + c/s)
                                          + w_gdsf*(L + f*c/s)

and at an eviction at step t a cached object scores fixed + w_cb*cb,
cb = s*max(next - t, 1)/(-c), or -BIG if never again. Every operation
rounds to float32 in that order, and the bill is a float32 running sum in
request order. Cells with w_cb = 0 replay with a heap; the others score
every cached object at each eviction, vectorised over a dense table.
`precision="bf16"` rounds every operation, and the bill, to bfloat16: the
control.
"""
from __future__ import annotations

import contextlib
import heapq
import pickle
import select
import subprocess
import sys
from pathlib import Path

import numpy as np

from portbench.reference import (BIG, _Arith, _bill, next_use,
                                 request_counts)

__all__ = ["replay_cell", "replay_grid"]

ROOT = Path(__file__).resolve().parent.parent


def replay_cell(ids: np.ndarray, nxt: np.ndarray, freq: np.ndarray,
                costs: np.ndarray, sizes: np.ndarray, weights, budget: int,
                precision: str = "float32") -> tuple[float, int]:
    """Replay one cell. ids, nxt, freq (T,); costs (N,) float64; sizes (N,)
    whole bytes; weights (6,); budget in bytes. Returns (dollars, hits)."""
    ar = _Arith(precision)
    r = ar.r
    ids = np.asarray(ids, np.int64)
    T = len(ids)
    whole = np.asarray(sizes, np.int64)
    w_t, w_f, w_gd, w_gdsf, w_bel, w_cb = (float(x) for x in
                                           ar.v(np.asarray(weights)))
    c32 = ar.v(np.asarray(costs, np.float32))
    s32 = ar.v(whole.astype(np.float32))
    cos = ar.div(c32, np.maximum(s32, np.float32(1e-30)))
    negc = -ar.v(np.maximum(c32, np.float32(1e-30)))
    tf = ar.v(np.arange(T, dtype=np.float32))
    f32 = ar.v(freq.astype(np.float32))
    never = nxt >= T
    ab = ar.add(ar.mul(w_t, tf), ar.mul(w_f, f32))
    bel = np.where(never, np.float32(-ar.big),
                   -ar.v(nxt.astype(np.float32)))
    wbel = ar.mul(w_bel, bel)
    cos_t = cos[ids]
    fcos_t = ar.mul(f32, cos_t)
    gd_active = (w_gd + w_gdsf) > 0
    # L stays 0 where no GreedyDual weight is on: every touch's score at once
    static = ar.add(ar.add(ab, ar.mul(w_gd, cos_t)), ar.mul(w_gdsf, fcos_t))
    fixed_t = None if gd_active else ar.add(static, wbel).tolist()
    ab_l, wbel_l = ab.tolist(), wbel.tolist()
    cos_l, fcos_l = cos_t.tolist(), fcos_t.tolist()

    def fixed(t: int, L: float) -> float:
        if fixed_t is not None:
            return fixed_t[t]
        g1 = r(w_gd * r(L + cos_l[t])) if w_gd else 0.0
        g2 = r(w_gdsf * r(L + fcos_l[t])) if w_gdsf else 0.0
        return r(r(r(ab_l[t] + g1) + g2) + wbel_l[t])

    if w_cb == 0.0:
        miss = _replay_heap(ids.tolist(), T, whole.tolist(), int(budget),
                            fixed, gd_active)
    else:
        miss = _replay_scan(ids, T, whole, int(budget), fixed, gd_active, ar,
                            w_cb, nxt, never, s32, negc)
    return _bill(c32[ids], miss, ar), T - int(miss.sum())


def _replay_heap(ids_l, T, whole_l, budget, fixed, gd_active) -> np.ndarray:
    """Scores fixed at the touch: a heap of (score, touch, object), entries
    of an object's earlier touches left in it and skipped when popped."""
    touch: dict = {}
    miss = bytearray(T)
    heap: list = []
    held, L = 0, 0.0
    for t in range(T):
        i = ids_l[t]
        if i not in touch:
            miss[t] = 1
            b = whole_l[i]
            if b > budget:
                continue                    # fetched through
            admit = True
            while held + b > budget:
                while True:
                    s, tt, j = heap[0]
                    if touch.get(j) == tt:
                        break
                    heapq.heappop(heap)
                if not s < BIG:             # nothing below 3.4e38 (or NaN)
                    admit = False
                    break
                heapq.heappop(heap)
                del touch[j]
                held -= whole_l[j]
                if gd_active:
                    L = s
            if not admit:
                continue
            held += b
        touch[i] = t
        heapq.heappush(heap, (fixed(t, L), t, i))
    return np.frombuffer(miss, dtype=bool)


def _replay_scan(ids, T, whole, budget, fixed, gd_active, ar, w_cb, nxt,
                 never, s32, negc) -> np.ndarray:
    """Scores that move with time: every cached object scored at each
    eviction, vectorised over a dense table of the u objects held (a
    victim's row takes the last row's)."""
    order = np.sort(whole)
    cap = max(1, int(np.searchsorted(np.cumsum(order), budget, "right")))
    row_of = np.full(len(whole), -1, np.int64)
    obj = np.zeros(cap, np.int64)
    r_touch = np.zeros(cap, np.int64)
    r_fixed = np.zeros(cap, np.float32)
    r_next = np.zeros(cap, np.float32)
    r_never = np.zeros(cap, bool)
    r_size = np.zeros(cap, np.float32)
    r_negc = np.zeros(cap, np.float32)
    nxt_f = ar.v(nxt.astype(np.float32))
    wcb = np.float32(w_cb)
    one = np.float32(1)
    neg_big = np.float32(-ar.big)
    ids_l, whole_l = ids.tolist(), whole.tolist()
    miss = np.zeros(T, dtype=bool)
    held, L, u = 0, 0.0, 0
    for t in range(T):
        i = ids_l[t]
        k = row_of[i]
        if k < 0:
            miss[t] = True
            b = whole_l[i]
            if b > budget:
                continue                    # fetched through
            admit = True
            while held + b > budget:
                gap = np.maximum(ar.v(r_next[:u] - np.float32(t)), one)
                cb = np.where(r_never[:u], neg_big,
                              ar.div(ar.mul(r_size[:u], gap), r_negc[:u]))
                raw = ar.add(r_fixed[:u], ar.mul(wcb, cb))
                v = int(np.argmin(raw))
                low = raw[v]
                if not low < BIG:           # nothing below 3.4e38 (or NaN)
                    admit = False
                    break
                ties = np.flatnonzero(raw == low)
                if len(ties) > 1:
                    v = int(ties[np.argmin(r_touch[ties])])
                held -= whole_l[obj[v]]
                if gd_active:
                    L = float(raw[v])
                row_of[obj[v]] = -1
                u -= 1
                if v != u:                  # the last row takes its place
                    for a in (obj, r_touch, r_fixed, r_next, r_never, r_size,
                              r_negc):
                        a[v] = a[u]
                    row_of[obj[v]] = v
            if not admit:
                continue
            held += b
            k = u
            u += 1
            row_of[i] = k
            obj[k] = i
            r_size[k] = s32[i]
            r_negc[k] = negc[i]
        r_touch[k] = t
        r_fixed[k] = fixed(t, L)
        r_next[k] = nxt_f[t]
        r_never[k] = never[t]
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
    """`_cell_job` over `cells` on `workers` child processes, as
    `reference._grid_in_processes` runs the page cells: plain pipes, every
    child ended before it returns, on every path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench.reference_bytes import _worker; _worker()")
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
    and hits (Q, P, K) int64. costs (P, N) float64; sizes (N,) whole bytes;
    weights (Q, 6); budgets (K,) bytes. `workers` > 1 spreads the cells
    over that many child processes, all ended before it returns."""
    ids = np.asarray(ids, np.int64)
    data = dict(ids=ids, nxt=next_use(ids), freq=request_counts(ids),
                costs=np.asarray(costs, np.float64),
                sizes=np.asarray(sizes, np.int64),
                weights=np.asarray(weights, np.float64),
                budgets=np.asarray(budgets, np.int64), precision=precision)
    Q, P, K = len(data["weights"]), len(data["costs"]), len(data["budgets"])
    # the cells that score at each eviction take longest, the largest
    # budgets most: start them first
    cells = sorted(np.ndindex(Q, P, K),
                   key=lambda c: (data["weights"][c[0]][5] == 0, -c[2], c))
    dollars = np.zeros((Q, P, K), np.float32)
    hits = np.zeros((Q, P, K), np.int64)
    if workers <= 1:
        results = [_cell_job(data, c) for c in cells]
    else:
        results = _grid_in_processes(data, cells, workers)
    for c, d, h in results:
        dollars[c], hits[c] = d, h
    return dollars, hits
