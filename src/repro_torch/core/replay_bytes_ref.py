"""The byte replay's plain reference: one cell at a time, on the CPU, in
plain PyTorch and float32.

What `sweep_torch(..., budget_unit="bytes")` must give, written from the
model and not from the program: it imports no kernel of the port and not
`policies_torch`, and works out next(t) and the request frequencies again
from the trace.

A cell is (policy weights w = (w_t, w_f, w_gd, w_gdsf, w_bel, w_cb),
per-object costs c and whole-byte sizes s, a budget of B bytes). At request
t of object i, f the requests of i so far (this one included):

  * a hit counts, and touches i;
  * a miss bills c_i (a float32 running sum in request order). If s_i > B
    it is fetched through: not admitted, nothing evicted, L unchanged.
    Else, while the bytes held plus s_i exceed B, the cached object of
    least score (ties to the earliest touch) is evicted, its size leaves
    the bytes held and, while w_gd + w_gdsf > 0, L takes its score; where
    no cached object scores below 3.4e38 the miss is fetched through. Then
    i is admitted and touched.

A touch fixes sb = ((w_t*t + w_f*f) + w_gd*(L + c/s)) + w_gdsf*(L + f*(c/s))
+ w_bel*bel, bel = -next(t), or -3.4e38 if never again. At an eviction at
step t a cached object scores sb + w_cb*cb, cb = (s*max(next - t, 1)) / -c,
or -3.4e38 if never again (c floored at 1e-30, s as float32 of its whole
bytes, c/s with s floored at 1e-30). Every operation rounds to float32 in
that order. Rows with w_cb = 0 keep a heap of scores fixed at the touch;
the others score every cached object at each eviction.
"""
from __future__ import annotations

import heapq
import math
import struct

import torch

__all__ = ["next_use", "request_counts", "replay_cell", "replay_grid",
           "BIG"]

BIG = struct.unpack("<f", struct.pack("<f", 3.4e38))[0]
_F32 = struct.Struct("<f")


def _r(x: float) -> float:
    """x rounded to float32 (one rounding of a float64 sum, product or
    quotient of two float32 values is the float32 result); past float32's
    range, an infinity of x's sign."""
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except OverflowError:
        return math.copysign(math.inf, x)


def next_use(ids) -> torch.Tensor:
    """next(t): the step of the next request of ids[t], or T if none."""
    ids = torch.as_tensor(ids).tolist()
    T = len(ids)
    seen: dict = {}
    out = [T] * T
    for t in range(T - 1, -1, -1):
        out[t] = seen.get(ids[t], T)
        seen[ids[t]] = t
    return torch.tensor(out, dtype=torch.int64)


def request_counts(ids) -> torch.Tensor:
    """f(t): the requests of ids[t] in ids[:t+1]."""
    counts: dict = {}
    out = []
    for i in torch.as_tensor(ids).tolist():
        counts[i] = counts.get(i, 0) + 1
        out.append(counts[i])
    return torch.tensor(out, dtype=torch.int64)


def _cb(t: int, nu: int, T: int, size: float, negc: float) -> float:
    if nu >= T:
        return -BIG
    gap = max(_r(float(nu) - float(t)), 1.0)
    return _r(_r(size * gap) / negc)


def replay_cell(ids, nxt, freq, costs, sizes, weights, budget: int
                ) -> tuple[float, int, int, int, int]:
    """Replay one cell. ids, nxt, freq (T,); costs (N,); sizes (N,) whole
    bytes; weights (6,). Returns (dollars, hits, victims, fetch_through,
    the misses that evicted more than one victim)."""
    f32 = torch.float32
    ids = torch.as_tensor(ids, dtype=torch.int64)
    nxt = torch.as_tensor(nxt, dtype=torch.int64)
    T = len(ids)
    w = torch.as_tensor(weights, dtype=f32)
    w_cb = float(w[5])
    c = torch.as_tensor(costs, dtype=f32)
    whole = torch.as_tensor(sizes, dtype=torch.int64)
    s = whole.to(f32)
    cos = c / torch.clamp_min(s, 1e-30)
    negc = -torch.clamp_min(c, 1e-30)
    tf = torch.arange(T, dtype=f32)
    fi = torch.as_tensor(freq).to(f32)
    never = nxt >= T
    bel = torch.where(never, torch.tensor(-BIG, dtype=f32), -nxt.to(f32))
    ab = w[0] * tf + w[1] * fi
    cos_t, wb = cos[ids], w[4] * bel
    fc_t = fi * cos_t
    gd_active = bool((w[2] + w[3]) > 0)
    # the score fixed at a touch with L = 0, for the rows where L stays 0
    sb0 = ab + w[2] * (0.0 + cos_t) + w[3] * (0.0 + fc_t) + wb
    ab_l, cos_l, fc_l, wb_l = ab.tolist(), cos_t.tolist(), fc_t.tolist(), \
        wb.tolist()
    sb0_l = sb0.tolist()
    wl = w.tolist()

    def touch_score(t: int, L: float) -> float:
        if not gd_active:
            return sb0_l[t]
        g1 = _r(wl[2] * _r(L + cos_l[t]))
        g2 = _r(wl[3] * _r(L + fc_l[t]))
        return _r(_r(_r(ab_l[t] + g1) + g2) + wb_l[t])

    if w_cb == 0.0:
        gap = torch.clamp_min(nxt.to(f32) - tf, 1.0)
        cb = torch.where(never, torch.tensor(-BIG, dtype=f32),
                         s[ids] * gap / negc[ids])
        if not bool(torch.isfinite(cb).all()):
            raise ValueError("a cost-Belady term is not finite: its score "
                             "is NaN, outside what this reference replays")
        miss, victims, fetched, multi = _heap(ids.tolist(), nxt.tolist(),
                                       whole.tolist(), s.tolist(),
                                       negc.tolist(), T, budget, w_cb,
                                       touch_score, gd_active)
    else:
        miss, victims, fetched, multi = _scan(ids.tolist(), nxt, whole, s, negc, T,
                                       budget, w_cb, touch_score, gd_active)
    total = 0.0
    for i, m in zip(ids.tolist(), miss):
        if m:
            total = _r(total + float(c[i]))
    return total, T - sum(miss), victims, fetched, multi


def _heap(ids_l, nxt_l, whole_l, size_l, negc_l, T, budget, w_cb,
          touch_score, gd_active):
    """Scores fixed at the touch: a heap of (score, touch, object), the
    entries of an object's earlier touches skipped when popped."""
    touch: dict = {}          # cached object -> its last touch
    heap: list = []
    miss = [False] * T
    held, L, victims, fetched, multi = 0, 0.0, 0, 0, 0
    for t in range(T):
        i = ids_l[t]
        if i not in touch:
            miss[t] = True
            b = whole_l[i]
            admit, before = b <= budget, victims
            while admit and held + b > budget:
                while True:
                    score, tt, v = heap[0]
                    if touch.get(v) == tt:
                        break
                    heapq.heappop(heap)
                if score != score:
                    raise ValueError("a NaN score: outside what this "
                                     "reference replays")
                vscore = _r(score + _r(w_cb * _cb(t, nxt_l[tt], T, size_l[v],
                                                  negc_l[v])))
                if not vscore < BIG:
                    admit = False
                    break
                heapq.heappop(heap)
                del touch[v]
                held -= whole_l[v]
                victims += 1
                if gd_active:
                    L = vscore
            multi += victims - before > 1
            if not admit:
                fetched += 1
                continue
            held += b
        touch[i] = t
        heapq.heappush(heap, (touch_score(t, L), t, i))
    return miss, victims, fetched, multi


def _scan(ids_l, nxt, whole, s, negc, T, budget, w_cb, touch_score,
          gd_active):
    """Scores that move with time: every cached object scored at each
    eviction, from a table of slots."""
    f32 = torch.float32
    cap = max(1, len(ids_l))
    slot_of: dict = {}
    obj_of = [-1] * cap
    free = list(range(cap - 1, -1, -1))
    live = torch.zeros(cap, dtype=torch.bool)
    sb = torch.zeros(cap, dtype=f32)
    nf = torch.zeros(cap, dtype=f32)
    gone = torch.zeros(cap, dtype=torch.bool)     # never used again
    size = torch.zeros(cap, dtype=f32)
    nc = torch.ones(cap, dtype=f32)
    touch = torch.zeros(cap, dtype=torch.int64)
    nxt_f, never = nxt.to(f32), nxt >= T
    neg_big = torch.tensor(-BIG, dtype=f32)
    big = torch.tensor(BIG, dtype=f32)
    miss = [False] * T
    held, L, victims, fetched, multi = 0, 0.0, 0, 0, 0
    whole_l = whole.tolist()
    for t in range(T):
        i = ids_l[t]
        k = slot_of.get(i)
        if k is None:
            miss[t] = True
            b = whole_l[i]
            admit, before = b <= budget, victims
            while admit and held + b > budget:
                gap = torch.clamp_min(nf - float(t), 1.0)
                cb = torch.where(gone, neg_big, size * gap / nc)
                raw = torch.where(live, sb + w_cb * cb, big)
                low = raw.min()
                if bool(torch.isnan(low)):
                    raise ValueError("a NaN score: outside what this "
                                     "reference replays")
                if not bool(low < big):
                    admit = False
                    break
                ties = torch.nonzero(live & (raw <= low)).flatten()
                v = int(ties[torch.argmin(touch[ties])])
                live[v] = False
                obj = obj_of[v]
                del slot_of[obj]
                free.append(v)
                held -= whole_l[obj]
                victims += 1
                if gd_active:
                    L = float(raw[v])
            multi += victims - before > 1
            if not admit:
                fetched += 1
                continue
            held += b
            k = free.pop()
            slot_of[i], obj_of[k] = k, i
            live[k] = True
            size[k], nc[k] = s[i], negc[i]
        touch[k] = t
        sb[k] = touch_score(t, L)
        nf[k], gone[k] = nxt_f[t], never[t]
    return miss, victims, fetched, multi


def replay_grid(ids, cost_matrix, sizes, weights, budgets):
    """Every (policy, price vector, budget) cell: dollars (Q, P, K)
    float32; hits, victims, fetch-throughs and misses that evicted more
    than one victim, (Q, P, K) int64 tensors.
    cost_matrix (P, N); sizes (N,) whole bytes; weights (Q, 6); budgets
    (K,) bytes."""
    ids = torch.as_tensor(ids, dtype=torch.int64)
    nxt, freq = next_use(ids), request_counts(ids)
    cm = torch.as_tensor(cost_matrix)
    w = torch.as_tensor(weights)
    budgets = [int(b) for b in torch.as_tensor(budgets).tolist()]
    Q, P, K = len(w), len(cm), len(budgets)
    dollars = torch.zeros((Q, P, K), dtype=torch.float32)
    counts = torch.zeros((4, Q, P, K), dtype=torch.int64)
    for q in range(Q):
        for p in range(P):
            for k, b in enumerate(budgets):
                d, *n = replay_cell(ids, nxt, freq, cm[p], sizes, w[q], b)
                dollars[q, p, k] = d
                counts[:, q, p, k] = torch.tensor(n)
    return (dollars, *counts)
