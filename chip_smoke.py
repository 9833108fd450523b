"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 1]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It builds the CUDA kernels from `src/repro_torch/kernels/csrc`,
holds each kernel against its plain PyTorch version on the card, replays the
paper's (policy x price vector x budget) grid on a 20k-request trace on the
card with kernels, on the card without, and on the CPU (the three grids must
be bit-equal), scores the dollars against the exact optimum, checks the
exact optimum's schedules through the occupancy scan, brackets the
dollar-optimum of a 200k-request variable-size CDN trace with cost-FOO
(its rounded schedule checked on the card, the bracket equal to a CPU
run's), then runs the full-size sweep (200k requests, 20k objects, 96
cells) through the kernels. It prints one JSON line per phase, the
`nvidia-smi` name and power limit, one line that lists every kernel with
its time beside its bound, and last `{"ok": true, "device": {...}}`. Any
failed check raises and exits non-zero; without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (PRICE_VECTORS, Trace, cost_foo,  # noqa: E402
                              exact_opt_uniform, exact_opt_uniform_sweep,
                              interval_deltas, miss_costs, regret, simulate,
                              sweep_torch, twemcache_like, wiki_cdn_like)
from repro_torch.core.trace import next_use_indices  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.evict_argmin import evict_argmin_cuda  # noqa: E402
from repro_torch.kernels.interval_occupancy import (  # noqa: E402
    error_chain, interval_occupancy_cuda, occupancy_feasible_cuda)
from repro_torch.kernels.next_use import (digit_passes,  # noqa: E402
                                          next_use_cuda, plan)

# the module (the package's `cost_foo` names the function)
cost_foo_module = importlib.import_module("repro_torch.core.cost_foo")

POLICIES = ["lru", "lfu", "gds", "gdsf", "belady", "cost_belady"]
PRICES = list(PRICE_VECTORS)
PARITY_BUDGETS = np.array([32, 64, 128, 256])
FULL_BUDGETS = np.array([320, 640, 1280, 2560])
SCAN_TILE = 4096   # items a block of the scan takes above 2^21 items
SCAN_T = [1, 31, 4095, 4096, 4097, 200_000, 2**24 + 3,
          # tile boundaries (2048-item tiles up to 2^21 items, 4096 above), the
          # carry tree's level-1 nodes (256 tiles) and the switch of tile size
          2 * SCAN_TILE - 1, 2 * SCAN_TILE, 2 * SCAN_TILE + 1,
          2**19 - 1, 2**19, 2**19 + 1, 2**20 - 1, 2**20, 2**20 + 1,
          2**21, 2**21 + 1, 3 * 2**20 - 1, 3 * 2**20, 3 * 2**20 + 1]
SCAN_T3 = 65536 * SCAN_TILE + SCAN_TILE + 1   # a third level in the tree
SCAN_BYTES_T = 2**26        # 256 MiB an array: far past the 50 MB L2
NU_BYTES_T, NU_BYTES_N = 2**26, 2**22   # next_use's large timing shape
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
NO_LAUNCHES = {name: 0 for name in ops.KERNELS}

KERNEL_INFO = {
    "evict_argmin": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/evict_argmin.cu",
        replaces="src/repro/kernels/evict_argmin.py:66",
        replaces_function="evict_argmin_pallas"),
    "next_use": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/next_use.cu",
        replaces="src/repro/kernels/next_use.py:55",
        replaces_function="next_use_pallas"),
    "occupancy_feasible": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/occupancy_scan.cu",
        replaces="src/repro/kernels/interval_occupancy.py:92",
        replaces_function="occupancy_feasible_pallas"),
    "interval_occupancy": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/occupancy_scan.cu",
        replaces="src/repro/kernels/interval_occupancy.py:50",
        replaces_function="interval_occupancy_pallas"),
}
TOLERANCE = {
    "evict_argmin": "exact",
    "next_use": "exact",
    "occupancy_feasible": "exact on integer-valued deltas; byte sizes: occ "
                          "within k*2^-24*sum_{q<=p}|d_q| of float64 (k from "
                          "csrc/occupancy_scan.cu), excess within that plus "
                          "one float32 rounding of occ - zcap",
}
TOLERANCE["interval_occupancy"] = TOLERANCE["occupancy_feasible"]



def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int = 50, rounds: int = 9) -> float:
    """Median over `rounds` CUDA-event windows of the time per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def argmin_inputs(rng, C, N, dtype, dev, lo=-8, hi=8, t_lo=0, t_hi=10_000,
                  shared_touch=True):
    scores = torch.tensor(rng.integers(lo, hi, (C, N)).astype(np.float32),
                          device=dev).to(dtype)
    touch = torch.tensor(rng.integers(t_lo, t_hi, N if shared_touch
                                      else (C, N)).astype(np.int32), device=dev)
    mask = torch.tensor(rng.random((C, N)) < 0.5, device=dev)
    return scores, touch, mask


def byte_deltas(rng, T: int, dtype: str) -> np.ndarray:
    """Range-adds of a schedule of byte-sized intervals (sizes up to the
    94 MB of wiki_cdn_like's largest object) in float64, cast to dtype."""
    n = max(1, T // 4)
    t = rng.integers(0, T, n)
    u = np.minimum(t + rng.geometric(1e-3, n), T)
    size = np.minimum(rng.lognormal(11.5, 2.5, n), 9.4e7)
    d = np.zeros(T)
    np.add.at(d, t, size)
    np.add.at(d, u[u < T], -size[u < T])
    if dtype == "int32":
        return np.rint(d).astype(np.int32)
    return d.astype(np.float32)


def check_scan_bound(label: str, occ: torch.Tensor, ex: torch.Tensor,
                     d: np.ndarray, z: np.ndarray) -> dict:
    """Hold the scan's occ and excess to its rounding bound against the
    float64 prefix sum of the float32 deltas. Returns the worst share of
    the bound used and the largest gap to float64."""
    d32 = np.asarray(d).astype(np.float32).astype(np.float64)
    z64 = np.asarray(z, np.float64)
    exact = np.cumsum(d32)
    bound = error_chain(len(d32)) * 2.0**-24 * np.cumsum(np.abs(d32))
    got = occ.cpu().numpy().astype(np.float64)
    err = np.abs(got - exact)
    check(bool((err <= bound).all()),
          f"occ outside its rounding bound: {label}")
    ex_gap = abs(float(ex) - float(np.max(exact - z64)))
    ex_bound = float(bound.max() + 2.0**-24 * np.abs(got - z64).max())
    check(ex_gap <= ex_bound, f"excess outside its rounding bound: {label}")
    used = np.divide(err, bound, out=np.zeros_like(err), where=bound > 0)
    return dict(bound_share=max(float(used.max()),
                                ex_gap / ex_bound if ex_bound > 0 else 0.0),
                max_abs_err_vs_f64=max(float(err.max()), ex_gap))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def scan_checks(rng, dev, errs: dict, cases: list) -> dict:
    """Both scans at every T of SCAN_T with float32 and int32 deltas:
    bit-equal to the plain versions on integer-valued deltas (every partial
    sum exact); within the rounding bound on byte sizes, with two runs
    giving equal bits."""
    worst = {"bound_share": 0.0, "max_abs_err_vs_f64": 0.0}
    for T in SCAN_T:
        for dtype in ("float32", "int32"):
            tdt = torch.float32 if dtype == "float32" else torch.int32
            d = torch.tensor(rng.integers(-3, 4, T), device=dev).to(tdt)
            z = torch.tensor(rng.integers(0, 8, T).astype(np.float32),
                             device=dev)
            occ, ex = occupancy_feasible_cuda(d, z)
            scan = interval_occupancy_cuda(d)
            w_occ, w_ex = ref.occupancy_feasible_ref(d, z)
            torch.cuda.synchronize()
            label = f"scan T={T} {dtype}"
            check(torch.equal(occ, w_occ) and torch.equal(ex, w_ex),
                  f"occupancy_feasible differs from plain: {label}")
            check(torch.equal(scan, w_occ),
                  f"interval_occupancy differs from plain: {label}")
            errs["occupancy_feasible"] = max(
                errs["occupancy_feasible"], float((occ - w_occ).abs().max()),
                abs(float(ex - w_ex)))
            errs["interval_occupancy"] = max(
                errs["interval_occupancy"], float((scan - w_occ).abs().max()))
            cases.append(f"{label} integer deltas")

            d_np = byte_deltas(rng, T, dtype)
            z_np = (np.cumsum(d_np.astype(np.float32).astype(np.float64))
                    + rng.normal(0, 1e6, T)).astype(np.float32)
            d_t = torch.tensor(d_np, device=dev)
            z_t = torch.tensor(z_np, device=dev)
            occ, ex = occupancy_feasible_cuda(d_t, z_t)
            occ2, ex2 = occupancy_feasible_cuda(d_t, z_t)
            scan = interval_occupancy_cuda(d_t)
            torch.cuda.synchronize()
            check(same_bits(occ, occ2) and same_bits(ex, ex2),
                  f"two runs differ: {label} byte sizes")
            check(same_bits(scan, occ),
                  f"the two scans differ: {label} byte sizes")
            r = check_scan_bound(f"{label} byte sizes", occ, ex, d_np, z_np)
            worst = {k: max(worst[k], r[k]) for k in worst}
            cases.append(f"{label} byte sizes")
    return worst


def scan_deep_checks(rng, dev, errs: dict, cases: list) -> None:
    """50 repeated calls on byte sizes give equal bits (the race check:
    carries have a fixed association); past 2^28 items the tree's third
    level is formed and read; k of the rounding bound is no larger than
    the replaced design's at any size."""
    T = 2**24 + 3
    d = torch.tensor(byte_deltas(rng, T, "float32"), device=dev)
    z = torch.tensor(rng.normal(0, 1e9, T).astype(np.float32), device=dev)
    occ, ex = occupancy_feasible_cuda(d, z)
    scan = interval_occupancy_cuda(d)
    for _ in range(50):
        o2, e2 = occupancy_feasible_cuda(d, z)
        s2 = interval_occupancy_cuda(d)
        check(same_bits(o2, occ) and same_bits(e2, ex) and same_bits(s2, scan),
              "two runs differ: 50 repeats at T=2^24+3 byte sizes")
    check(same_bits(scan, occ), "the two scans differ: 50 repeats")
    cases.append("scan 50 repeats T=2^24+3 byte sizes, equal bits")
    del d, z, occ, scan, o2, s2

    gen = torch.Generator(device=dev).manual_seed(5)
    d = torch.randint(-3, 4, (SCAN_T3,), generator=gen, device=dev,
                      dtype=torch.int32)
    z = torch.randint(0, 8, (SCAN_T3,), generator=gen, device=dev,
                      dtype=torch.int32).float()
    occ, ex = occupancy_feasible_cuda(d, z)
    w_occ, w_ex = ref.occupancy_feasible_ref(d, z)
    scan = interval_occupancy_cuda(d.float())
    torch.cuda.synchronize()
    check(torch.equal(occ, w_occ) and torch.equal(ex, w_ex),
          f"occupancy_feasible differs from plain: T={SCAN_T3}")
    check(torch.equal(scan, w_occ),
          f"interval_occupancy differs from plain: T={SCAN_T3}")
    errs["occupancy_feasible"] = max(errs["occupancy_feasible"],
                                     float((occ - w_occ).abs().max()))
    errs["interval_occupancy"] = max(errs["interval_occupancy"],
                                     float((scan - w_occ).abs().max()))
    cases.append(f"scan T={SCAN_T3} (three tree levels) integer deltas")
    del d, z, occ, w_occ, scan
    torch.cuda.empty_cache()

    for T in SCAN_T + [SCAN_BYTES_T]:
        tiles = -(-T // SCAN_TILE)
        check(error_chain(T) <= 2 * -(-tiles // 1024) + 36,
              f"rounding bound looser than the replaced design's at T={T}")
    cases.append("error_chain(T) <= 2*ceil(tiles/1024) + 36 at every T")


def slice_ends(N: int, row: int, cluster: int = 8) -> list:
    """Index of the last entry of each cluster rank's slice of 16-entry mask
    words in row `row` of a (C, N) mask with an aligned base (the split of
    csrc/evict_argmin.cu)."""
    head = min(N, (16 - (row * N) % 16) % 16)
    words = (N - head) // 16
    return [head + 16 * (words * (r + 1) // cluster) - 1
            for r in range(cluster)
            if words * (r + 1) // cluster > words * r // cluster]


def uniform_ids(seed: int, T: int, N: int, dev) -> torch.Tensor:
    """(T,) int32 ids uniform in [0, N) from a seeded generator on the card:
    no locality at all, the radix sort's worst case."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, N, (T,), generator=gen, device=dev,
                         dtype=torch.int32)


NU_PATHS = ("one_wave", "direct", "grouped")


def next_use_on_path(path: str, ids: torch.Tensor, n: int) -> torch.Tensor:
    """next_use_cuda with its plan forced to `path` (one_wave only where the
    card holds every tile at once): times the paths the plan does not pick
    at this T. Counts no launch."""
    nu_module = importlib.import_module("repro_torch.kernels.next_use")
    chosen, launches = nu_module.plan, next_use_cuda.launches
    T = ids.numel()

    def forced(T_, N_, one_wave_items=0):
        p = chosen(T_, N_, T_ if path == "one_wave" else 0)
        if path != "one_wave" and p["path"] != path:
            limit = T_ if path == "direct" else T_ - 1
            saved = nu_module.PARTITION_T
            nu_module.PARTITION_T = limit
            try:
                p = chosen(T_, N_, 0)
            finally:
                nu_module.PARTITION_T = saved
        return p

    nu_module.plan = forced
    try:
        out = next_use_cuda(ids, n)
    finally:
        nu_module.plan = chosen
        next_use_cuda.launches = launches
    check(T == 0 or forced(T, n)["path"] == path, f"not forced to {path}")
    return out


def next_use_checks(seed: int, rng, dev, errs: dict, cases: list) -> dict:
    """next_use on the card equal to its plain version on the card and to
    the host's next_use_indices, on inputs the radix design can get wrong:
    every pass count (1 to 4, from the largest id), ids far below N, sorted
    ids, the tile edges, each path at and past its limits (one wave, direct,
    grouped), a ragged tile past 2^24, the full trace's Zipf ids, the 2^26
    timing shape, and a big call, a small one and a big one again on one
    stream (no state leaks between calls). Returns each case's plan."""
    one_wave = _build.library().next_use_one_wave_items()
    tile = plan(1000, 300)["tile_items"]        # the tile below 2^20 items
    full = twemcache_like(n_objects=20000, n_requests=200_000, seed=seed)
    few = rng.integers(0, 5000, 100_000)
    inputs = [
        ("T=200000 N=20000", rng.integers(0, 20_000, 200_000), 20_000),
        ("T=1 N=1", np.zeros(1), 1),
        ("single id (one pass)", np.zeros(70_001), 1),
        ("50000 distinct ids", rng.permutation(50_000), 50_000),
        ("N=2^30, every id < 1000", rng.integers(0, 1000, 200_000), 2**30),
        ("ids sorted ascending", np.sort(few), 5000),
        ("ids sorted descending", np.sort(few)[::-1], 5000),
        ("the full trace's Zipf ids", full.ids, full.num_objects),
    ]
    for top in (255, 256, 65_535, 65_536, 2**24):
        ids = rng.integers(0, top + 1, 100_000)
        ids[rng.integers(0, 100_000)] = top
        inputs.append((f"max id {top}", ids, top + 1))
    for T in (tile - 1, tile, tile + 1, 2 * tile + 1, 2**24 + 3):
        N = 300 if T < 2**24 else 2**20
        inputs.append((f"T={T}", rng.integers(0, N, T), N))
    for label, T in [("one-wave limit", one_wave),
                     ("one past the one-wave limit (direct)", one_wave + 1),
                     ("2^22, the direct limit", 2**22),
                     ("2^22 + 1 (grouped)", 2**22 + 1)]:
        inputs.append((f"T={T}, {label}", rng.integers(0, 2**20, T), 2**20))
    plans = {}

    def one(label, ids_t, N, want=None):
        got = next_use_cuda(ids_t, N)
        plain = ref.next_use_ref(ids_t, N)
        torch.cuda.synchronize()
        if want is None:
            want = next_use_indices(ids_t.cpu().numpy(), N)
        check(torch.equal(got, plain), f"next_use differs from plain: {label}")
        check(np.array_equal(got.cpu().numpy(), want),
              f"next_use differs from next_use_indices: {label}")
        errs["next_use"] = max(errs["next_use"],
                               float((got - plain).abs().max()))
        p = plan(ids_t.numel(), N, one_wave)
        plans[label] = dict(T=ids_t.numel(), N=N, path=p["path"],
                            tile=p["tile_items"],
                            passes=digit_passes(int(ids_t.max())))
        cases.append(f"next_use {label}")
        return got

    for label, ids, N in inputs:
        one(label, torch.tensor(np.ascontiguousarray(ids, np.int32),
                                device=dev), N)
    big = uniform_ids(seed, NU_BYTES_T, NU_BYTES_N, dev)
    first = one("T=2^26 N=2^22 uniform (timing shape)", big, NU_BYTES_N)
    small = torch.tensor(rng.integers(0, 7, 1000).astype(np.int32), device=dev)
    one("small call between two big ones", small, 7)
    again = next_use_cuda(big, NU_BYTES_N)
    torch.cuda.synchronize()
    check(torch.equal(again, first), "next_use: a big call after a small one "
          "differs from the first big call")
    cases.append("next_use big, small, big on one stream: equal")
    del big, first, again
    torch.cuda.empty_cache()
    return plans


def phase_kernel_checks(seed: int, dev) -> dict:
    rng = np.random.default_rng(seed)
    errs = {name: 0.0 for name in ops.KERNELS}
    cases = []

    def argmin_case(label, scores, touch, mask):
        gi, gv = evict_argmin_cuda(scores, touch, mask)
        wi, wv = ref.evict_argmin_ref(scores, touch, mask)
        torch.cuda.synchronize()
        check(torch.equal(gi, wi), f"evict_argmin index differs: {label}")
        check(torch.equal(gv, wv), f"evict_argmin score differs: {label}")
        errs["evict_argmin"] = max(errs["evict_argmin"],
                                   float((gv - wv).abs().max()),
                                   float((gi - wi).abs().max()))
        cases.append(label)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        s, t, m = argmin_inputs(rng, 96, 20000, dtype, dev)
        argmin_case(f"C=96 N=20000 {name} shared touch", s, t, m)
        s, t, m = argmin_inputs(rng, 96, 20000, dtype, dev,
                                shared_touch=False)
        argmin_case(f"C=96 N=20000 {name} per-row touch", s, t, m)
        s = torch.tensor(rng.standard_normal((96, 20000)).astype(np.float32),
                         device=dev).to(dtype)
        argmin_case(f"C=96 N=20000 {name} normal scores", s, t, m)
    s, t, m = argmin_inputs(rng, 8, 5000, torch.float32, dev)
    argmin_case("all-tied rows", torch.zeros_like(s), torch.zeros_like(t),
                torch.ones_like(m))
    m[:4] = False
    argmin_case("empty rows", s, t, m)
    s, t, m = argmin_inputs(rng, 16, 1, torch.float32, dev)
    argmin_case("N=1", s, t, m)
    s, t, m = argmin_inputs(rng, 5, 20001, torch.float32, dev)
    argmin_case("N=20001, not a multiple of the block", s, t, m)
    s, t, m = argmin_inputs(rng, 12, 3000, torch.float32, dev, lo=0, hi=2,
                            t_lo=2**31 - 64, t_hi=2**31 - 1,
                            shared_touch=False)
    argmin_case("touch near 2^31", s, t, m)
    s1, t1, m1 = s[3].contiguous(), t[3].contiguous(), m[3].contiguous()
    argmin_case("1-D vector", s1, t1, m1)
    for N in (1, 15, 16, 17, 20001):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for shared in (True, False):
                s, t, m = argmin_inputs(rng, 9, N, dtype, dev, t_hi=50,
                                        shared_touch=shared)
                m[0] = False                      # an empty row
                m[1] = False
                m[1, N // 2] = True               # one cached entry
                argmin_case(f"N={N} {name} {'shared' if shared else 'per-row'}"
                            " touch, an empty row, a one-entry row", s, t, m)
    for N in (20000, 20001):
        C = 16
        s = rng.integers(1, 8, (C, N)).astype(np.float32)
        for r in range(C):
            ends = slice_ends(N, r)
            s[r, ends[r % len(ends)]] = -1.0
        argmin_case(f"N={N} winner in the last entry of rank r%8's slice",
                    torch.tensor(s, device=dev),
                    torch.zeros(N, dtype=torch.int32, device=dev),
                    torch.ones(C, N, dtype=torch.bool, device=dev))
    s = torch.full((3, 4099), float("inf"), device=dev)
    m = torch.zeros(3, 4099, dtype=torch.bool, device=dev)
    m[0, 4000], m[1, 17], m[2, 9] = True, True, True
    s[1, 17], s[2, 9] = 3.4e38, 1.0
    argmin_case("cached scores at or above 3.4e38 (dense rescan)", s,
                torch.arange(4099, 0, -1, dtype=torch.int32, device=dev), m)

    nu_plans = next_use_checks(seed, rng, dev, errs, cases)
    scan_bytes = scan_checks(rng, dev, errs, cases)
    scan_deep_checks(rng, dev, errs, cases)
    emit("kernel_checks", cases=cases, max_abs_err=errs,
         scan_byte_sizes=scan_bytes,
         scan_error_chain={T: error_chain(T) for T in SCAN_T},
         next_use_plans=nu_plans)
    return errs


def price_matrix(tr: Trace) -> np.ndarray:
    return np.stack([miss_costs(tr.sizes, PRICE_VECTORS[p]) for p in PRICES])


def phase_replay_parity(seed: int) -> tuple[Trace, np.ndarray, np.ndarray]:
    tr = twemcache_like(n_objects=2000, n_requests=20000, seed=seed)
    cm = price_matrix(tr)
    kw = dict(num_objects=tr.num_objects, sizes=tr.sizes)
    grids, secs = {}, {}
    for label, extra in [("cuda_kernel", dict(device="cuda")),
                         ("cuda_plain", dict(device="cuda", use_kernel=False)),
                         ("cpu", dict(device="cpu"))]:
        prof = {}
        grids[label] = sweep_torch(POLICIES, tr.ids, cm, PARITY_BUDGETS,
                                   profile=prof, **kw, **extra)
        secs[label] = prof["execute_s"]
    ref_grid = grids["cpu"]
    check(ref_grid.shape == (6, 4, 4) and np.isfinite(ref_grid).all(),
          "replay grid has the wrong shape or non-finite dollars")
    for label in ("cuda_kernel", "cuda_plain"):
        check(np.array_equal(grids[label], ref_grid),
              f"{label} grid differs from the CPU grid: max gap "
              f"{float(np.abs(grids[label] - ref_grid).max())}")
    emit("replay_parity", trace="twemcache_like", n_objects=tr.num_objects,
         n_requests=tr.num_requests, grid=list(ref_grid.shape),
         bit_equal=True, execute_s=secs)
    return tr, cm, ref_grid


def phase_regret(tr: Trace, cm: np.ndarray, grid: np.ndarray) -> None:
    table = {}
    for p, price in enumerate(PRICES):
        opt = exact_opt_uniform_sweep(tr.ids, cm[p], PARITY_BUDGETS).dollars
        for q, pol in enumerate(POLICIES):
            for k, B in enumerate(PARITY_BUDGETS):
                check(opt[k] <= grid[q, p, k] * (1 + 1e-5),
                      f"OPT above {pol} at {price}, B={B}: "
                      f"{opt[k]} > {grid[q, p, k]}")
                table[f"{pol}|{price}|B={int(B)}"] = regret(
                    float(grid[q, p, k]), float(opt[k]))
        table[f"opt_dollars|{price}"] = [float(x) for x in opt]
    emit("regret", budgets=PARITY_BUDGETS.tolist(), regret=table)


def phase_opt_occupancy(tr: Trace, cm: np.ndarray, dev) -> dict:
    """interval_occupancy's path: the exact optimum's schedule on the parity
    trace (s3_internet) at each parity budget, turned into deltas and
    scanned on the card, never holds more than B - 1 pages between
    requests (the requested page takes the last slot)."""
    costs = cm[PRICES.index("s3_internet")]
    T = tr.num_requests
    schedules = []
    for B in PARITY_BUDGETS:
        r = exact_opt_uniform(tr.ids, costs, int(B), return_selected=True)
        t = np.array([iv.t for iv in r.selected], np.int64)
        u = np.array([iv.u for iv in r.selected], np.int64)
        deltas = np.zeros(T, np.float32)
        np.add.at(deltas, t + 1, 1.0)
        np.add.at(deltas, u[u < T], -1.0)
        schedules.append((int(B), len(r.selected),
                          torch.tensor(deltas, device=dev)))
    ops.reset_launch_counts()
    occs = [ops.interval_occupancy(d) for _, _, d in schedules]
    peaks = [float(o.max()) for o in occs]
    launches = ops.launch_counts()
    check(launches == {**NO_LAUNCHES,
                       "interval_occupancy": len(PARITY_BUDGETS)},
          f"opt_occupancy launches {launches}")
    for (B, _, d), occ, peak in zip(schedules, occs, peaks):
        check(torch.equal(occ, ref.interval_occupancy_ref(d)),
              f"interval_occupancy differs from plain at B={B}")
        check(peak <= B - 1, f"OPT schedule holds {peak} pages at B={B}")
    emit("opt_occupancy", trace="twemcache_like", price="s3_internet",
         n_requests=T, budgets=PARITY_BUDGETS.tolist(),
         selected_intervals=[n for _, n, _ in schedules], peak_pages=peaks,
         launches=launches)
    return launches


def phase_costfoo_cdn(seed: int, dev) -> dict:
    """cost-FOO's bracket on the CDN configuration of
    benchmarks/bench_costfoo.py (`cdn_vs_prepr`), its rounded schedule
    checked on the card through occupancy_feasible, against the same run
    with the check on the CPU. The check's arguments are captured from the
    card run: they feed the infeasible-schedule check and the kernel line's
    timing at the path's shape."""
    tr = wiki_cdn_like(n_objects=60_000, n_requests=200_000, seed=seed)
    costs = miss_costs(tr.sizes, PRICE_VECTORS["gcs_internet"])
    B = float(np.quantile(tr.sizes, 0.9) * 400)
    kw = dict(policies=("gdsf",), validate=True)
    original = cost_foo_module._validate_schedule
    seen = {}

    def timed_check(*args):
        t0 = time.perf_counter()
        original(*args)
        seen.update(args=args, seconds=time.perf_counter() - t0)

    cost_foo_module._validate_schedule = timed_check
    try:
        ops.reset_launch_counts()
        card = cost_foo(tr, costs, B, device="cuda", **kw)
        launches = ops.launch_counts()
    finally:
        cost_foo_module._validate_schedule = original
    host = cost_foo(tr, costs, B, device="cpu", **kw)
    check(launches == {**NO_LAUNCHES, "occupancy_feasible": 1},
          f"costfoo_cdn launches {launches}, expected occupancy_feasible=1")
    check((card.lower, card.upper, card.bracket)
          == (host.lower, host.upper, host.bracket),
          f"card bracket {card.lower, card.upper} != CPU bracket "
          f"{host.lower, host.upper}")
    check(card.lower <= card.upper, "cost-FOO lower above upper")
    check(np.isfinite([card.lower, card.upper, card.bracket]).all(),
          "cost-FOO bracket not finite")

    pt, pu, pz, accepted, zcap, T, B_, use_kernel, dev_ = seen["args"]
    acc = np.asarray(accepted, np.int64)
    deltas = interval_deltas(pt[acc], pu[acc], pz[acc], T)
    d32, z32 = deltas.astype(np.float32), np.asarray(zcap).astype(np.float32)
    d_t, z_t = torch.tensor(d32, device=dev), torch.tensor(z32, device=dev)
    occ, ex = ops.occupancy_feasible(d_t, z_t)
    _, ex_plain = ref.occupancy_feasible_ref(d_t, z_t)
    _, ex_cpu = ops.occupancy_feasible(torch.tensor(d32), torch.tensor(z32))
    on_path = check_scan_bound("costfoo_cdn schedule", occ, ex, d32, z32)
    tol = max(cost_foo_module._round_tol(B_), 1e-4 * max(1.0, B_))

    occ64 = np.cumsum(deltas)
    p = int(np.argmax(occ64[1:] - zcap[1:])) + 1
    bad = np.array(zcap, np.float64)
    bad[p] = occ64[p] - float(pz[acc].max())
    try:
        original(pt, pu, pz, accepted, bad, T, B_, use_kernel, dev_)
    except AssertionError as e:
        refused = str(e)
        check("exceeds zcap" in refused, f"unexpected refusal: {refused}")
    else:
        raise AssertionError("an infeasible schedule passed the check on "
                             "the card")
    emit("costfoo_cdn", trace="wiki_cdn_like", n_objects=tr.num_objects,
         n_requests=T, price="gcs_internet", budget_bytes=B_,
         policies=list(kw["policies"]), lower=card.lower, upper=card.upper,
         bracket=card.bracket, bracket_equal_cpu=True,
         profile_card=card.profile, profile_cpu=host.profile,
         check_seconds_card=seen["seconds"], launches=launches,
         accepted_intervals=len(accepted), excess_card=float(ex),
         excess_plain_card=float(ex_plain), excess_cpu=float(ex_cpu),
         tolerance=tol, scan_vs_float64=on_path, infeasible_refused=refused)
    return dict(launches=launches, deltas=d32, zcap=z32)


def phase_replay_full(seed: int) -> dict:
    tr = twemcache_like(n_objects=20000, n_requests=200_000, seed=seed)
    cm = price_matrix(tr)
    T = tr.num_requests
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    prof = {}
    dollars, hits = sweep_torch(POLICIES, tr.ids, cm, FULL_BUDGETS,
                                num_objects=tr.num_objects, sizes=tr.sizes,
                                profile=prof, return_hits=True)
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches == {**NO_LAUNCHES, "evict_argmin": T, "next_use": 1},
          f"main path launches {launches}, expected evict_argmin={T}, "
          "next_use=1 and no scan")
    check(dollars.shape == (6, 4, 4) and np.isfinite(dollars).all(),
          "full grid has the wrong shape or non-finite dollars")
    p, k = PRICES.index("s3_internet"), 1
    B = int(FULL_BUDGETS[k])
    pages = Trace(ids=tr.ids, sizes=np.ones(tr.num_objects))
    host = {}
    for pol in ("lru", "belady"):
        r = simulate(pol, pages, cm[p], float(B))
        q = POLICIES.index(pol)
        check(int(hits[q, p, k]) == r.hits,
              f"{pol} hits {int(hits[q, p, k])} != host {r.hits} "
              f"(s3_internet, B={B})")
        host[pol] = dict(hits=r.hits, dollars=r.dollars,
                         rel_dollar_gap=float(dollars[q, p, k]) / r.dollars - 1)
    steps_per_s = T / prof["execute_s"]
    emit("replay_full", trace="twemcache_like", n_objects=tr.num_objects,
         n_requests=T, cells=prof["cells"], budgets=FULL_BUDGETS.tolist(),
         compile_s=prof["compile_s"], execute_s=prof["execute_s"],
         steps_per_s=steps_per_s, cell_steps_per_s=steps_per_s * prof["cells"],
         launches=launches, peak_device_gib=peak_gib,
         host_check_s3_internet_B640=host)
    return dict(launches=launches, trace=tr, execute_s=prof["execute_s"])


def phase_replay_profile(tr: Trace, full_execute_s: float,
                         steps: int = 400) -> None:
    """Where a step's time goes at full width: a torch.profiler trace of the
    sweep over the trace's first `steps` requests (all 96 cells, all
    objects). Device time per step is set against the unprofiled step time
    of `replay_full` to give the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cm = price_matrix(tr)
    kw = dict(num_objects=tr.num_objects, sizes=tr.sizes)
    sweep_torch(POLICIES, tr.ids[:50], cm, FULL_BUDGETS, **kw)   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_torch(POLICIES, tr.ids[:steps], cm, FULL_BUDGETS, **kw)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / steps
    step_ms = full_execute_s / tr.num_requests * 1e3

    def top(evs, key, n):
        evs = sorted(evs, key=key, reverse=True)[:n]
        return [[e.key, e.count / steps, key(e) / steps] for e in evs]

    emit("replay_profile", steps=steps, profiled_wall_ms_per_step=wall / steps
         * 1e3, unprofiled_ms_per_step=step_ms,
         device_ms_per_step=device_ms if on_card else "not measured",
         device_busy_share=device_ms / step_ms if on_card else "not measured",
         device_events_per_step=sum(e.count for e in on_card) / steps,
         top_device_us_per_step=top(on_card, lambda e: e.self_device_time_total,
                                    8),
         top_host_us_per_step=top(on_host, lambda e: e.self_cpu_time_total, 10))


def device_time(fn, reps: int = 20) -> dict:
    """Device time per call of the kernels `fn` launches, in all and by
    kernel name, from a torch.profiler trace of `reps` calls ("not
    measured" if the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").strip()
            by_name[name] = by_name.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / reps
    if not by_name:
        return dict(ms="not measured", kernels={})
    return dict(ms=sum(by_name.values()), kernels=by_name)


def phase_kernels(seed: int, dev, errs: dict, launches: dict,
                  tr: Trace, schedule: dict) -> None:
    """Time each kernel at the main path's shapes beside its plain version
    and its bound.

    `ms`, `plain_ms` and `library_ms` are CUDA-event windows over
    back-to-back calls (what a caller sees, host work between launches
    included); `device_ms`, `plain_device_ms` and `library_device_ms` are
    the profiler's device time per call, and `device_kernels` splits the
    kernel's by device kernel. evict_argmin gets the replay's steady
    state: 96 cell rows of the full trace's objects, each row with as many
    cached entries as its cell's budget less one (the requested object is
    masked out), one shared touch row. Its bound counts what that data
    needs: every mask byte, the score of each cached entry, the touch row
    and the outputs. Inputs are warm in L2, as in the replay, where the op
    just before wrote the scores. next_use reads each id once and writes
    each result once (8*T bytes); it runs on replay_full's trace, on 2^22
    uniform ids over 2^20 objects and on 2^26 over 2^22 (256 MiB an array,
    cold) -- one shape for each of its paths -- beside
    `sort_only_device_ms`, a stable torch.sort of the same ids, and its
    other paths forced. The scans
    run on cost-FOO's CDN schedule (T = 200,000 float32 deltas and caps,
    2.4 MB, warm in L2) and again at T = 2^26
    (256 MiB an array, cold), where bytes and not launches should set the
    time; their bound is 12*T bytes (deltas, zcap, occ) for
    occupancy_feasible and 8*T for interval_occupancy."""
    rng = np.random.default_rng(seed + 1)
    C, N = len(POLICIES) * len(PRICES) * len(FULL_BUDGETS), tr.num_objects
    s = torch.tensor(rng.standard_normal((C, N)).astype(np.float32),
                     device=dev)
    t = torch.tensor(rng.integers(0, tr.num_requests, N).astype(np.int32),
                     device=dev)
    cached = np.zeros((C, N), bool)
    for c in range(C):   # cell c = (q*P + p)*K + k has budget FULL_BUDGETS[k]
        budget = int(FULL_BUDGETS[c % len(FULL_BUDGETS)])
        cached[c, rng.choice(N, budget - 1, replace=False)] = True
    m = torch.tensor(cached, device=dev)
    argmin_bytes = m.numel() + int(cached.sum()) * 4 + N * 4 + C * (4 + 4)
    ids_t = torch.tensor(tr.ids.astype(np.int32), device=dev)
    ids26 = uniform_ids(seed, NU_BYTES_T, NU_BYTES_N, dev)
    dense_bytes = {"evict_argmin": C * N * (4 + 4 + 1)}
    d200 = torch.tensor(schedule["deltas"], device=dev)
    z200 = torch.tensor(schedule["zcap"], device=dev)
    T200 = d200.numel()
    gen = torch.Generator(device=dev).manual_seed(seed)
    d26 = torch.randint(-3, 4, (SCAN_BYTES_T,), generator=gen, device=dev,
                        dtype=torch.int32).float()
    z26 = torch.randint(0, 8, (SCAN_BYTES_T,), generator=gen, device=dev,
                        dtype=torch.int32).float()
    cases = [
        ("evict_argmin", lambda: evict_argmin_cuda(s, t, m),
         lambda: ref.evict_argmin_ref(s, t, m), None, argmin_bytes, 50,
         dict(C=C, N=N, dtype="float32", touch="shared (N,)",
              cached_per_row=[int(b) - 1 for b in FULL_BUDGETS])),
    ]
    one_wave = _build.library().next_use_one_wave_items()
    ids22 = uniform_ids(seed, 2**22, 2**20, dev)
    for x, n, label in [(ids_t, N, "replay_full's trace (Zipf)"),
                        (ids22, 2**20, "uniform, the direct path's limit"),
                        (ids26, NU_BYTES_N, "uniform, cold")]:
        cases.append(("next_use", lambda x=x, n=n: next_use_cuda(x, n),
                      lambda x=x, n=n: ref.next_use_ref(x, n), None,
                      8 * x.numel(), 5,
                      dict(T=x.numel(), N=n, data=label,
                           path=plan(x.numel(), n, one_wave)["path"]),
                      dict(sort=lambda x=x: torch.sort(x, stable=True),
                           paths={other: (lambda x=x, n=n, o=other:
                                          next_use_on_path(o, x, n))
                                  for other in NU_PATHS
                                  if other != plan(x.numel(), n,
                                                   one_wave)["path"]
                                  and (other != "one_wave"
                                       or x.numel() <= one_wave)})))
    for d, z, label in [(d200, z200, "cost-FOO CDN schedule, warm in L2"),
                        (d26, z26, "2^26 integer deltas, cold")]:
        n = d.numel()
        cases += [
            ("occupancy_feasible",
             lambda d=d, z=z: occupancy_feasible_cuda(d, z),
             lambda d=d, z=z: ref.occupancy_feasible_ref(d, z), None,
             12 * n, 50, dict(T=n, dtype="float32", data=label)),
            ("interval_occupancy", lambda d=d: interval_occupancy_cuda(d),
             lambda d=d: ref.interval_occupancy_ref(d),
             lambda d=d: torch.cumsum(d, 0), 8 * n, 50,
             dict(T=n, dtype="float32", data=label)),
        ]
    rows = []
    for name, kernel, plain, library, nbytes, reps, shape, *more in cases:
        yardsticks = more[0] if more else {}
        ms = time_ms(kernel, reps=reps)
        plain_ms = time_ms(plain, reps=reps)
        library_ms = time_ms(library, reps=reps) if library else None
        on_card = device_time(kernel)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        extra = {}
        if yardsticks:
            extra = dict(
                sort_only_device_ms=device_time(yardsticks["sort"])["ms"],
                sort_only_note="torch.sort(ids, stable=True) alone: one part "
                               "of the work (no successor, no write of "
                               "next(t)), timed as a yardstick; the port "
                               "never calls it",
                other_paths_device_ms={
                    other: device_time(fn)["ms"]
                    for other, fn in yardsticks["paths"].items()},
                other_paths_note="the same call forced down the kernel's "
                                 "other paths, which plan() picks at other "
                                 "T")
        rows.append(dict(
            name=name, **KERNEL_INFO[name], launches=launches[name],
            max_abs_err=errs[name], tolerance=TOLERANCE[name], ms=ms,
            plain_ms=plain_ms, device_ms=on_card["ms"],
            device_kernels=on_card["kernels"],
            plain_device_ms=device_time(plain)["ms"],
            library_device_ms=device_time(library)["ms"] if library else None,
            bound_ms=bound_ms, bound_by="bytes",
            bound_share=(bound_ms / on_card["ms"] if on_card["kernels"]
                         else "not measured"),
            bound_note=f"{nbytes} bytes this data needs over 3.35 TB/s",
            dense_bound_ms=dense_bytes.get(name, nbytes) / HBM_BYTES_PER_S
            * 1e3,
            dense_bound_note=("every score, touch and mask byte of each row "
                              "read" if name == "evict_argmin" else
                              "same as bound_ms"),
            library_ms=library_ms,
            library_call="torch.cumsum" if library else None, shape=shape,
            **extra))
    del d26, z26, ids22, ids26
    print(json.dumps({"kernels": rows}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_flags=list(_build.NVCC_FLAGS))
    errs = phase_kernel_checks(args.seed, dev)
    tr, cm, grid = phase_replay_parity(args.seed)
    phase_regret(tr, cm, grid)
    opt_launches = phase_opt_occupancy(tr, cm, dev)
    cdn = phase_costfoo_cdn(args.seed, dev)
    full = phase_replay_full(args.seed)
    phase_replay_profile(full["trace"], full["execute_s"])
    # each kernel's launches on its own path, counted from 0 around it
    launches = {"evict_argmin": full["launches"]["evict_argmin"],
                "next_use": full["launches"]["next_use"],
                "interval_occupancy": opt_launches["interval_occupancy"],
                "occupancy_feasible": cdn["launches"]["occupancy_feasible"]}
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on its path: {launches}")
    phase_kernels(args.seed, dev, errs, launches, full["trace"], cdn)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
