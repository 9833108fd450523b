"""Drive the PyTorch port's replay sweep on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 1]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It builds the CUDA kernels from `src/repro_torch/kernels/csrc`,
holds each kernel against its plain PyTorch version on the card, replays the
paper's (policy x price vector x budget) grid on a 20k-request trace on the
card with kernels, on the card without, and on the CPU (the three grids must
be bit-equal), scores the dollars against the exact optimum, then runs the
full-size sweep (200k requests, 20k objects, 96 cells) through the kernels.
It prints one JSON line per phase, the `nvidia-smi` name and power limit,
one line that lists every kernel with its time beside its bound, and last
`{"ok": true, "device": {...}}`. Any failed check raises and exits non-zero;
without a CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
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

from repro_torch.core import (PRICE_VECTORS, Trace, exact_opt_uniform_sweep,  # noqa: E402
                              miss_costs, regret, simulate, sweep_torch,
                              twemcache_like)
from repro_torch.core.trace import next_use_indices  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.evict_argmin import evict_argmin_cuda  # noqa: E402
from repro_torch.kernels.next_use import (next_use_cuda,  # noqa: E402
                                          shared_table_entries)

POLICIES = ["lru", "lfu", "gds", "gdsf", "belady", "cost_belady"]
PRICES = list(PRICE_VECTORS)
PARITY_BUDGETS = np.array([32, 64, 128, 256])
FULL_BUDGETS = np.array([320, 640, 1280, 2560])
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)

KERNEL_INFO = {
    "evict_argmin": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/evict_argmin.cu",
        replaces="src/repro/kernels/evict_argmin.py:66",
        replaces_function="evict_argmin_pallas"),
    "next_use": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/next_use.cu",
        replaces="src/repro/kernels/next_use.py:55",
        replaces_function="next_use_pallas"),
}


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


def phase_kernel_checks(seed: int, dev) -> dict:
    rng = np.random.default_rng(seed)
    errs = {"evict_argmin": 0.0, "next_use": 0.0}
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

    limit = shared_table_entries()
    for label, T, N, ids in [
        ("T=200000 N=20000", 200_000, 20_000, None),
        ("T=1 N=1", 1, 1, None),
        ("single id", 70_001, 1, None),
        ("all ids distinct", 50_000, 50_000, rng.permutation(50_000)),
        ("N above the shared-memory table", 200_000, 4 * limit, None),
        ("ragged last chunk", 1_000_003, 997, None),
    ]:
        if ids is None:
            ids = rng.integers(0, N, T)
        ids = ids.astype(np.int32)
        ids_t = torch.tensor(ids, device=dev)
        got = next_use_cuda(ids_t, N)
        plain = ref.next_use_ref(ids_t, N)
        torch.cuda.synchronize()
        want = next_use_indices(ids, N)
        check(torch.equal(got, plain), f"next_use differs from plain: {label}")
        check(np.array_equal(got.cpu().numpy(), want),
              f"next_use differs from next_use_indices: {label}")
        errs["next_use"] = max(errs["next_use"],
                               float((got - plain).abs().max()))
        cases.append(f"next_use {label} ({'shared' if N <= limit else 'global'}"
                     " table)")
    emit("kernel_checks", cases=cases, max_abs_err=errs,
         shared_table_entries=limit)
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
    check(launches == {"evict_argmin": T, "next_use": 1},
          f"main path launches {launches}, expected evict_argmin={T}, "
          "next_use=1")
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


def phase_kernels(seed: int, dev, errs: dict, launches: dict,
                  tr: Trace) -> None:
    """Time each kernel at the main path's shapes beside its plain version
    and its bound.

    evict_argmin gets the replay's steady state: 96 cell rows of the full
    trace's objects, each row with as many cached entries as its cell's
    budget less one (the requested object is masked out), one shared touch
    row. Its bound counts what that data needs: every mask byte, the score
    of each cached entry, the touch row and the outputs. Inputs are warm in
    L2, as in the replay, where the op just before wrote the scores.
    next_use reads each id once and writes each result once."""
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
    T = ids_t.numel()
    next_bytes = T * 4 + T * 4
    dense_bytes = {"evict_argmin": C * N * (4 + 4 + 1), "next_use": next_bytes}
    rows = []
    for name, kernel, plain, nbytes, shape in [
        ("evict_argmin", lambda: evict_argmin_cuda(s, t, m),
         lambda: ref.evict_argmin_ref(s, t, m), argmin_bytes,
         dict(C=C, N=N, dtype="float32", touch="shared (N,)",
              cached_per_row=[int(b) - 1 for b in FULL_BUDGETS])),
        ("next_use", lambda: next_use_cuda(ids_t, N),
         lambda: ref.next_use_ref(ids_t, N), next_bytes, dict(T=T, N=N)),
    ]:
        reps = 50 if name == "evict_argmin" else 5
        ms = time_ms(kernel, reps=reps)
        plain_ms = time_ms(plain, reps=reps)
        rows.append(dict(
            name=name, **KERNEL_INFO[name], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bound_note=f"{nbytes} bytes this data needs over 3.35 TB/s",
            dense_bound_ms=dense_bytes[name] / HBM_BYTES_PER_S * 1e3,
            dense_bound_note=("every score, touch and mask byte of each row "
                              "read" if name == "evict_argmin" else
                              "same as bound_ms"),
            library_ms=None, shape=shape))
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
    full = phase_replay_full(args.seed)
    phase_replay_profile(full["trace"], full["execute_s"])
    phase_kernels(args.seed, dev, errs, full["launches"], full["trace"])
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
