"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 1]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. Its phases, in order, each printing one JSON line:

* `kernel_checks`: build the CUDA kernels from
  `src/repro_torch/kernels/csrc` and hold each against its plain PyTorch
  version on the card.
* `replay_parity`, `regret`, `opt_occupancy`: replay the paper's (policy x
  price vector x budget) grid on a 20k-request trace on the card with
  kernels, on the card without, and on the CPU (the three grids must be
  bit-equal), score the dollars against the exact optimum, and check the
  optimum's schedules through the occupancy scan.
* `costfoo_cdn`: bracket the dollar-optimum of a 200k-request
  variable-size CDN trace with cost-FOO, its rounded schedule checked on
  the card, the bracket equal to a CPU run's.
* `replay_full`, `replay_profile`: the full-size sweep (200k requests, 20k
  objects, 96 cells) through the kernels, and where its step's time goes.
* `serve`, `serve_numerics`, `serve_profile`: phi4-mini-3.8b at full width
  through the egress-billed, governed engine, its bill held bit for bit
  against a host-only replay; decode against prefill and the card against
  the CPU; the decode step profiled.
* `serve_moe`, `serve_moe_numerics`, `serve_moe_profile`, `serve_fleet`:
  the same for qwen2-moe-a2.7b at full width (the MoE family), then the
  same stream through the engine's fleet mode, its bill reconciled across
  hosts, store and a host-only fleet, its tokens those of `serve_moe`.
* `serve_hybrid`, `serve_xlstm`: the serve stream through the engine at
  recurrentgemma-9b's and xlstm-125m's full size, every billing check of
  `serve`, the bill equal to the host rehearsal (`rehearse`); prefill and
  decode timed and profiled beside their bounds.
* `model_vlm`, `model_whisper`: qwen2-vl-72b (20 of its 80 layers) and
  whisper-large-v3 through `ModelApi` (the engine, like the reference's,
  prefills tokens alone): prefill, decode, timing and profile.
* `families_numerics`: for those four, decode against prefill at full
  width, and a depth cut in float32 on the card against the CPU.
* `train_xlstm`, `train_resume`: examples/train_100m.py's training run at
  xlstm-125m's full size through the driver and the billed data path,
  the data's bill equal to the same pipeline pulled on the host; and
  tests/test_fault_tolerance.py's crash-and-resume at that size, the
  resumed run bit-identical to an uninterrupted one.
* `train_dense`: phi4-mini-3.8b trained at full width and depth
  (Adafactor, remat, two microbatches) beside its operations bound.
* `train_numerics`: float32 depth cuts of four families, the loss,
  gradients and one update of each optimizer on the card against the
  CPU.
* `shard_train`, `shard_moe`: train_dense's step with DTensor parameters
  on a 1x1 ("data", "model") mesh of the card (nccl, one rank) against the
  plain step from the same weights, and qwen2-moe-a2.7b's prefill and
  decode with DTensor weights (the routed experts' local region, the
  caches in `kv_cache_sharding`'s layout) against plain weights.
* `stacked`: phi4-mini-3.8b's loss on the stacked layer layout against
  `loss_fn`, and the round trip between the layouts.
* `dryrun`: in subprocesses, train_dense's configuration as a one-card
  dry-run cell (fake tensors, the step counter) against its analytic
  FLOPs and train_dense's measured peak, and a production cell on the
  16x16 mesh of 256 fake ranks with its H100 roofline terms.
* the kernel line: every kernel with its time beside its bound.

It then prints the `nvidia-smi` name and power limit and last
`{"ok": true, "device": {...}}`. Any failed check raises and exits
non-zero; without a CUDA device it exits non-zero before printing any
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# PyTorch's deterministic algorithms (the training phases) need cuBLAS's
# workspace fixed before CUDA starts: 32 MiB, PyTorch's default for an
# sm_90 card, so the other phases run as they would without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import (PRICE_VECTORS, Trace, cost_foo,  # noqa: E402
                              exact_opt_uniform, exact_opt_uniform_sweep,
                              interval_deltas, miss_costs, regret, simulate,
                              sweep_torch, twemcache_like, wiki_cdn_like)
from repro_torch.core.trace import next_use_indices  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.egress import EgressCache, ObjectStore  # noqa: E402
from repro_torch.fleet import Fleet  # noqa: E402
from repro_torch.models import get_model, moe, transformer, xlstm  # noqa: E402
from repro_torch.models.common import (set_activation_mesh,  # noqa: E402
                                       tree_leaves, tree_map, tree_zip_map)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_mesh,  # noqa: E402
                                     start_process_group, stop_process_group)
from repro_torch.parallel import (batch_spec, kv_cache_sharding,  # noqa: E402
                                  make_rules, params_sharding)
from repro_torch.obs import EventLog, Tracer  # noqa: E402
from repro_torch.online import (DollarGovernor, MetricsRegistry,  # noqa: E402
                                WindowedAuditor)
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _grow, _prefix_key  # noqa: E402
from repro_torch.train import (DataPipeline, DriverConfig,  # noqa: E402
                               FailureInjector, OptimizerConfig,
                               ShardedTokenDataset, TrainDriver,
                               make_optimizer, make_train_step)
from repro_torch.train.trainer import (train_state_shardings,  # noqa: E402
                                       value_and_grad)
# the H100 SXM's data-sheet rates: dense bf16 tensor cores, float32 outside
# them, device memory
from repro_torch.launch.roofline import (  # noqa: E402
    F32_PEAK_FLOPS, HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_PEAK_FLOPS)
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


L2_FLUSH_BYTES = 256 << 20   # five times the H100's 50 MB L2


class L2Flush:
    """Evict the L2 between profiled calls: one pass over a 256 MiB buffer
    (`bitwise_not_` on uint8, a kernel nothing else here launches), whose
    kernel `device_time` recognises by name and leaves out of its sum."""

    def __init__(self, dev):
        self.buf = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def __call__(self) -> None:
        self.buf.bitwise_not_()

    @staticmethod
    def owns(kernel_name: str) -> bool:
        return "bitwise_not" in kernel_name


def device_time(fn, reps: int = 20, flush: L2Flush | None = None,
                tries: int = 3) -> dict:
    """Device time per call of the kernels `fn` launches, in all and by
    kernel name, from a torch.profiler trace of `reps` calls ("not
    measured" if the trace holds no device time). With `flush`, each call
    finds the L2 cold: the flush runs before it, and its kernel (one
    launch a call) is left out of the sum.

    The profiler loses the first events of a trace (a fast kernel read 18
    of 20 calls), which reads as a kernel faster than the card; so each
    trace records a second round of `reps` calls after a warm-up round
    (the profiler's own schedule). Every function timed here launches the
    same kernels on every call, so each name's count of events must be a
    multiple of `reps`: a trace that still lost events is taken again, up
    to `tries` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        traces = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: traces.append(
                         p.key_averages())) as prof:
            for _ in range(2):          # warm-up round, recorded round
                for _ in range(reps):
                    if flush is not None:
                        flush()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        by_name, counts, flushes = {}, {}, 0
        for e in (traces[-1] if traces else []):
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0
                    or e.key.startswith("ProfilerStep")):   # step marker
                continue
            if flush is not None and L2Flush.owns(e.key):
                flushes += e.count
                continue
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").strip()
            by_name[name] = by_name.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / reps
            counts[name] = counts.get(name, 0) + e.count
        complete = (bool(traces)
                    and all(n % reps == 0 for n in counts.values())
                    and (flush is None or flushes == reps))
        if complete:
            break
    check(complete, f"the profiler kept {counts} kernel events and {flushes} "
          f"flushes of {reps} calls in {tries} tries")
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
    occupancy_feasible and 8*T for interval_occupancy. In the rows labelled
    cold every profiled call (kernel, plain, library and yardsticks) finds
    the L2 flushed (`L2Flush`, left out of the device time), and no cold
    row may read more than 1.05 of its byte bound."""
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
    flush = L2Flush(dev)
    for name, kernel, plain, library, nbytes, reps, shape, *more in cases:
        yardsticks = more[0] if more else {}
        cold = shape.get("data", "").endswith("cold")
        fl = flush if cold else None
        ms = time_ms(kernel, reps=reps)
        plain_ms = time_ms(plain, reps=reps)
        library_ms = time_ms(library, reps=reps) if library else None
        on_card = device_time(kernel, flush=fl)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        share = (bound_ms / on_card["ms"] if on_card["kernels"]
                 else "not measured")
        check(not cold or share == "not measured" or share <= 1.05,
              f"{name} ({shape.get('data')}) reads {share} of its byte bound: "
              "faster than device memory, so the row was not cold")
        extra = {}
        if yardsticks:
            extra = dict(
                sort_only_device_ms=device_time(yardsticks["sort"],
                                                flush=fl)["ms"],
                sort_only_note="torch.sort(ids, stable=True) alone: one part "
                               "of the work (no successor, no write of "
                               "next(t)), timed as a yardstick; the port "
                               "never calls it",
                other_paths_device_ms={
                    other: device_time(fn, flush=fl)["ms"]
                    for other, fn in yardsticks["paths"].items()},
                other_paths_note="the same call forced down the kernel's "
                                 "other paths, which plan() picks at other "
                                 "T")
        rows.append(dict(
            name=name, **KERNEL_INFO[name], launches=launches[name],
            max_abs_err=errs[name], tolerance=TOLERANCE[name], ms=ms,
            plain_ms=plain_ms, device_ms=on_card["ms"],
            device_kernels=on_card["kernels"],
            plain_device_ms=device_time(plain, flush=fl)["ms"],
            library_device_ms=(device_time(library, flush=fl)["ms"]
                               if library else None),
            l2=("cold: the L2 flushed before each profiled call, the flush "
                "left out" if cold else "warm"),
            bound_ms=bound_ms, bound_by="bytes", bound_share=share,
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


# ---------------------------------------------------------------------------
# serving: the egress-billed engine at phi4-mini-3.8b's full width

SERVE_ARCH = "phi4-mini-3.8b"
SERVE_POOL, SERVE_PROMPT, SERVE_LONG = 8, 512, 2304
SERVE_ROUNDS, SERVE_PER_ROUND, SERVE_NEW, SERVE_LONG_NEW = 8, 4, 8, 4
SERVE_ZIPF, SERVE_WINDOW = 1.1, 4
SERVE_PRICE = "gcs_internet"
# serve_numerics tolerances, on max|gap| / max|reference logit|, set from
# bf16's 8-bit mantissa (one rounding: 2^-9 relative) before any run:
# (a) decode against prefill, both bf16 on the card through 32 layers: the
#     two paths round at the same places but sum their products in other
#     orders (M = 1 against M = 513), so each op may differ by an ulp;
#     2^-4 leaves several times the random-walk growth of 2^-9 steps.
# (b) the card's bf16 against the CPU's float32 on the same weights, two
#     layers: every bf16 rounding of the card is an error; 2^-6 = 8 ulps.
DECODE_VS_PREFILL_REL = 2.0 ** -4
CARD_VS_CPU_REL = 2.0 ** -6


def blob_bytes(cfg, S: int) -> int:
    """A prefix blob as the reference stores it: row b of every layer's
    first prefill cache tensor (`kv[0][b]`), reckoned from the config: an
    S-key K cache (L*S*G*hd in the parameter dtype) in the transformer
    families; a window-capped K cache in RecurrentGemma's attention layers
    and a float32 h in its RG-LRU layers; an mLSTM C (H*hd*hd) or a float32
    sLSTM c in xLSTM's."""
    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    G, hd, d, H = cfg.num_kv_heads, cfg.hd, cfg.d_model, cfg.num_heads
    layers = range(cfg.num_layers)
    if cfg.family == "hybrid":
        return sum((cfg.window or S) * G * hd * item if cfg.is_attn_layer(l)
                   else d * 4 for l in layers)
    if cfg.family == "xlstm":
        return sum(H * (d // H) ** 2 * item if l % 2 == 0 else d * 4
                   for l in layers)
    check(not cfg.window, "a windowed transformer's blob is not reckoned")
    return cfg.num_layers * S * G * hd * item


def serve_setup(seed: int, dev, arch: str = SERVE_ARCH,
                layers: int | None = None) -> tuple:
    """An architecture at full width (phi4-mini-3.8b unless named; its
    depth cut to `layers` where given), its weights drawn on the card."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    return model, params, dict(
        init_s=time.perf_counter() - t0, params=sum(t.numel() for t in leaves),
        param_bytes=sum(t.numel() * t.element_size() for t in leaves))


def matmul_params(cfg) -> int:
    """Weights of the per-token matrix products (embedding lookup and
    unembedding left out)."""
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return cfg.num_layers * (2 * d * H * hd + 2 * d * G * hd
                             + 3 * d * cfg.d_ff)


def dense_bounds(cfg, B: int, S: int) -> tuple:
    """A dense transformer's prefill operations for B rows of S tokens (the
    matrix products, causal attention: QK^T and PV over the keys at or
    before each query, half the S^2 square, and the last position's
    unembedding) and its decode step's bytes at position S (every weight
    and the KV cache of S + 2 keys read once)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    flops = (2 * matmul_params(cfg) * B * S
             + 2 * L * cfg.num_heads * cfg.hd * B * S * (S + 1)
             + 2 * d * V * B)
    decode_bytes = (2 * matmul_params(cfg) + 2 * d * V
                    + 2 * L * 2 * B * (S + 2) * cfg.num_kv_heads * cfg.hd)
    return flops, decode_bytes


def host_replay(keys: list, sizes: dict, capacity: float) -> tuple:
    """The engine's key sequence through a fresh cache wired as the
    engine wires it (GDSF, the governor and its auditor), on a store of
    blobs of the same lengths, with no model."""
    store = ObjectStore(SERVE_PRICE)
    for key, n in sizes.items():
        store.register_lazy(key, n, lambda n=n: bytes(n))
    metrics = MetricsRegistry()
    cache = EgressCache(store, capacity, "gdsf", consumer="serve_prefix_cache",
                        metrics=metrics, events=EventLog())
    DollarGovernor(cache, window=SERVE_WINDOW, hysteresis=0.05,
                   auditor=WindowedAuditor(capacity, window=4 * SERVE_WINDOW,
                                           metrics=metrics),
                   metrics=metrics)
    for key in keys:
        cache.get(key)
    return store, cache


def time_prefill_decode(model, params, batch: dict, steps: int) -> dict:
    """CUDA-event times of one prefill of `batch` (median of 3) and of
    `steps` greedy decode steps after it (ms a step), with the host's wall
    time of the same decode loop (enqueue to the final synchronize)."""
    B, S = batch["tokens"].shape
    prefill_ms = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, caches = model.prefill(params, batch)
        end.record()
        torch.cuda.synchronize()
        prefill_ms.append(start.elapsed_time(end))
    caches = _grow(model, caches, S + steps + 1)
    tok = torch.argmax(logits, -1)
    logits, caches = model.decode_step(params, tok, caches, S)   # warm-up
    tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for step in range(steps):
        logits, caches = model.decode_step(params, tok, caches, S + 1 + step)
        tok = torch.argmax(logits, -1)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(prefill_ms=statistics.median(prefill_ms[1:]),
                decode_ms_per_step=start.elapsed_time(end) / steps,
                decode_wall_ms_per_step=wall / steps * 1e3)


def serve_requests(seed: int, V: int) -> tuple:
    """The serve phases' request stream: a pool of eight 512-token prompts,
    one 2304-token prompt, and eight rounds of (rid, prompt, new tokens):
    four prompts drawn by Zipf(1.1) from the pool, and the long prompt in
    rounds 4 and 8."""
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, V, SERVE_PROMPT).astype(np.int32)
            for _ in range(SERVE_POOL)]
    long_prompt = rng.integers(0, V, SERVE_LONG).astype(np.int32)
    weights = 1.0 / np.arange(1, SERVE_POOL + 1) ** SERVE_ZIPF
    rounds, rid = [], 0
    for r in range(SERVE_ROUNDS):
        picks = rng.choice(SERVE_POOL, SERVE_PER_ROUND,
                           p=weights / weights.sum())
        reqs = [(rid + j, pool[i], SERVE_NEW) for j, i in enumerate(picks)]
        if r % 4 == 3:
            reqs.append((rid + len(reqs), long_prompt, SERVE_LONG_NEW))
        rid += len(reqs)
        rounds.append(reqs)
    return pool, long_prompt, rounds


def engine_touches(rounds: list) -> list:
    """The keys the engine touches, in order, when it serves `rounds` (one
    `serve` call a round): within a call, groups of equal length in order
    of length; a request's key is touched when its prefix blob is already
    in the store, and a group's blobs are stored after its touches. The
    rehearsal behind a predicted bill, held against the engine's trace."""
    stored, keys = set(), []
    for rnd in rounds:
        by_len: dict[int, list] = {}
        for _, p, _ in rnd:
            by_len.setdefault(len(p), []).append(_prefix_key(p))
        for _, group in sorted(by_len.items()):
            keys += [k for k in group if k in stored]
            stored.update(group)
    return keys


def rehearse(cfg, seed: int, capacity: float) -> dict:
    """The serve stream's bill for a model of config `cfg`, from the host
    alone: `engine_touches` through `host_replay` on blobs of
    `blob_bytes`."""
    pool, long_prompt, rounds = serve_requests(seed, cfg.vocab_size)
    sizes = {_prefix_key(p): blob_bytes(cfg, len(p))
             for p in pool + [long_prompt]}
    keys = engine_touches(rounds)
    store, cache = host_replay(keys, sizes, capacity)
    return dict(keys=keys, touches=len(keys), gets=store.meter.gets,
                hits=cache.hits, misses=cache.misses,
                dollars=store.meter.dollars, events=event_kinds(cache.events),
                audit=cache.audit())


def serve_rounds(engine, rounds: list, V: int) -> tuple:
    """Serve each round as one call, synchronised at its end; every output
    checked for its length and range. Returns the rounds' seconds and the
    tokens by rid."""
    round_s, outputs = [], {}
    for rnd in rounds:
        reqs = [Request(rid, prompt, n) for rid, prompt, n in rnd]
        t0 = time.perf_counter()
        engine.serve(reqs)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        for q in reqs:
            check(q.output.shape == (q.max_new_tokens,)
                  and bool(((q.output >= 0) & (q.output < V)).all()),
                  f"request {q.rid}: bad output {q.output}")
            outputs[q.rid] = q.output
    return round_s, outputs


EVENT_KINDS = ("hit", "miss", "admit", "reject", "evict", "policy_swap")


def event_kinds(events) -> dict:
    return {k: len(events.events(k)) for k in EVENT_KINDS}


def billing_checks(engine, tracer, events, cfg, rounds: list,
                   capacity: float) -> dict:
    """The governed engine's bill after `rounds`, held bit for bit: every
    blob of the reference's length (`blob_bytes`), the keys touched those
    of `engine_touches` (the rehearsal), GETs = misses, span dollars =
    meter (rel 1e-12), miss events = meter, an evict (and a reject where a
    blob exceeds the cache), and a host-only replay of the engine's key
    sequence billing, auditing and logging the same events alike."""
    store, cache, meter = engine.store, engine.cache, engine.cache.meter
    length = {_prefix_key(p): len(p) for rnd in rounds for _, p, _ in rnd}
    sizes = {k: store.size_of(k) for k in store.keys()}
    for key, n in sizes.items():
        check(n == blob_bytes(cfg, length[key]),
              f"blob {key} is {n} bytes, not {blob_bytes(cfg, length[key])}")
    check(cache._trace_keys == engine_touches(rounds),
          "the engine touched other keys than the rehearsal's")
    check(store.meter.gets == cache.misses > 0,
          f"{store.meter.gets} GETs for {cache.misses} misses")
    span_dollars = tracer.dollars(name="store.get", consumer=cache.consumer)
    check(abs(span_dollars - meter.dollars) <= 1e-12 * meter.dollars,
          f"span dollars {span_dollars} != meter {meter.dollars}")
    check(events.dollars_billed("miss") == meter.dollars,
          "miss events do not bill the meter's dollars bit for bit")
    kinds = event_kinds(events)
    oversize = max(sizes.values()) > capacity
    check(kinds["evict"] >= 1 and (kinds["reject"] >= 1 or not oversize),
          f"expected an evict (and a reject of an oversize blob): {kinds}")
    audit = engine.audit()
    r_store, r_cache = host_replay(list(cache._trace_keys), sizes, capacity)
    check(r_store.meter.dollars == store.meter.dollars
          and r_store.meter.gets == store.meter.gets
          and (r_cache.hits, r_cache.misses) == (cache.hits, cache.misses)
          and event_kinds(r_cache.events) == kinds,
          "the host-only replay bills otherwise than the engine")
    check(dataclasses.asdict(r_cache.audit()) == dataclasses.asdict(audit),
          "the host-only replay audits otherwise than the engine")
    check(audit.opt_dollars_lower <= meter.dollars * (1 + 1e-5),
          f"OPT {audit.opt_dollars_lower} above the bill {meter.dollars}")
    return dict(kinds=kinds, audit=audit, span_dollars=span_dollars)


def phase_serve(seed: int, model, params, setup: dict, dev) -> dict:
    """ServeEngine.serve at full width, governed, traced and logged: eight
    rounds of four prompts drawn by Zipf(1.1) from a pool of eight 512-token
    prompts (32 MiB blobs; the cache holds four), with one 2304-token
    prompt (a 144 MiB blob, larger than the cache, so its re-fetch is
    rejected after billing; 2304^2 query x key takes chunked_attention) in
    rounds 4 and 8. The bill is held against a host-only replay."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    V = cfg.vocab_size
    pool, _, rounds = serve_requests(seed, V)
    capacity = 4 * blob_bytes(cfg, SERVE_PROMPT)
    check(capacity == 1 << 27 and blob_bytes(cfg, SERVE_LONG) > capacity,
          f"cache {capacity} bytes: the pool's blobs are not 32 MiB")
    tracer, events = Tracer(), EventLog()
    engine = ServeEngine(model, params, prefix_cache_bytes=capacity,
                         policy="gdsf", govern=True,
                         governor_window=SERVE_WINDOW, tracer=tracer,
                         events=events)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    round_s, _ = serve_rounds(engine, rounds, V)
    rid = sum(len(rnd) for rnd in rounds)
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    store, cache, meter = engine.store, engine.cache, engine.cache.meter
    bill = billing_checks(engine, tracer, events, cfg, rounds, capacity)
    kinds, audit, span_dollars = bill["kinds"], bill["audit"], \
        bill["span_dollars"]

    again = [engine.serve([Request(rid + i, pool[0], SERVE_NEW)])[0].output
             for i in range(2)]
    check(np.array_equal(*again), f"one prompt, two outputs: {again}")

    tokens = torch.as_tensor(np.stack(pool[:SERVE_PER_ROUND]).astype(np.int64),
                             device=dev)
    timing = time_prefill_decode(model, params, {"tokens": tokens},
                                 steps=16)
    n_tok = tokens.numel()
    flops, decode_bytes = dense_bounds(cfg, SERVE_PER_ROUND, SERVE_PROMPT)
    emit("serve", arch=SERVE_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=V, params=setup["params"],
         param_gib=setup["param_bytes"] / 2**30, init_s=setup["init_s"],
         price=SERVE_PRICE, cache_bytes=capacity,
         blob_bytes={"pool": blob_bytes(cfg, SERVE_PROMPT),
                     "long": blob_bytes(cfg, SERVE_LONG)},
         rounds=SERVE_ROUNDS, requests=rid, round_s=round_s,
         prefill_tokens_per_s=n_tok / timing["prefill_ms"] * 1e3,
         prefill_ms=timing["prefill_ms"], prefill_tokens=n_tok,
         prefill_flops=flops,
         prefill_bound_ms=flops / BF16_PEAK_FLOPS * 1e3,
         prefill_bound_by="operations (bf16 at 989 TFLOP/s)",
         decode_ms_per_step=timing["decode_ms_per_step"],
         decode_wall_ms_per_step=timing["decode_wall_ms_per_step"],
         decode_batch=SERVE_PER_ROUND,
         decode_bound_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
         decode_bound_by="bytes (every weight and the KV cache read once, "
                         "3.35 TB/s)",
         peak_device_gib=peak_gib, launches=launches,
         gets=store.meter.gets, hits=cache.hits, misses=cache.misses,
         dollars=meter.dollars, events=kinds,
         policy=cache.policy, swaps=len(engine.governor.swaps),
         audit=audit.summary(), dollar_regret=audit.dollar_regret,
         opt_dollars=[audit.opt_dollars_lower, audit.opt_dollars_upper],
         host_replay_equal=True, span_dollars=span_dollars,
         seconds=time.perf_counter() - t_phase)
    return dict(pool=pool, timing=timing)


def phase_serve_numerics(seed: int, model, params, pool: list, dev) -> None:
    """(a) At full width, decode_step at position 512 for token x against
    the last-position logits of prefill(prompt + [x]). (b) A two-layer cut
    of the same weights (full width, batch 2, 128-token prompts): the
    card's bf16 prefill and 4 decode steps against the CPU's float32."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    rng = np.random.default_rng(seed + 2)
    prompt = torch.as_tensor(pool[1][None].astype(np.int64), device=dev)
    x = int(rng.integers(0, cfg.vocab_size))
    logits, caches = model.prefill(params, {"tokens": prompt})
    decode, _ = model.decode_step(params, torch.tensor([x], device=dev),
                                  _grow(model, caches, SERVE_PROMPT + 1),
                                  SERVE_PROMPT)
    longer = torch.cat([prompt, torch.tensor([[x]], device=dev)], 1)
    full, _ = model.prefill(params, {"tokens": longer})
    gap_a = float((decode - full).abs().max())
    rel_a = gap_a / float(full.abs().max())
    check(rel_a <= DECODE_VS_PREFILL_REL,
          f"decode against prefill: max gap {gap_a}, {rel_a} of the largest "
          f"logit > {DECODE_VS_PREFILL_REL}")
    top2 = torch.topk(full, 2, -1).values[0]
    margin_a = float(top2[0] - top2[1])
    check(margin_a <= DECODE_VS_PREFILL_REL * float(full.abs().max())
          or int(decode.argmax()) == int(full.argmax()),
          "decode and prefill pick other tokens where the margin exceeds "
          "the tolerance")

    cut = dataclasses.replace(cfg, num_layers=2)
    card_params = dict(params, layers=params["layers"][:2])
    host_params = tree_map(lambda t: t.float().cpu(), card_params)
    card = get_model(cut)
    host = get_model(dataclasses.replace(cut, param_dtype=torch.float32))
    toks = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int64)
    outs = {}
    for name, m, p, d in (("cpu", host, host_params, "cpu"),
                          ("cuda", card, card_params, dev)):
        lg, cs = m.prefill(p, {"tokens": torch.as_tensor(toks, device=d)})
        cs = _grow(m, cs, 128 + 4)
        seq = [lg.float().cpu()]
        for step in range(4):
            # both sides take the CPU's greedy token
            nxt = torch.argmax(outs["cpu"][step] if name == "cuda"
                               else seq[-1], -1)
            lg, cs = m.decode_step(p, nxt.to(d), cs, 128 + step)
            seq.append(lg.float().cpu())
        outs[name] = seq
    rel_b, agree, compared = [], 0, 0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        rel_b.append(float((got - want).abs().max() / want.abs().max()))
        top2 = torch.topk(want, 2, -1).values
        sure = (top2[:, 0] - top2[:, 1]) > CARD_VS_CPU_REL * want.abs().max()
        compared += int(sure.sum())
        agree += int((torch.argmax(got, -1) == torch.argmax(want, -1))[sure]
                     .sum())
    check(max(rel_b) <= CARD_VS_CPU_REL,
          f"card against CPU: {max(rel_b)} of the largest logit > "
          f"{CARD_VS_CPU_REL}")
    check(agree == compared, f"greedy tokens differ where the margin exceeds "
          f"the tolerance: {agree} of {compared}")
    emit("serve_numerics",
         decode_vs_prefill=dict(position=SERVE_PROMPT, token=x,
                                max_abs_gap=gap_a, rel_gap=rel_a,
                                tolerance_rel=DECODE_VS_PREFILL_REL,
                                top2_margin=margin_a,
                                same_greedy_token=int(decode.argmax())
                                == int(full.argmax())),
         card_vs_cpu=dict(layers=2, batch=2, prompt=128, decode_steps=4,
                          rel_gap_per_step=rel_b,
                          tolerance_rel=CARD_VS_CPU_REL,
                          greedy_compared=compared, greedy_equal=agree),
         seconds=time.perf_counter() - t_phase)


def decode_profile(model, params, batch: dict, steps: int = 4) -> dict:
    """Where a decode step's time goes: a torch.profiler window over
    `steps` greedy decode steps after a prefill of `batch` (position S, its
    length), recorded after a warm-up round of as many (the profiler loses
    a trace's first events; see `device_time`): device time and events a
    step, host `cudaLaunchKernel` calls a step, the top device and host
    ops. For an MoE model also the device time of `aten::index`: the
    expert-weight gathers (`w1[gi]`, `w3[gi]`, `w2[gi]` in every layer)
    and the step's embedding lookup."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    B, S = batch["tokens"].shape
    logits, caches = model.prefill(params, batch)
    caches = _grow(model, caches, S + 2 * steps + 1)
    tok = torch.argmax(logits, -1)
    logits, caches = model.decode_step(params, tok, caches, S)
    tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    traces, position = [], S + 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(
                     p.key_averages())) as prof:
        for _ in range(2):              # warm-up round, recorded round
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, caches = model.decode_step(params, tok, caches,
                                                   position)
                tok = torch.argmax(logits, -1)
                position += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    check(bool(traces), "decode_profile: the profiler recorded no trace")
    events = [e for e in traces[-1] if not e.key.startswith("ProfilerStep")]
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / steps

    def top(evs, key, n):
        evs = sorted(evs, key=key, reverse=True)[:n]
        return [[e.key, e.count / steps, key(e) / steps] for e in evs]

    launch = [e for e in on_host if e.key == "cudaLaunchKernel"]
    out = dict(steps=steps, batch=B, position=S,
               profiled_wall_ms_per_step=wall / steps * 1e3,
               device_ms_per_step=device_ms if on_card else "not measured",
               device_events_per_step=sum(e.count for e in on_card) / steps,
               cuda_launch_kernel_calls_per_step=sum(
                   e.count for e in launch) / steps,
               top_device_us_per_step=top(
                   on_card, lambda e: e.self_device_time_total, 10),
               top_host_us_per_step=top(
                   on_host, lambda e: e.self_cpu_time_total, 10))
    if model.cfg.family == "moe":
        index = [e for e in on_host if e.key == "aten::index"]
        index_ms = sum(e.device_time_total for e in index) / 1e3 / steps
        out.update(index_calls_per_step=sum(e.count for e in index) / steps,
                   index_device_ms_per_step=index_ms,
                   index_share_of_device=index_ms / device_ms
                   if device_ms else "not measured")
    return out


def phase_serve_profile(model, params, pool: list, timing: dict, dev,
                        steps: int = 4, phase: str = "serve_profile") -> None:
    """`decode_profile` at full width (batch 4 at position 512), its device
    time set against the unprofiled step time of `serve`."""
    t_phase = time.perf_counter()
    tokens = torch.as_tensor(np.stack(pool[:SERVE_PER_ROUND]).astype(np.int64),
                             device=dev)
    prof = decode_profile(model, params, {"tokens": tokens}, steps)
    step_ms = timing["decode_ms_per_step"]
    device_ms = prof["device_ms_per_step"]
    emit(phase, **prof, unprofiled_ms_per_step=step_ms,
         host_wall_ms_per_step=timing["decode_wall_ms_per_step"],
         device_busy_share=device_ms / step_ms
         if device_ms != "not measured" else "not measured",
         seconds=time.perf_counter() - t_phase)


def phase_serving(seed: int, dev) -> None:
    """The serving slice: serve, serve_numerics and serve_profile on one
    set of full-width weights, freed afterwards."""
    model, params, setup = serve_setup(seed, dev)
    out = phase_serve(seed, model, params, setup, dev)
    phase_serve_numerics(seed, model, params, out["pool"], dev)
    phase_serve_profile(model, params, out["pool"], out["timing"], dev)
    del model, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving the MoE family: qwen2-moe-a2.7b at full width

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_PARAMS = 14_315_587_584
MOE_CACHE_BYTES = 192 << 20       # four 48 MiB blobs of 512-token prefixes
MOE_FLEET_NODES = 3
# serve_moe_numerics tolerances, on max|gap| / max|reference logit|, fixed
# before any run:
# (a) decode against prefill, both bf16 on the card through 24 layers, as
#     serve_numerics (a): 2^-4. Prefill drops tokens past an expert's
#     capacity by design and decode never does, so this check alone sets
#     capacity_factor = E/K, which gives C >= S: prefill drops nothing.
# (b) the card against the CPU on a two-layer cut, both in float32 with
#     TF32 off (in bf16 a routing flip between the two sides would set the
#     gap): the two sum products in other orders, a few float32 ulps per
#     op; 2^-12 of the largest logit. Every token whose K-th gate leads its
#     (K+1)-th by more than MOE_GATE_GAP picks the same experts on both.
MOE_DECODE_VS_PREFILL_REL = 2.0 ** -4
MOE_CARD_VS_CPU_REL = 2.0 ** -12
MOE_GATE_GAP = 1e-4


@contextlib.contextmanager
def moe_calls():
    """Record every MoE layer call of the port's transformer, in call
    order: its input and its top-k experts (by `moe.route`, the function
    the layer itself routes with). The layer's output is unchanged."""
    log = []
    real = transformer.moe_ffn_apply

    def recorded(cfg, p, x):
        log.append((x, p, moe.route(cfg, p, x)[1]))
        return real(cfg, p, x)
    transformer.moe_ffn_apply = recorded
    try:
        yield log
    finally:
        transformer.moe_ffn_apply = real


def moe_prefill_ops(cfg, B: int, S: int) -> dict:
    """The operations one prefill of B rows of S tokens does, counted as the
    reference computes them: bf16 products (q, k, v, o; causal attention
    over half the S^2 square; the routed experts over E*C slots a row, not
    S*K tokens; the shared experts) and float32 ones (the router, and the
    last position's `x.f32 @ unembed.f32`)."""
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    E, fe = cfg.num_experts, cfg.d_expert
    fs, n = fe * cfg.num_shared_experts, B * S
    C = moe.capacity(cfg, S)
    L = cfg.num_layers
    check(all(cfg.is_moe_layer(l) for l in range(L)), "a dense layer")
    bf16 = L * (2 * n * (2 * d * H * hd + 2 * d * G * hd)
                + 2 * H * hd * B * S * (S + 1)
                + 2 * 3 * B * E * C * d * fe
                + 2 * 3 * n * d * fs)
    f32 = L * 2 * n * d * E + 2 * B * d * cfg.vocab_size
    return dict(bf16=bf16, f32=f32)


def moe_weight_bytes(cfg, experts_read: float) -> int:
    """Bytes of the weights one decode step must read once: every weight
    but the routed experts, and `experts_read` experts' three matrices
    summed over the layers (the distinct experts the batch routes to)."""
    d, H, G, hd, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                      cfg.num_layers)
    fe, fs = cfg.d_expert, cfg.d_expert * cfg.num_shared_experts
    per_layer = (2 * d * H * hd + 2 * d * G * hd + 3 * d * fs + 2 * d) * 2 \
        + d * cfg.num_experts * 4
    return int(L * per_layer + experts_read * 3 * d * fe * 2
               + (cfg.d_model * cfg.vocab_size + d) * 2)


def decode_experts(model, params, tokens: torch.Tensor, steps: int) -> list:
    """The distinct experts each layer reads in each of the `steps` decode
    steps that `time_prefill_decode` times (the same prefill, warm-up step
    and positions; routing is deterministic)."""
    B, S = tokens.shape
    logits, caches = model.prefill(params, {"tokens": tokens})
    caches = _grow(model, caches, S + steps + 1)
    tok = torch.argmax(logits, -1)
    logits, caches = model.decode_step(params, tok, caches, S)
    tok = torch.argmax(logits, -1)
    per_step = []
    for step in range(steps):
        with moe_calls() as log:
            logits, caches = model.decode_step(params, tok, caches,
                                               S + 1 + step)
        tok = torch.argmax(logits, -1)
        per_step.append([int(gi.unique().numel()) for _, _, gi in log])
    return per_step


def phase_serve_moe(seed: int, model, params, setup: dict, dev) -> dict:
    """The serve phase's stream through the governed, traced engine at
    qwen2-moe-a2.7b's full width: a 192 MiB cache holds four 48 MiB blobs
    of 512-token prefixes; the 2304-token prompt's 216 MiB blob is billed
    and rejected. Every billing check of `serve`, then prefill and decode
    timed beside their bounds."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    V = cfg.vocab_size
    check(setup["params"] == MOE_PARAMS,
          f"{setup['params']} parameters, not {MOE_PARAMS}")
    pool, _, rounds = serve_requests(seed, V)
    capacity = MOE_CACHE_BYTES
    check(blob_bytes(cfg, SERVE_PROMPT) == 48 << 20
          and blob_bytes(cfg, SERVE_LONG) > capacity,
          f"blob {blob_bytes(cfg, SERVE_PROMPT)} bytes, not 48 MiB")
    tracer, events = Tracer(), EventLog()
    engine = ServeEngine(model, params, prefix_cache_bytes=capacity,
                         policy="gdsf", govern=True,
                         governor_window=SERVE_WINDOW, tracer=tracer,
                         events=events)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    round_s, outputs = serve_rounds(engine, rounds, V)
    rid = sum(len(rnd) for rnd in rounds)
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"serve_moe launched kernels: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    bill = billing_checks(engine, tracer, events, cfg, rounds, capacity)
    store, cache, audit = engine.store, engine.cache, bill["audit"]
    again = [engine.serve([Request(rid + i, pool[0], SERVE_NEW)])[0].output
             for i in range(2)]
    check(np.array_equal(*again), f"one prompt, two outputs: {again}")

    tokens = torch.as_tensor(np.stack(pool[:SERVE_PER_ROUND]).astype(np.int64),
                             device=dev)
    steps = 16
    timing = time_prefill_decode(model, params, {"tokens": tokens},
                                 steps=steps)
    experts = decode_experts(model, params, tokens, steps)
    experts_read = statistics.mean(sum(step) for step in experts)
    n_tok = tokens.numel()
    ops_ = moe_prefill_ops(cfg, SERVE_PER_ROUND, SERVE_PROMPT)
    prefill_ops_ms = (ops_["bf16"] / BF16_PEAK_FLOPS
                      + ops_["f32"] / F32_PEAK_FLOPS) * 1e3
    all_weights = moe_weight_bytes(cfg, cfg.num_layers * cfg.num_experts)
    prefill_bytes_ms = (all_weights + 2 * n_tok * cfg.d_model * 2) \
        / HBM_BYTES_PER_S * 1e3
    kv_bytes = (2 * cfg.num_layers * 2 * SERVE_PER_ROUND * (SERVE_PROMPT + 2)
                * cfg.num_kv_heads * cfg.hd)
    decode_bytes = moe_weight_bytes(cfg, experts_read) + kv_bytes
    # the reference's own data flow adds the float32 unembedding it makes
    # on every call: written once and read once
    cast_bytes = 2 * cfg.d_model * V * 4
    emit("serve_moe", arch=MOE_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
         experts=cfg.num_experts, top_k=cfg.top_k,
         shared_experts=cfg.num_shared_experts, d_expert=cfg.d_expert,
         vocab=V, params=setup["params"], param_bytes=setup["param_bytes"],
         param_gib=setup["param_bytes"] / 2**30, init_s=setup["init_s"],
         price=SERVE_PRICE, cache_bytes=capacity,
         blob_bytes={"pool": blob_bytes(cfg, SERVE_PROMPT),
                     "long": blob_bytes(cfg, SERVE_LONG)},
         capacity_slots={S: moe.capacity(cfg, S)
                         for S in (SERVE_PROMPT, SERVE_PROMPT + 1,
                                   SERVE_LONG)},
         rounds=SERVE_ROUNDS, requests=rid, round_s=round_s,
         prefill_tokens_per_s=n_tok / timing["prefill_ms"] * 1e3,
         prefill_ms=timing["prefill_ms"], prefill_tokens=n_tok,
         prefill_bf16_flops=ops_["bf16"], prefill_f32_flops=ops_["f32"],
         prefill_ops_bound_ms=prefill_ops_ms,
         prefill_bytes_bound_ms=prefill_bytes_ms,
         prefill_bound_ms=max(prefill_ops_ms, prefill_bytes_ms),
         prefill_bound_by="operations (bf16 at 989 TFLOP/s, float32 at "
                          "67 TFLOP/s)" if prefill_ops_ms >= prefill_bytes_ms
         else "bytes (every weight read once, 3.35 TB/s)",
         decode_ms_per_step=timing["decode_ms_per_step"],
         decode_wall_ms_per_step=timing["decode_wall_ms_per_step"],
         decode_batch=SERVE_PER_ROUND,
         decode_distinct_experts_per_step=experts_read,
         decode_distinct_experts_by_layer_first_step=experts[0],
         decode_bytes=decode_bytes,
         decode_bound_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
         decode_bound_by="bytes (every weight the step needs, the distinct "
                         "routed experts of this run, and the KV cache read "
                         "once, 3.35 TB/s)",
         decode_bytes_with_f32_unembed=decode_bytes + cast_bytes,
         decode_ms_with_f32_unembed=(decode_bytes + cast_bytes)
         / HBM_BYTES_PER_S * 1e3,
         peak_device_gib=peak_gib, launches=launches,
         gets=store.meter.gets, hits=cache.hits, misses=cache.misses,
         dollars=cache.meter.dollars, events=bill["kinds"],
         policy=cache.policy, swaps=len(engine.governor.swaps),
         audit=audit.summary(), dollar_regret=audit.dollar_regret,
         opt_dollars=[audit.opt_dollars_lower, audit.opt_dollars_upper],
         host_replay_equal=True, span_dollars=bill["span_dollars"],
         repeat_tokens_equal=True, seconds=time.perf_counter() - t_phase)
    return dict(pool=pool, rounds=rounds, outputs=outputs, timing=timing,
                capacity=capacity)


def moe_routing_agreement(cpu_calls: list, card_calls: list, K: int) -> dict:
    """Top-k experts of the two sides, call by call (the same layers in the
    same order), compared on every token whose K-th gate (on the CPU) leads
    its (K+1)-th by more than MOE_GATE_GAP."""
    compared = equal = 0
    for (x, p, gi), (_, _, gi_card) in zip(cpu_calls, card_calls, strict=True):
        gates = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
        top = torch.sort(gates, dim=-1, descending=True).values
        sure = (top[..., K - 1] - top[..., K]) > MOE_GATE_GAP
        same = (gi.sort(-1).values == gi_card.cpu().sort(-1).values).all(-1)
        compared += int(sure.sum())
        equal += int(same[sure].sum())
    return dict(compared=compared, equal=equal)


def phase_serve_moe_numerics(seed: int, model, params, pool: list,
                             dev) -> None:
    """(a) At full width with capacity_factor = E/K, decode_step at position
    512 for token x against the last-position logits of prefill(prompt +
    [x]). (b) A two-layer cut of the same weights in float32 (full width,
    batch 2, 128-token prompts, TF32 off): the card's prefill and 4 decode
    steps against the CPU's, and their routing."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    rng = np.random.default_rng(seed + 2)
    # drops are by design and only on prefill: with C >= S nothing drops,
    # so decode and prefill compute the same function
    no_drop = get_model(dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k))
    check(moe.capacity(no_drop.cfg, SERVE_PROMPT + 1) >= SERVE_PROMPT + 1,
          "capacity_factor E/K leaves C < S")
    prompt = torch.as_tensor(pool[1][None].astype(np.int64), device=dev)
    x = int(rng.integers(0, cfg.vocab_size))
    logits, caches = no_drop.prefill(params, {"tokens": prompt})
    with moe_calls() as dec_calls:
        decode, _ = no_drop.decode_step(
            params, torch.tensor([x], device=dev),
            _grow(no_drop, caches, SERVE_PROMPT + 1), SERVE_PROMPT)
    longer = torch.cat([prompt, torch.tensor([[x]], device=dev)], 1)
    with moe_calls() as pre_calls:
        full, _ = no_drop.prefill(params, {"tokens": longer})
    flips = sum(int(not torch.equal(a[2][0, -1].sort().values,
                                    b[2][0, -1].sort().values))
                for a, b in zip(dec_calls, pre_calls, strict=True))
    del dec_calls, pre_calls, caches
    gap_a = float((decode - full).abs().max())
    rel_a = gap_a / float(full.abs().max())
    check(rel_a <= MOE_DECODE_VS_PREFILL_REL,
          f"decode against prefill: max gap {gap_a}, {rel_a} of the largest "
          f"logit > {MOE_DECODE_VS_PREFILL_REL} ({flips} layers routed the "
          f"last token otherwise)")
    top2 = torch.topk(full, 2, -1).values[0]
    margin_a = float(top2[0] - top2[1])
    check(margin_a <= MOE_DECODE_VS_PREFILL_REL * float(full.abs().max())
          or int(decode.argmax()) == int(full.argmax()),
          "decode and prefill pick other tokens where the margin exceeds "
          "the tolerance")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut = dataclasses.replace(cfg, num_layers=2,
                                  param_dtype=torch.float32)
        card_params = tree_map(lambda t: t.float(),
                               dict(params, layers=params["layers"][:2]))
        host_params = tree_map(lambda t: t.cpu(), card_params)
        m = get_model(cut)
        toks = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int64)
        outs, calls = {}, {}
        for name, p, d in (("cpu", host_params, "cpu"),
                           ("cuda", card_params, dev)):
            with moe_calls() as log:
                lg, cs = m.prefill(p, {"tokens": torch.as_tensor(toks,
                                                                 device=d)})
                cs = _grow(m, cs, 128 + 4)
                seq = [lg.float().cpu()]
                for step in range(4):
                    # both sides take the CPU's greedy token
                    nxt = torch.argmax(outs["cpu"][step] if name == "cuda"
                                       else seq[-1], -1)
                    lg, cs = m.decode_step(p, nxt.to(d), cs, 128 + step)
                    seq.append(lg.float().cpu())
            outs[name], calls[name] = seq, log
        routing = moe_routing_agreement(calls["cpu"], calls["cuda"],
                                        cfg.top_k)
        del calls, card_params, host_params, cs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rel_b = [float((got - want).abs().max() / want.abs().max())
             for got, want in zip(outs["cuda"], outs["cpu"])]
    check(max(rel_b) <= MOE_CARD_VS_CPU_REL,
          f"card against CPU: {max(rel_b)} of the largest logit > "
          f"{MOE_CARD_VS_CPU_REL}")
    check(routing["compared"] > 0 and routing["equal"] == routing["compared"],
          f"the card routes otherwise than the CPU: {routing}")
    emit("serve_moe_numerics",
         decode_vs_prefill=dict(position=SERVE_PROMPT, token=x,
                                capacity_factor=no_drop.cfg.capacity_factor,
                                capacity=moe.capacity(no_drop.cfg,
                                                      SERVE_PROMPT + 1),
                                max_abs_gap=gap_a, rel_gap=rel_a,
                                tolerance_rel=MOE_DECODE_VS_PREFILL_REL,
                                top2_margin=margin_a,
                                layers_routing_last_token_otherwise=flips,
                                same_greedy_token=int(decode.argmax())
                                == int(full.argmax())),
         card_vs_cpu=dict(layers=2, dtype="float32", tf32=False, batch=2,
                          prompt=128, decode_steps=4,
                          rel_gap_per_step=rel_b,
                          tolerance_rel=MOE_CARD_VS_CPU_REL,
                          routing_gate_gap=MOE_GATE_GAP,
                          routing_tokens_compared=routing["compared"],
                          routing_tokens_equal=routing["equal"]),
         seconds=time.perf_counter() - t_phase)


def phase_serve_fleet(model, params, moe_out: dict) -> None:
    """serve_moe's stream through a second engine in fleet mode (three
    hash-partitioned hosts, 64 MiB of prefix cache each, govern=False). The
    fleet's bill reconciles bit for bit with the per-host audits, the store
    and a host-only Fleet fed the same key sequence; each host's GETs equal
    its misses; the tokens are serve_moe's, since fleet mode changes the
    bill and nothing else."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    engine = ServeEngine(model, params, prefix_cache_bytes=moe_out["capacity"],
                         policy="gdsf", fleet_nodes=MOE_FLEET_NODES,
                         governor_window=SERVE_WINDOW)
    fleet, keys = engine.fleet, []
    access = fleet.access

    def recorded(key, event_time=None):
        keys.append(key)
        return access(key, event_time)
    fleet.access = recorded         # the engine's key sequence, in order
    ops.reset_launch_counts()
    round_s, outputs = serve_rounds(engine, moe_out["rounds"], cfg.vocab_size)
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"serve_fleet launched kernels: {launches}")
    for rid, want in moe_out["outputs"].items():
        check(np.array_equal(outputs[rid], want),
              f"request {rid}: fleet mode generated other tokens")
    audits = engine.audit()
    observed = math.fsum(a.observed_dollars for a in audits.values()
                         if a is not None)
    dollars = fleet.dollars()
    check(dollars == observed,
          f"fleet dollars {dollars!r} != fsum of audits {observed!r}")
    check(dollars == engine.store.meter.dollars,
          f"fleet dollars {dollars!r} != store meter "
          f"{engine.store.meter.dollars!r}")
    for n in fleet.nodes:
        check(n.cache.meter.gets == n.cache.misses,
              f"{n.host}: {n.cache.meter.gets} GETs for {n.cache.misses} "
              "misses")
    check(sum(n.cache.misses for n in fleet.nodes) > 0 and
          sum(n.cache.hits for n in fleet.nodes) > 0,
          "the fleet saw no hit or no miss")
    store = ObjectStore(SERVE_PRICE)
    for key in engine.store.keys():
        n = engine.store.size_of(key)
        store.register_lazy(key, n, lambda n=n: bytes(n))
    replay = Fleet(store=store, n_nodes=MOE_FLEET_NODES,
                   capacity_bytes=moe_out["capacity"] / MOE_FLEET_NODES,
                   policy="gdsf", window_span=4.0 * SERVE_WINDOW,
                   max_skew=float(SERVE_WINDOW), gossip_every=SERVE_WINDOW,
                   metrics=MetricsRegistry())
    for key in keys:
        replay.access(key)

    def as_dicts(by_host):
        return {h: None if a is None else dataclasses.asdict(a)
                for h, a in by_host.items()}
    check(replay.dollars() == dollars
          and as_dicts(replay.audits()) == as_dicts(audits),
          "a host-only fleet bills or audits otherwise than the engine")
    emit("serve_fleet", arch=MOE_ARCH, nodes=MOE_FLEET_NODES,
         cache_bytes_per_node=moe_out["capacity"] / MOE_FLEET_NODES,
         requests=len(outputs), round_s=round_s, accesses=len(keys),
         launches=launches, dollars=dollars,
         store_dollars=engine.store.meter.dollars,
         hosts={n.host: dict(hits=n.cache.hits, misses=n.cache.misses,
                             gets=n.cache.meter.gets,
                             dollars=n.cache.meter.dollars,
                             policy=n.cache.policy) for n in fleet.nodes},
         swaps=len(fleet.swaps), policy=fleet.policy,
         tokens_equal_serve_moe=True, host_replay_equal=True,
         seconds=time.perf_counter() - t_phase)


def phase_moe_serving(seed: int, dev) -> None:
    """The MoE slice: serve_moe, serve_moe_numerics, serve_moe_profile and
    serve_fleet on one set of full-width qwen2-moe-a2.7b weights."""
    model, params, setup = serve_setup(seed, dev, MOE_ARCH)
    out = phase_serve_moe(seed, model, params, setup, dev)
    phase_serve_moe_numerics(seed, model, params, out["pool"], dev)
    phase_serve_profile(model, params, out["pool"], out["timing"], dev,
                        phase="serve_moe_profile")
    phase_serve_fleet(model, params, out)
    del model, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the other families: RecurrentGemma and xLSTM through the billed engine,
# qwen2-vl and whisper through ModelApi (the engine prefills tokens alone,
# as the reference's does), and the four families' numerics

HYBRID_ARCH, XLSTM_ARCH = "recurrentgemma-9b", "xlstm-125m"
VLM_ARCH, WHISPER_ARCH = "qwen2-vl-72b", "whisper-large-v3"
# qwen2-vl-72b's 80 layers are 72.7 B parameters, 145 GB in bf16: one 80 GB
# card holds 20 (the whole model needs the layers sharded over cards)
VLM_LAYERS = 20
WHISPER_TOKENS = 448        # Whisper's decoder length
MODEL_DECODE_STEPS = 8
# families_numerics tolerances, on max|gap| / max|reference logit|, fixed
# before the first chip run:
# (a) decode against prefill at full width, bf16 on the card, as
#     serve_numerics (a): 2^-4. xLSTM decodes token by token from
#     init_state over the prompt against forward's last logits (the
#     chunkwise form), its bf16 states rounded every step: the reference's
#     own gap for the same check (xlstm-125m at full width, bf16, JAX on
#     the CPU, tools/xlstm_reference_gap.py) is 0.00446 of the largest
#     logit, so max(2^-4, twice that) = 2^-4. vlm's gap is printed, not
#     gated: the reference's decode positions run P - 1 ahead of prefill's.
# (b) a depth cut in float32 on both sides, TF32 off, the card against the
#     port on the CPU, prefill logits and one decode step: 2^-12, as
#     serve_moe_numerics (b).
FAMILY_DECODE_VS_PREFILL_REL = 2.0 ** -4
XLSTM_REFERENCE_GAP = 0.004463571963611083
XLSTM_DECODE_VS_FORWARD_REL = max(2.0 ** -4, 2 * XLSTM_REFERENCE_GAP)
FAMILY_CARD_VS_CPU_REL = 2.0 ** -12
# (b)'s cuts by family: layers (whisper: encoder and decoder each; three
# for RecurrentGemma, so that one local-attention layer is in), batch,
# tokens (vlm: the 256 vision positions and 64 text tokens)
FAMILY_CUTS = {"vlm": (2, 1, 320), "encdec": (2, 2, 64),
               "hybrid": (3, 2, 128), "xlstm": (12, 2, 320)}


def family_batch(model, tokens: torch.Tensor, seed: int) -> dict:
    """A prefill batch for `tokens`: the other inputs of
    `ModelApi.prefill_inputs` (the vlm family's vision embeddings, whisper's
    frames) drawn from a seeded torch.Generator on the tokens' device."""
    gen = torch.Generator(device=tokens.device).manual_seed(seed)
    batch = {"tokens": tokens}
    for name, spec in model.prefill_inputs(*tokens.shape).items():
        if name != "tokens":
            batch[name] = torch.randn(spec.shape, generator=gen,
                                      device=tokens.device).to(spec.dtype)
    return batch


def family_bounds(cfg, B: int, S: int) -> dict:
    """Prefill operations for B rows of S tokens, counted as the reference
    computes them (bf16 products, float32 ones), and the decode step's
    bytes at position S (every weight the step reads and its caches or
    states read once, states written once)."""
    d, H, G, hd, L, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hd, cfg.num_layers, cfg.vocab_size)
    attn = 2 * d * H * hd + 2 * d * G * hd           # q, k, v, o weights
    unembed = 2 * d * V * B                          # last position, float32
    if cfg.family == "vlm":
        flops, decode_bytes = dense_bounds(cfg, B, S)
        return dict(bf16=flops - unembed, f32=unembed,
                    decode_bytes=decode_bytes)
    if cfg.family == "hybrid":
        n_att = sum(cfg.is_attn_layer(l) for l in range(L))
        n_rec = L - n_att
        per_tok = n_rec * 5 * d * d + n_att * attn + L * 3 * d * cfg.d_ff
        pairs = sum(min(i + 1, cfg.window) for i in range(S))
        W, w = cfg.window or S, cfg.rglru_conv_width
        return dict(
            bf16=2 * per_tok * B * S + n_att * 2 * 2 * H * hd * B * pairs,
            f32=unembed,
            decode_bytes=(2 * per_tok + 2 * d * V
                          + n_att * 2 * B * W * G * hd * 2
                          + n_rec * B * (d * 4 + (w - 1) * d * 2) * 2))
    if cfg.family == "xlstm":
        n_m, n_s = (L + 1) // 2, L // 2
        hd = d // H
        per_tok = n_m * (5 * d * d + 2 * d * H) + n_s * 5 * d * d
        Lc = min(256, S)
        chunks = -(-S // Lc)
        pairs = Lc * (Lc + 1) // 2                   # causal, a chunk
        state = n_m * B * (H * hd * hd * 2 + H * hd * 2 + H * 4) \
            + n_s * B * 2 * d * 4
        return dict(
            bf16=2 * per_tok * B * S + n_m * chunks * 2 * B * pairs * H * hd,
            # num, n_i, q.C and the C update, and forward's logits at
            # every position (the reference's stateless prefill)
            f32=n_m * chunks * (2 * 2 * B * pairs * H * hd
                                + 2 * 2 * B * Lc * H * hd * hd)
            + 2 * d * V * B * S,
            decode_bytes=2 * per_tok + 2 * d * V + 2 * state)
    check(cfg.family == "encdec", f"no bounds for {cfg.family}")
    Fr, Le, F_ = 1500, cfg.encoder_layers, cfg.d_ff
    enc = B * Fr
    return dict(
        bf16=(2 * enc * (d * d + Le * (attn + 2 * d * F_))
              + Le * 2 * 2 * H * hd * B * Fr * Fr
              + 2 * B * S * L * (attn + 2 * d * H * hd + 2 * d * F_)
              + 2 * enc * L * 2 * d * G * hd
              + L * 2 * H * hd * B * S * (S + 1)
              + L * 2 * 2 * H * hd * B * S * Fr),
        f32=unembed,
        decode_bytes=(2 * L * (attn + 2 * d * H * hd + 2 * d * F_)
                      + 2 * d * V
                      + L * 2 * B * (S + 2) * G * hd * 2
                      + L * 2 * B * Fr * G * hd * 2))


def model_report(model, params, batch: dict, steps: int) -> dict:
    """Prefill and decode timed (`time_prefill_decode`), the decode step
    profiled (`decode_profile`), each beside its bound."""
    cfg = model.cfg
    B, S = batch["tokens"].shape
    timing = time_prefill_decode(model, params, batch, steps)
    prof = decode_profile(model, params, batch)
    bounds = family_bounds(cfg, B, S)
    ops_ms = (bounds["bf16"] / BF16_PEAK_FLOPS
              + bounds["f32"] / F32_PEAK_FLOPS) * 1e3
    device_ms = prof["device_ms_per_step"]
    return dict(
        prefill_ms=timing["prefill_ms"], prefill_tokens=B * S,
        prefill_tokens_per_s=B * S / timing["prefill_ms"] * 1e3,
        prefill_bf16_flops=bounds["bf16"], prefill_f32_flops=bounds["f32"],
        prefill_bound_ms=ops_ms,
        prefill_bound_by="operations (bf16 at 989 TFLOP/s, float32 at "
                         "67 TFLOP/s)",
        prefill_bound_share=ops_ms / timing["prefill_ms"],
        decode_batch=B, decode_position=S,
        decode_ms_per_step=timing["decode_ms_per_step"],
        decode_wall_ms_per_step=timing["decode_wall_ms_per_step"],
        decode_bytes=bounds["decode_bytes"],
        decode_bound_ms=bounds["decode_bytes"] / HBM_BYTES_PER_S * 1e3,
        decode_bound_by="bytes (every weight the step reads, its caches "
                        "or states read once, states written once, "
                        "3.35 TB/s)",
        device_ms_per_step=device_ms,
        device_busy_share=device_ms / timing["decode_ms_per_step"]
        if device_ms != "not measured" else "not measured",
        device_events_per_step=prof["device_events_per_step"],
        cuda_launch_kernel_calls_per_step=prof[
            "cuda_launch_kernel_calls_per_step"],
        top_device_us_per_step=prof["top_device_us_per_step"][:5])


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def decode_vs_prefill(model, params, batch: dict, x: int) -> dict:
    """(a) At full width: decode_step of token x at position S after a
    prefill of one row of S tokens, against the last logits of a prefill
    of the S + 1 tokens; for xLSTM, whose prefill returns a fresh state,
    decode token by token from init_state over the S + 1 tokens against
    forward's last logits."""
    S = batch["tokens"].shape[1]
    dev = batch["tokens"].device
    tok = torch.tensor([x], device=dev)
    longer = dict(batch, tokens=torch.cat([batch["tokens"], tok[None]], 1))
    if model.cfg.family == "xlstm":
        states = xlstm.init_state(model.cfg, 1, model.cfg.param_dtype, dev)
        for t in range(S + 1):
            decode, states = model.decode_step(
                params, longer["tokens"][:, t], states, t)
        full = model.forward(params, longer)[:, -1]
    else:
        _, caches = model.prefill(params, batch)
        decode, _ = model.decode_step(params, tok,
                                      _grow(model, caches, S + 1), S)
        full, _ = model.prefill(params, longer)
    top2 = torch.topk(full.float(), 2, -1).values[0]
    return dict(position=S, token=x,
                max_abs_gap=float((decode.float() - full.float()).abs().max()),
                rel_gap=rel_gap(decode, full),
                top2_margin=float(top2[0] - top2[1]),
                largest_logit=float(full.float().abs().max()),
                same_greedy_token=int(decode.argmax()) == int(full.argmax()))


def cut_vs_cpu(model, params, seed: int, dev) -> dict:
    """(b) A depth cut of the same weights in float32 on both sides, TF32
    off: the card's prefill logits and one decode step (the CPU's greedy
    token) against the port's on the CPU."""
    cfg = model.cfg
    layers, B, S = FAMILY_CUTS[cfg.family]
    cut = dataclasses.replace(cfg, num_layers=layers,
                              param_dtype=torch.float32)
    if cfg.family == "encdec":
        cut = dataclasses.replace(cut, encoder_layers=layers)
        sub = dict(params, encoder=params["encoder"][:layers],
                   decoder=params["decoder"][:layers])
    else:
        sub = dict(params, layers=params["layers"][:layers])
    m = get_model(cut)
    rng = np.random.default_rng(seed + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    card_batch = {k: v if k == "tokens" else v.float() for k, v in
                  family_batch(m, toks, seed + 3).items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for name, d in (("cpu", "cpu"), ("cuda", dev)):
            p = tree_map(lambda t: t.to(device=d, dtype=torch.float32), sub)
            b = {k: v.to(d) for k, v in card_batch.items()}
            logits, caches = m.prefill(p, b)
            nxt = torch.argmax(outs["cpu"][0] if name == "cuda" else logits,
                               -1).to(d)
            step, _ = m.decode_step(p, nxt, _grow(m, caches, S + 1), S)
            outs[name] = [logits.float().cpu(), step.float().cpu()]
            del p, b, caches
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gaps = [rel_gap(g, w) for g, w in zip(outs["cuda"], outs["cpu"])]
    check(max(gaps) <= FAMILY_CARD_VS_CPU_REL,
          f"{cfg.name}: card against CPU {gaps} of the largest logit > "
          f"{FAMILY_CARD_VS_CPU_REL}")
    return dict(layers=layers, batch=B, tokens=S, dtype="float32",
                tf32=False, rel_gap_prefill=gaps[0], rel_gap_decode=gaps[1],
                tolerance_rel=FAMILY_CARD_VS_CPU_REL)


def family_numerics(model, params, pool: list, seed: int, dev) -> dict:
    """(a) and (b) for one family, each checked against its tolerance
    (vlm's (a) is printed, not gated)."""
    cfg = model.cfg
    rng = np.random.default_rng(seed + 2)
    x = int(rng.integers(0, cfg.vocab_size))
    S = WHISPER_TOKENS if cfg.family == "encdec" else SERVE_PROMPT
    tokens = torch.as_tensor(pool[1][None, :S].astype(np.int64), device=dev)
    a = decode_vs_prefill(model, params, family_batch(model, tokens, seed),
                          x)
    tol = {"vlm": None, "xlstm": XLSTM_DECODE_VS_FORWARD_REL}.get(
        cfg.family, FAMILY_DECODE_VS_PREFILL_REL)
    a["tolerance_rel"] = tol if tol is not None else "not gated"
    if tol is not None:
        check(a["rel_gap"] <= tol,
              f"{cfg.name}: decode against prefill {a['rel_gap']} of the "
              f"largest logit > {tol}")
        check(a["top2_margin"] <= tol * a["largest_logit"]
              or a["same_greedy_token"],
              f"{cfg.name}: decode and prefill pick other tokens where the "
              "margin exceeds the tolerance")
    return dict(decode_vs_prefill=a, card_vs_cpu=cut_vs_cpu(model, params,
                                                             seed, dev))


def phase_serve_recurrent(seed: int, arch: str, dev) -> dict:
    """`serve`'s stream through the governed, traced engine at the full
    size of a recurrent family (RecurrentGemma, xLSTM): a cache of four
    512-token blobs (the reference's blob, row b of every layer's first
    cache tensor; the 2304-token prompt's is as large, since the window or
    the state caps it). Every billing check of `serve`, the bill equal to
    the host rehearsal (`rehearse`), no kernel launched; prefill and
    decode timed and profiled beside their bounds; the family's numerics.
    The weights are freed at the end."""
    t_phase = time.perf_counter()
    model, params, setup = serve_setup(seed, dev, arch)
    cfg = model.cfg
    V = cfg.vocab_size
    pool, _, rounds = serve_requests(seed, V)
    capacity = 4 * blob_bytes(cfg, SERVE_PROMPT)
    predicted = rehearse(cfg, seed, capacity)
    tracer, events = Tracer(), EventLog()
    engine = ServeEngine(model, params, prefix_cache_bytes=capacity,
                         policy="gdsf", govern=True,
                         governor_window=SERVE_WINDOW, tracer=tracer,
                         events=events)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    round_s, _ = serve_rounds(engine, rounds, V)
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"{arch} launched kernels: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    bill = billing_checks(engine, tracer, events, cfg, rounds, capacity)
    store, cache, audit = engine.store, engine.cache, bill["audit"]
    check(cache.meter.dollars == predicted["dollars"]
          and bill["kinds"] == predicted["events"],
          f"{arch}: bill {cache.meter.dollars!r} {bill['kinds']}, the "
          f"rehearsal's {predicted['dollars']!r} {predicted['events']}")
    rid = sum(len(rnd) for rnd in rounds)
    again = [engine.serve([Request(rid + i, pool[0], SERVE_NEW)])[0].output
             for i in range(2)]
    check(np.array_equal(*again), f"one prompt, two outputs: {again}")
    tokens = torch.as_tensor(np.stack(pool[:SERVE_PER_ROUND]).astype(np.int64),
                             device=dev)
    report = model_report(model, params, {"tokens": tokens}, steps=16)
    numerics = family_numerics(model, params, pool, seed, dev)
    emit("serve_hybrid" if cfg.family == "hybrid" else "serve_xlstm",
         arch=arch, family=cfg.family, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=V, window=cfg.window,
         params=setup["params"], param_bytes=setup["param_bytes"],
         param_gib=setup["param_bytes"] / 2**30, init_s=setup["init_s"],
         reduced=None, price=SERVE_PRICE, cache_bytes=capacity,
         blob_bytes={"pool": blob_bytes(cfg, SERVE_PROMPT),
                     "long": blob_bytes(cfg, SERVE_LONG)},
         rounds=SERVE_ROUNDS, requests=rid, round_s=round_s,
         peak_device_gib=peak_gib, launches=launches,
         gets=store.meter.gets, hits=cache.hits, misses=cache.misses,
         dollars=cache.meter.dollars, rehearsal_dollars=predicted["dollars"],
         events=bill["kinds"], policy=cache.policy,
         swaps=len(engine.governor.swaps), audit=audit.summary(),
         dollar_regret=audit.dollar_regret,
         opt_dollars=[audit.opt_dollars_lower, audit.opt_dollars_upper],
         host_replay_equal=True, span_dollars=bill["span_dollars"],
         repeat_tokens_equal=True, **report,
         seconds=time.perf_counter() - t_phase)
    del engine, model, params
    torch.cuda.empty_cache()
    return numerics


def phase_model(seed: int, arch: str, dev, layers: int | None = None) -> dict:
    """A family the engine cannot serve (it prefills tokens alone, as the
    reference's does) through `ModelApi`: prefill of four rows (vlm: 512
    positions, the first 256 vision embeddings; whisper: 1500 frames and
    448 decoder tokens), then MODEL_DECODE_STEPS greedy decode steps after
    `_grow`, no kernel launched; timed and profiled beside the bounds; the
    family's numerics. The weights are freed at the end."""
    t_phase = time.perf_counter()
    model, params, setup = serve_setup(seed, dev, arch, layers)
    cfg = model.cfg
    S = WHISPER_TOKENS if cfg.family == "encdec" else SERVE_PROMPT
    pool, _, _ = serve_requests(seed, cfg.vocab_size)
    tokens = torch.as_tensor(np.stack(pool[:SERVE_PER_ROUND])[:, :S]
                             .astype(np.int64), device=dev)
    batch = family_batch(model, tokens, seed)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    logits, caches = model.prefill(params, batch)
    caches = _grow(model, caches, S + MODEL_DECODE_STEPS)
    for step in range(MODEL_DECODE_STEPS + 1):
        check(logits.shape == (SERVE_PER_ROUND, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{arch}: bad logits after {step} decode steps")
        if step < MODEL_DECODE_STEPS:
            logits, caches = model.decode_step(
                params, torch.argmax(logits, -1), caches, S + step)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"{arch} launched kernels: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del caches
    report = model_report(model, params, batch, steps=MODEL_DECODE_STEPS)
    numerics = family_numerics(model, params, pool, seed, dev)
    full = get_config(arch)
    emit("model_vlm" if cfg.family == "vlm" else "model_whisper",
         arch=arch, family=cfg.family, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         inputs={k: list(v.shape) for k, v in batch.items()},
         params=setup["params"], param_bytes=setup["param_bytes"],
         param_gib=setup["param_bytes"] / 2**30, init_s=setup["init_s"],
         reduced=None if layers is None else dict(
             num_layers=[full.num_layers, layers],
             why="80 layers are 72.7 B parameters, 145 GB in bf16: one "
                 "80 GB card holds 20 (the whole model needs cards "
                 "enough to shard it over)"),
         peak_device_gib=peak_gib, launches=launches, **report,
         seconds=time.perf_counter() - t_phase)
    del model, params, batch
    torch.cuda.empty_cache()
    return numerics


def phase_families(seed: int, dev) -> None:
    """serve_hybrid, serve_xlstm, model_vlm and model_whisper, each on its
    own weights, then the four families' numerics on one line."""
    numerics = {HYBRID_ARCH: phase_serve_recurrent(seed, HYBRID_ARCH, dev),
                XLSTM_ARCH: phase_serve_recurrent(seed, XLSTM_ARCH, dev),
                VLM_ARCH: phase_model(seed, VLM_ARCH, dev, VLM_LAYERS),
                WHISPER_ARCH: phase_model(seed, WHISPER_ARCH, dev)}
    emit("families_numerics", **numerics,
         xlstm_reference_gap=XLSTM_REFERENCE_GAP)


# ---------------------------------------------------------------------------
# training (slice 8): xlstm-125m trained and resumed, phi4-mini-3.8b at full
# width, and float32 cuts of four families against the CPU

TRAIN_ARCH, DENSE_ARCH = "xlstm-125m", "phi4-mini-3.8b"
TRAIN_PARAMS, DENSE_PARAMS = 112_703_232, 4_450_618_368
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 40, 8, 128    # examples/train_100m.py
TRAIN_PRICE = "gcs_internet"
# at 128 tokens the reference's own xLSTM gradients are not finite (a
# chunk's masked exp overflows, 0 * inf in the backward: ROADMAP queue 3,
# item 8; `tools/xlstm_train_nan.py`); a second run at 64 tokens, where
# they are, is the finite training run
TRAIN_FINITE_SEQ = 64
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 12, 4, 9  # test_fault_tolerance.py
RESUME_FROM = RESUME_FAIL // RESUME_EVERY * RESUME_EVERY
DENSE_BATCH, DENSE_SEQ, DENSE_STEPS = 4, 512, 3
# training tolerances, fixed before the first chip run:
# (a) loss_fn against F.cross_entropy of forward's logits (an oracle only):
#     xLSTM in bf16 with float32 logits, the same logits on both sides, so
#     rel 1e-5; phi4 rel 2^-6 (bf16).
# (b) train_numerics, float32 cuts on both sides, TF32 off, the card against
#     the port on the CPU: the loss rel 2^-12, each gradient leaf's max |Δ|
#     within 2^-12 of its max |g_cpu| (as families_numerics (b)); one
#     update of each optimizer on the same parameters and the CPU's
#     gradients: each leaf's max |Δ| within 2^-16 of its max |p| (the step
#     is lr (1e-3) times an O(1) update: float32 roundings of p and of the
#     update stay far inside).
TRAIN_ORACLE_REL = 1e-5
DENSE_ORACLE_REL = 2.0 ** -6
TRAIN_CARD_VS_CPU_REL = 2.0 ** -12
OPTIM_CARD_VS_CPU_REL = 2.0 ** -16
# train_numerics' cuts: layers, batch, tokens (xLSTM at 64, see above; one
# local-attention layer in RecurrentGemma's three)
TRAIN_CUTS = {"phi4-mini-3.8b": (2, 2, 128), "qwen2-moe-a2.7b": (2, 2, 128),
              "xlstm-125m": (2, 2, 64), "recurrentgemma-9b": (3, 2, 128)}
# the update check runs on each leaf's first rows, up to 2^22 elements: on
# whole leaves the three optimizers' float32 updates of the vocabulary
# leaves and expert stacks (up to 1.05 B elements) took the card's 8-core
# host 361 s for the four cuts; every layer matrix keeps over 1,000 rows,
# so Adafactor's factored path still runs
UPDATE_LEAF_ELEMENTS = 2 ** 22


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (CUBLAS_WORKSPACE_CONFIG is set
    at import, before CUDA starts), restored on the way out. Their filling
    of every new uninitialised tensor (a guard against reading one, which
    this code does not do; the bit-identity checks would show it) is left
    off: it cost ~9,000 launches a step."""
    import torch.utils.deterministic as det
    was = (torch.are_deterministic_algorithms_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        det.fill_uninitialized_memory = was[1]


def train_pipeline(B: int, S: int, vocab: int, price: str = TRAIN_PRICE,
                   shards: int = 64, shard_tokens: int | None = None,
                   capacity: int | None = None) -> tuple:
    """examples/train_100m.py's billed data path: `shards` shards of
    B*S*4 tokens in a store, read through a GDSF cache of 8*B*S*4*4 bytes."""
    shard_tokens = shard_tokens or B * S * 4
    store = ObjectStore(price)
    ds = ShardedTokenDataset(store, num_shards=shards,
                             shard_tokens=shard_tokens, vocab=vocab).register()
    cache = EgressCache(store, capacity_bytes=capacity or 8 * B * S * 4 * 4,
                        policy="gdsf")
    return store, cache, DataPipeline(ds, cache, batch_size=B, seq_len=S)


def data_checks(store, cache, steps: int, B: int, S: int, vocab: int,
                **pipe_kw) -> dict:
    """The data path's bill after `steps` batches: GETs = misses, the
    store's dollars = the cache's, OPT ≤ the bill × (1 + 1e-5), and the bill
    equal bit for bit to the same pipeline pulled on the host alone."""
    bill = cache.meter.dollars
    check(store.meter.gets == cache.misses > 0,
          f"{store.meter.gets} GETs for {cache.misses} misses")
    check(store.meter.dollars == bill,
          f"store ${store.meter.dollars!r}, cache ${bill!r}")
    audit = cache.audit()
    check(audit.opt_dollars_lower <= bill * (1 + 1e-5),
          f"OPT {audit.opt_dollars_lower} above the bill {bill}")
    h_store, h_cache, h_pipe = train_pipeline(B, S, vocab, **pipe_kw)
    for _ in range(steps):
        h_pipe.next_batch()
    check(h_cache.meter.dollars == bill
          and (h_cache.hits, h_cache.misses) == (cache.hits, cache.misses),
          f"host pipeline ${h_cache.meter.dollars!r}, training ${bill!r}")
    return dict(dollars=bill, gets=store.meter.gets, hits=cache.hits,
                misses=cache.misses, opt_dollars=[audit.opt_dollars_lower,
                                                  audit.opt_dollars_upper],
                dollar_regret=audit.dollar_regret, audit=audit.summary(),
                host_pipeline_dollars=h_cache.meter.dollars)


def first_batch(B: int, S: int, vocab: int, dev) -> dict:
    """The pipeline's first batch, pulled on the host alone."""
    _, _, pipe = train_pipeline(B, S, vocab)
    return {k: torch.as_tensor(v, device=dev)
            for k, v in pipe.next_batch().items()}


def loss_oracle(model, params, batch: dict) -> dict:
    """`loss_fn` against F.cross_entropy of `forward`'s logits."""
    V = model.cfg.vocab_size
    with torch.no_grad():
        loss = float(model.loss_fn(params, batch))
        logits = model.forward(params, batch)
        xent = float(F.cross_entropy(logits[:, :-1].reshape(-1, V),
                                     batch["labels"][:, 1:].reshape(-1)
                                     .long()))
    return dict(loss_fn=loss, cross_entropy=xent,
                rel_gap=abs(loss - xent) / abs(xent))


def step_profile(step, params, opt_state, batch: dict) -> dict:
    """Where a train step's time goes: a torch.profiler window over one
    step, recorded after a warm-up step (the profiler loses a trace's first
    events; see `device_time`): device ms and events, host
    `cudaLaunchKernel` calls, the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(
                     p.key_averages())) as prof:
        for _ in range(2):              # warm-up step, recorded step
            t0 = time.perf_counter()
            loss, params, opt_state = step(params, opt_state, batch)
            float(loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    check(bool(traces), "step_profile: the profiler recorded no trace")
    events = [e for e in traces[-1] if not e.key.startswith("ProfilerStep")]
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    top = sorted(on_card, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return dict(
        profiled_wall_ms=wall * 1e3,
        device_ms=sum(e.self_device_time_total for e in on_card) / 1e3
        if on_card else "not measured",
        device_events=sum(e.count for e in on_card),
        cuda_launch_kernel_calls=sum(e.count for e in on_host
                                     if e.key == "cudaLaunchKernel"),
        top_device_ms=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
                       for e in top])


def leaf_bits(tree) -> list:
    return [t.reshape(-1).view(torch.uint8) for t in tree_leaves(tree)]


def same_tree_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaf_bits(a), leaf_bits(b)))


def determinism_cost(model, params, batch: dict, steps: int = 4) -> dict:
    """A step's cost with deterministic algorithms on and off, in turns
    (off, on, on, off; `steps` steps each from the same start, CUDA
    events), and whether two runs with them off gave the same bits."""
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=3e-4))
    step = make_train_step(model, opt, microbatches=2)
    ms, ends = {"off": [], "on": []}, []
    for mode in ("off", "on", "on", "off"):
        with (deterministic() if mode == "on" else contextlib.nullcontext()):
            p, s = params, opt.init(params)
            step(p, s, batch)                       # warm-up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                _, p, s = step(p, s, batch)
            end.record()
            torch.cuda.synchronize()
        ms[mode].append(start.elapsed_time(end) / steps)
        if mode == "off":
            ends.append((p, s))
        del p, s
    return dict(step_ms_deterministic_off=ms["off"],
                step_ms_deterministic_on=ms["on"],
                cost_ms=statistics.mean(ms["on"]) - statistics.mean(ms["off"]),
                off_runs_same_bits=same_tree_bits(ends[0], ends[1]))


def train_run(seed: int, dev, S: int, ckdir: str) -> dict:
    """examples/train_100m.py on the card at xlstm-125m's full size, B x S
    tokens a step: AdamW (lr 3e-4), two microbatches, remat, the billed
    data path, TRAIN_STEPS steps through the driver with deterministic
    algorithms on. Step 0's loss in (0.5, 2.5) ln V and equal to the
    oracle; the data path's bill checked (`data_checks`)."""
    B = TRAIN_BATCH
    model, params, setup = serve_setup(seed, dev, TRAIN_ARCH)
    cfg = model.cfg
    V = cfg.vocab_size
    check(setup["params"] == TRAIN_PARAMS,
          f"{TRAIN_ARCH}: {setup['params']} parameters")
    batch0 = first_batch(B, S, V, dev)
    oracle = loss_oracle(model, params, batch0)
    check(oracle["rel_gap"] <= TRAIN_ORACLE_REL,
          f"loss_fn against the oracle: {oracle}")
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=3e-4))
    step = make_train_step(model, opt, microbatches=2)
    store, cache, pipe = train_pipeline(B, S, V)
    driver = TrainDriver(DriverConfig(checkpoint_dir=ckdir,
                                      checkpoint_every=100,
                                      max_steps=TRAIN_STEPS),
                         step, params, opt.init(params), pipe, device=dev)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with deterministic():
        t0 = time.perf_counter()
        out = driver.run()
        run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"training launched kernels: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = driver.losses
    lnv = math.log(V)
    check(math.isfinite(losses[0]) and 0.5 * lnv < losses[0] < 2.5 * lnv,
          f"step 0's loss {losses[0]} outside (0.5, 2.5) ln V")
    nonfinite = [i for i, x in enumerate(losses) if not math.isfinite(x)]
    step_ms = statistics.median(driver.step_times[5:]) * 1e3
    data = data_checks(store, cache, TRAIN_STEPS, B, S, V)
    with deterministic():
        prof = step_profile(step, driver.params, driver.opt_state,
                            first_batch(B, S, V, dev))
    report = dict(
        batch=B, seq=S, tokens_per_step=B * S, steps=out["steps"],
        loss_step_0=losses[0], loss_step_1=losses[1],
        loss_last=losses[-1], first_nonfinite_step=nonfinite[0]
        if nonfinite else None, oracle=oracle,
        step_ms_median_5_on=step_ms, tokens_per_s=B * S / step_ms * 1e3,
        run_s=run_s, peak_device_gib=peak_gib, launches=launches,
        data=data, profile=prof,
        device_busy_share=prof["device_ms"] / step_ms
        if prof["device_ms"] != "not measured" else "not measured")
    return dict(report=report, model=model, params=params, setup=setup,
                nonfinite=nonfinite)


def phase_train_xlstm(seed: int, dev) -> None:
    """xlstm-125m trained on the card: the example's 8 x 128 tokens a step,
    and 8 x 64, where the reference's gradients are finite (every loss
    finite there); deterministic algorithms' cost on a step."""
    t_phase = time.perf_counter()
    runs = {}
    for S in (TRAIN_SEQ, TRAIN_FINITE_SEQ):
        with tempfile.TemporaryDirectory() as ckdir:
            r = train_run(seed, dev, S, ckdir)
        runs[S] = r
        if S == TRAIN_FINITE_SEQ:
            check(not r["nonfinite"],
                  f"non-finite losses at steps {r['nonfinite']}")
            cost = determinism_cost(r["model"], r["params"],
                                    first_batch(TRAIN_BATCH, S,
                                                r["model"].cfg.vocab_size,
                                                dev))
        setup = r["setup"]
        del r["model"], r["params"]
        torch.cuda.empty_cache()
    emit("train_xlstm", arch=TRAIN_ARCH, params=setup["params"],
         param_bytes=setup["param_bytes"], reduced=None,
         optimizer="adamw lr 3e-4", microbatches=2, remat=True,
         price=TRAIN_PRICE, shards=64, deterministic_algorithms=True,
         example_run=runs[TRAIN_SEQ]["report"],
         finite_run=runs[TRAIN_FINITE_SEQ]["report"],
         determinism=cost, seconds=time.perf_counter() - t_phase)


def phase_train_resume(seed: int, dev) -> None:
    """tests/test_fault_tolerance.py's crash-and-resume at xlstm-125m's
    full size on the card: the test's data (2 x 16 tokens, 4 shards of
    2048 tokens, s3_internet) and AdamW (lr 1e-3), 12 steps, a checkpoint
    every 4, a failure injected at step 9 and a fresh driver resumed from
    step 8: final loss, every parameter and optimizer-state leaf
    bit-identical to an uninterrupted run, and two uninterrupted runs
    alike; deterministic algorithms on. Checkpoints go to a temporary
    directory, removed afterwards."""
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg)
    pipe_kw = dict(price="s3_internet", shards=4, shard_tokens=2048,
                   capacity=4 * 2048 * 4)

    def driver(path, params):
        opt = make_optimizer(OptimizerConfig(name="adamw", lr=1e-3))
        _, _, pipe = train_pipeline(2, 16, cfg.vocab_size, **pipe_kw)
        return TrainDriver(
            DriverConfig(checkpoint_dir=str(path), max_steps=RESUME_STEPS,
                         checkpoint_every=RESUME_EVERY),
            make_train_step(model, opt), params, opt.init(params), pipe,
            device=dev)

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as root, deterministic():
        root = pathlib.Path(root)
        runs = []
        for name in ("ref", "ref2"):
            d = driver(root / name, model.init(seed, device=dev))
            out = d.run()
            runs.append((out, d.params, d.opt_state))
            ck_bytes = sum(f.stat().st_size for f in
                           (root / name / f"step_{RESUME_STEPS:08d}")
                           .iterdir())
            shutil.rmtree(root / name)
            del d
        crash = driver(root / "crash", model.init(seed, device=dev))
        crash.failure = FailureInjector(fail_at=(RESUME_FAIL,))
        try:
            crash.run()
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as e:
            check("injected node failure" in str(e), str(e))
        del crash
        t0 = time.perf_counter()
        resumed = driver(root / "crash", model.init(seed, device=dev))
        check(resumed.resume() and resumed.step == RESUME_FROM,
              f"resumed at step {resumed.step}")
        resume_s = time.perf_counter() - t0
        out = resumed.run()
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"training launched kernels: {launches}")
    (ref_out, ref_p, ref_s), (ref2_out, ref2_p, ref2_s) = runs
    check(ref_out["final_loss"] == ref2_out["final_loss"]
          and same_tree_bits([ref_p, ref_s], [ref2_p, ref2_s]),
          "two uninterrupted runs differ")
    check(out["steps"] == ref_out["steps"] == RESUME_STEPS
          and out["final_loss"] == ref_out["final_loss"]
          and same_tree_bits([ref_p, ref_s],
                             [resumed.params, resumed.opt_state]),
          "the resumed run is not bit-identical to the uninterrupted one")
    leaves = tree_leaves([ref_p, ref_s])
    emit("train_resume", arch=TRAIN_ARCH,
         params=sum(t.numel() for t in tree_leaves(ref_p)), reduced=None,
         steps=RESUME_STEPS, checkpoint_every=RESUME_EVERY,
         failure_at=RESUME_FAIL, resumed_from=RESUME_FROM,
         batch=2, seq=16, deterministic_algorithms=True,
         final_loss=out["final_loss"], resumed_losses=resumed.losses,
         leaves=len(leaves), bit_identical=True,
         uninterrupted_runs_equal=True, checkpoint_bytes=ck_bytes,
         resume_load_s=resume_s, launches=launches,
         seconds=time.perf_counter() - t_phase)
    del runs, ref_p, ref_s, ref2_p, ref2_s, resumed
    torch.cuda.empty_cache()


def dense_train_bounds(cfg, tokens: int, S: int) -> dict:
    """A train step's operations, as the reference computes them: the bf16
    products 8 x matmul_params x tokens (forward 2, remat's second forward
    2, backward 4) and causal attention 4 x forward's; the float32
    unembedding 3 x 2 x tokens x d x V (forward and two backward
    products)."""
    attn = 2 * cfg.num_layers * cfg.num_heads * cfg.hd * tokens * (S + 1)
    bf16 = 8 * matmul_params(cfg) * tokens + 4 * attn
    f32 = 3 * 2 * tokens * cfg.d_model * cfg.vocab_size
    return dict(bf16_flops=bf16, f32_flops=f32,
                bound_ms=(bf16 / BF16_PEAK_FLOPS + f32 / F32_PEAK_FLOPS) * 1e3)


def phase_train_dense(seed: int, dev) -> dict:
    """phi4-mini-3.8b at full width and depth trained on the card:
    Adafactor (the reference's optimizer where float32 Adam moments do not
    fit), remat, two microbatches, a global batch of 4 x 512 tokens from
    the billed pipeline, DENSE_STEPS steps (the first a warm-up); step 0's
    loss finite and equal to the oracle; step ms, device ms and launches
    beside the operations bound; peak memory."""
    t_phase = time.perf_counter()
    model, params, setup = serve_setup(seed, dev, DENSE_ARCH)
    cfg = model.cfg
    check(setup["params"] == DENSE_PARAMS,
          f"{DENSE_ARCH}: {setup['params']} parameters")
    B, S, V = DENSE_BATCH, DENSE_SEQ, cfg.vocab_size
    oracle = loss_oracle(model, params, first_batch(B, S, V, dev))
    check(oracle["rel_gap"] <= DENSE_ORACLE_REL,
          f"loss_fn against the oracle: {oracle}")
    opt = make_optimizer(OptimizerConfig(name="adafactor"))
    step = make_train_step(model, opt, microbatches=2)
    store, cache, pipe = train_pipeline(B, S, V)
    opt_state = opt.init(params)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(DENSE_STEPS):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.next_batch().items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, params, opt_state = step(params, opt_state, batch)
        end.record()
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"training launched kernels: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - oracle["loss_fn"]) <= DENSE_ORACLE_REL
          * abs(oracle["loss_fn"]),
          f"step 0's loss {losses[0]}, loss_fn {oracle['loss_fn']}")
    data = data_checks(store, cache, DENSE_STEPS, B, S, V)
    prof = step_profile(step, params, opt_state, batch)
    bounds = dense_train_bounds(cfg, B * S, S)
    measured = statistics.median(step_ms[1:])
    emit("train_dense", arch=DENSE_ARCH, params=setup["params"],
         param_bytes=setup["param_bytes"], reduced=None,
         optimizer="adafactor lr 3e-4", microbatches=2, remat=True,
         batch=B, seq=S, tokens_per_step=B * S, steps=DENSE_STEPS,
         losses=losses, oracle=oracle, step_ms=step_ms,
         step_ms_after_warmup=measured,
         tokens_per_s=B * S / measured * 1e3, peak_device_gib=peak_gib,
         **bounds, bound_by="operations (bf16 at 989 TFLOP/s, float32 at "
                            "67 TFLOP/s)",
         bound_share=bounds["bound_ms"] / measured, profile=prof,
         device_busy_share=prof["device_ms"] / measured
         if prof["device_ms"] != "not measured" else "not measured",
         data=data, launches=launches,
         seconds=time.perf_counter() - t_phase)
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return dict(peak_gib=peak_gib, **bounds)


def train_cut_vs_cpu(seed: int, arch: str, dev) -> dict:
    """One float32 depth cut at full width, TF32 off, its weights drawn on
    the card and copied to the CPU: the loss and every gradient on the card
    against the port on the CPU, then one update of each optimizer from
    the same parameters and the CPU's gradients, leaf by leaf (each leaf's
    update needs only its own state)."""
    layers, B, S = TRAIN_CUTS[arch]
    cut = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype=torch.float32)
    model = get_model(cut)
    card = model.init(seed + 5, device=dev)
    host = tree_map(lambda t: t.cpu(), card)
    rng = np.random.default_rng(seed + 5)
    toks = torch.as_tensor(rng.integers(0, cut.vocab_size, (B, S)))
    batch = {"tokens": toks, "labels": toks}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        c_loss, c_grads = value_and_grad(
            lambda p, b: model.loss_fn(p, b), card,
            {k: v.to(dev) for k, v in batch.items()})
        float(c_loss)
        t1 = time.perf_counter()
        h_loss, h_grads = value_and_grad(lambda p, b: model.loss_fn(p, b),
                                         host, batch)
        t2 = time.perf_counter()
        loss_gap = abs(float(c_loss) - float(h_loss)) / abs(float(h_loss))
        grad_gaps = [float((c.cpu() - h).abs().max() / h.abs().max())
                     if float(h.abs().max()) > 0 else float(c.abs().max())
                     for c, h in zip(tree_leaves(c_grads),
                                     tree_leaves(h_grads))]
        del c_grads
        check(loss_gap <= TRAIN_CARD_VS_CPU_REL,
              f"{arch}: loss card against CPU {loss_gap}")
        check(max(grad_gaps) <= TRAIN_CARD_VS_CPU_REL,
              f"{arch}: gradients card against CPU {max(grad_gaps)}")
        optim_gaps = {}
        leaves = [(p[:rows], g[:rows]) for p, g in
                  zip(tree_leaves(host), tree_leaves(h_grads))
                  for rows in [max(1, UPDATE_LEAF_ELEMENTS * p.shape[0]
                                   // p.numel())]]
        for name in ("adamw", "adafactor", "sgd"):
            opt = make_optimizer(OptimizerConfig(name=name, lr=1e-3))
            gaps = []
            for p, g in leaves:
                new = [opt.update([g.to(d)], opt.init([p.to(d)]),
                                  [p.to(d)])[0][0].cpu() for d in (dev, "cpu")]
                gaps.append(float((new[0] - new[1]).abs().max()
                                  / p.abs().max()))
            optim_gaps[name] = max(gaps)
            check(max(gaps) <= OPTIM_CARD_VS_CPU_REL,
                  f"{arch}: {name} update card against CPU {max(gaps)}")
        t3 = time.perf_counter()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del card, host
    torch.cuda.empty_cache()
    return dict(layers=layers, batch=B, tokens=S, dtype="float32",
                tf32=False, loss=float(h_loss), rel_gap_loss=loss_gap,
                max_rel_gap_grad=max(grad_gaps), grad_leaves=len(grad_gaps),
                max_rel_gap_update=optim_gaps,
                update_elements=sum(p.numel() for p, _ in leaves),
                card_grad_s=t1 - t0, cpu_grad_s=t2 - t1, update_s=t3 - t2)


def phase_train_numerics(seed: int, dev) -> None:
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    cuts = {arch: train_cut_vs_cpu(seed, arch, dev) for arch in TRAIN_CUTS}
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"training launched kernels: {launches}")
    emit("train_numerics", **cuts, launches=launches,
         reduced=dict(update_leaf_elements=UPDATE_LEAF_ELEMENTS,
                      why="the update check on each leaf's first rows: "
                          "whole vocabulary leaves and expert stacks took "
                          "the 8-core host 361 s"),
         tolerance_rel={"loss": TRAIN_CARD_VS_CPU_REL,
                        "grad": TRAIN_CARD_VS_CPU_REL,
                        "update": OPTIM_CARD_VS_CPU_REL},
         seconds=time.perf_counter() - t_phase)


def phase_training(seed: int, dev) -> dict:
    """The training slice: train_xlstm, train_resume, train_dense,
    train_numerics, each freeing its weights before the next. Returns
    train_dense's peak memory and operations count."""
    phase_train_xlstm(seed, dev)
    phase_train_resume(seed, dev)
    dense = phase_train_dense(seed, dev)
    phase_train_numerics(seed, dev)
    return dense


# ---------------------------------------------------------------------------
# sharding: DTensor parameters on a 1x1 ("data", "model") mesh of the card,
# the stacked layer layout, and the production meshes' dry-run on fake
# devices

# tolerances, fixed before the first chip run. On one rank every
# redistribute is a no-op and the local operations are the plain path's in
# its order, so bit-equality is predicted everywhere; the gates are:
# shard_train: the loss within rel 2^-12, each updated leaf within 2^-16 of
#   its max |p| (train_numerics' update rule);
# shard_moe: equal tokens, every logit within 2^-12 of the max |logit|;
# stacked: the scanned loss and the round trip bit-equal;
# dryrun (a): the counted per-device FLOPs within x[0.99, 1.05] of
#   `dense_train_bounds`' count less the FFN products that remat does not
#   recompute (predicted x1.014: the materialised attention multiplies
#   full S x S blocks, the bound counts the causal half), the counted peak
#   within +-15 % of train_dense's max_memory_allocated in this run;
# dryrun (b): the production cell ok, collectives counted, per-device
#   FLOPs <= 1/16 of the step's global count, taken as the record's
#   `model_flops` (6ND for training, 2ND for inference: the step's useful
#   FLOPs, below its whole count, which adds remat and attention, so the
#   gate is the stricter for it).
SHARD_LOSS_REL = 2.0 ** -12
SHARD_UPDATE_REL = 2.0 ** -16
SHARD_LOGIT_REL = 2.0 ** -12
SHARD_MOE_BATCH, SHARD_MOE_SEQ, SHARD_MOE_STEPS = 4, 512, 8
STACKED_BATCH, STACKED_SEQ = 2, 512
DRYRUN_FLOPS_RATIO = (0.99, 1.05)
DRYRUN_PEAK_REL = 0.15
# the production cells run on the card; phi4-mini-3.8b x train_4k (256
# layer-microbatches on fake tensors) was cut: its step alone took 131-169
# s of the card's host and the phase 182-199 s, past the ~180 s the phase
# may take (its records from those runs are in PERF.md); qwen2-moe-a2.7b
# x decode_32k takes a few seconds
DRYRUN_CELLS = [("qwen2-moe-a2.7b", "decode_32k")]
DRYRUN_TIMEOUT_S = 900


@contextlib.contextmanager
def card_mesh():
    """A 1x1 ("data", "model") DeviceMesh of the card over an nccl group of
    one rank (an in-process store), set as the activation mesh."""
    start_process_group("nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        set_activation_mesh(mesh)
        yield mesh
    finally:
        set_activation_mesh(None)
        stop_process_group()


def on_mesh(tree, shardings):
    """tree's tensors as DTensors by `shardings` on a mesh of one device,
    where a tensor is its own local shard: no copy is made."""
    from torch.distributed.tensor import DTensor

    def one(t, s):
        check(s.mesh.size() == 1, "on_mesh takes a one-device mesh")
        return DTensor.from_local(t, s.mesh, s.placements, run_check=False)
    return tree_zip_map(one, tree, shardings)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def train_steps_ms(step, params, opt_state, batch: dict, n: int) -> tuple:
    """n steps from (params, opt_state), CUDA-event ms each."""
    ms = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, params, opt_state = step(params, opt_state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, params, opt_state


def phase_shard_train(seed: int, dev) -> None:
    """train_dense's step (phi4-mini-3.8b at full width and depth,
    Adafactor, remat, two microbatches, 4 x 512 tokens) twice from the same
    weights and batch: with DTensor parameters, optimizer state and batch
    on the card's 1x1 mesh and `grad_shardings`, then plain. One model on
    the card at a time: the start and the DTensor run's update wait on the
    host. Then three more steps of each, timed and profiled."""
    t_phase = time.perf_counter()
    model, params, setup = serve_setup(seed, dev, DENSE_ARCH)
    cfg = model.cfg
    check(setup["params"] == DENSE_PARAMS,
          f"{DENSE_ARCH}: {setup['params']} parameters")
    B, S, V = DENSE_BATCH, DENSE_SEQ, cfg.vocab_size
    batch = first_batch(B, S, V, dev)
    opt = make_optimizer(OptimizerConfig(name="adafactor"))
    start = tree_map(lambda t: t.cpu(), params)
    runs = {}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with card_mesh() as mesh:
        rules = make_rules(mesh)
        ps, osd, _, _ = train_state_shardings(rules, model, opt)
        step = make_train_step(model, opt, microbatches=2, grad_shardings=ps)
        p = on_mesh(params, ps)
        s = on_mesh(opt.init(params), osd)
        b = on_mesh(batch, batch_spec(rules, batch))
        del params
        t0 = time.perf_counter()
        loss, p1, s1 = step(p, s, b)
        loss = float(loss)
        first_s = time.perf_counter() - t0
        kept = []
        tree_zip_map(lambda t, w: kept.append(
            is_dtensor(t) and t.placements == w.placements), p1, ps)
        check(all(kept), "the DTensor step's parameters left their layout")
        updated = tree_map(lambda t: t.to_local().cpu(), p1)
        del p, s
        ms, p1, s1 = train_steps_ms(step, p1, s1, b, 2)
        prof = step_profile(step, p1, s1, b)
        runs["dtensor"] = dict(loss=loss, first_step_s=first_s, step_ms=ms,
                               profile=prof)
        del p1, s1, b
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.to(dev), start)
    del start
    step = make_train_step(model, opt, microbatches=2)
    t0 = time.perf_counter()
    loss, p1, s1 = step(params, opt.init(params), batch)
    loss = float(loss)
    first_s = time.perf_counter() - t0
    gaps, equal = [], True
    for p, new, dt in zip(tree_leaves(params), tree_leaves(p1),
                          tree_leaves(updated)):
        dt = dt.to(dev)
        equal = equal and torch.equal(new, dt)
        gaps.append(float((new.float() - dt.float()).abs().max()
                          / p.float().abs().max()))
        del dt
    del params, updated
    ms, p1, s1 = train_steps_ms(step, p1, s1, batch, 2)
    prof = step_profile(step, p1, s1, batch)
    runs["plain"] = dict(loss=loss, first_step_s=first_s, step_ms=ms,
                         profile=prof)
    del p1, s1
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"shard_train launched kernels: {launches}")
    loss_gap = abs(runs["dtensor"]["loss"] - loss) / abs(loss)
    check(loss_gap <= SHARD_LOSS_REL, f"loss DTensor against plain {loss_gap}")
    check(max(gaps) <= SHARD_UPDATE_REL,
          f"update DTensor against plain {max(gaps)}")
    bit_equal = equal and runs["dtensor"]["loss"] == loss
    print(f"shard_train: DTensor step bit-equal to the plain step: "
          f"{bit_equal}", flush=True)
    emit("shard_train", arch=DENSE_ARCH, params=setup["params"],
         reduced=None, mesh={"data": 1, "model": 1}, backend="nccl",
         optimizer="adafactor lr 3e-4", microbatches=2, remat=True,
         batch=B, seq=S, grad_shardings=True, bit_equal=bit_equal,
         rel_gap_loss=loss_gap, max_rel_gap_update=max(gaps),
         tolerance_rel={"loss": SHARD_LOSS_REL, "update": SHARD_UPDATE_REL},
         runs=runs, peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches, seconds=time.perf_counter() - t_phase)


def greedy(model, params, batch: dict, steps: int, rules=None) -> tuple:
    """Prefill `batch`, grow the caches and decode `steps` greedy tokens:
    the prefill logits and each step's, and the tokens (B, steps + 1).
    With `rules` the prefill's caches take `kv_cache_sharding`'s layout."""
    S = batch["tokens"].shape[1]
    logits, caches = model.prefill(params, batch)
    if rules is not None:
        caches = tree_zip_map(lambda c, w: c.redistribute(w.mesh,
                                                          w.placements),
                              caches, kv_cache_sharding(rules, caches))
    caches = _grow(model, caches, S + steps)
    out, toks = [whole(logits)], [whole(torch.argmax(logits, -1))]
    tok = torch.argmax(logits, -1)
    for i in range(steps):
        logits, caches = model.decode_step(params, tok, caches, S + i)
        tok = torch.argmax(logits, -1)
        out.append(whole(logits))
        toks.append(whole(tok))
    torch.cuda.synchronize()
    return out, torch.stack(toks, 1)


def phase_shard_moe(seed: int, dev) -> None:
    """qwen2-moe-a2.7b at full width through ModelApi, a 4 x 512 prefill
    and 8 greedy decode steps, with plain weights and with DTensor weights
    on the card's 1x1 mesh (prefill batch and decode tokens placed by
    `batch_spec`, the caches by `kv_cache_sharding`): the routed experts
    through the local region and its token-space sum. Timed and profiled
    both ways."""
    t_phase = time.perf_counter()
    model, params, setup = serve_setup(seed, dev, MOE_ARCH)
    cfg = model.cfg
    check(setup["params"] == MOE_PARAMS,
          f"{setup['params']} parameters, not {MOE_PARAMS}")
    rng = np.random.default_rng(seed + 19)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SHARD_MOE_BATCH, SHARD_MOE_SEQ)), device=dev)
    batch = {"tokens": tokens}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    want, want_tok = greedy(model, params, batch, SHARD_MOE_STEPS)
    timing = {"plain": time_prefill_decode(model, params, batch, steps=8)}
    profile = {"plain": decode_profile(model, params, batch)}
    with card_mesh() as mesh:
        rules = make_rules(mesh)
        dp = on_mesh(params, params_sharding(rules, model.abstract(),
                                             model.axes()))
        db = on_mesh(batch, batch_spec(rules, batch))
        got, got_tok = greedy(model, dp, db, SHARD_MOE_STEPS, rules)
        timing["dtensor"] = time_prefill_decode(model, dp, db, steps=8)
        profile["dtensor"] = decode_profile(model, dp, db)
        del dp, db
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"shard_moe launched kernels: {launches}")
    scale = max(float(w.float().abs().max()) for w in want)
    gap = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want)) / scale
    check(torch.equal(got_tok, want_tok),
          "DTensor weights decoded other tokens")
    check(gap <= SHARD_LOGIT_REL, f"logits DTensor against plain {gap}")
    bit_equal = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"shard_moe: DTensor logits bit-equal to the plain ones: "
          f"{bit_equal}", flush=True)
    emit("shard_moe", arch=MOE_ARCH, params=setup["params"], reduced=None,
         mesh={"data": 1, "model": 1}, backend="nccl",
         batch=SHARD_MOE_BATCH, seq=SHARD_MOE_SEQ,
         decode_steps=SHARD_MOE_STEPS, tokens_equal=True,
         bit_equal=bit_equal, max_rel_gap_logits=gap,
         tolerance_rel=SHARD_LOGIT_REL, timing=timing, profile=profile,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches, seconds=time.perf_counter() - t_phase)
    del params, want, got
    torch.cuda.empty_cache()


def phase_stacked(seed: int, dev) -> None:
    """phi4-mini-3.8b in bf16: `loss_fn_scanned` on the stacked layout
    (`params_to_stacked`, a copy of the 32 layers) against `loss_fn` on
    2 x 512 tokens, and the round trip back to the per-layer layout: both
    bit-equal."""
    t_phase = time.perf_counter()
    model, params, setup = serve_setup(seed, dev, DENSE_ARCH)
    cfg = model.cfg
    batch = first_batch(STACKED_BATCH, STACKED_SEQ, cfg.vocab_size, dev)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        want = model.loss_fn(params, batch)
        sp = transformer.params_to_stacked(cfg, params)
        got = transformer.loss_fn_scanned(cfg, sp, batch)
        back = transformer.stacked_to_params(cfg, sp)
        ms = {}
        for name, fn in (("loss_fn", lambda: model.loss_fn(params, batch)),
                         ("loss_fn_scanned", lambda: transformer
                          .loss_fn_scanned(cfg, sp, batch))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end)
    launches = ops.launch_counts()
    check(launches == NO_LAUNCHES, f"stacked launched kernels: {launches}")
    check(torch.equal(got, want),
          f"scanned loss {float(got)!r}, loss_fn {float(want)!r}")
    a, b = tree_leaves(params), tree_leaves(back)
    check(len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                   for x, y in zip(a, b)),
          "the round trip through the stacked layout changed a leaf")
    stack_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(sp["stack"]))
    emit("stacked", arch=DENSE_ARCH, params=setup["params"], reduced=None,
         batch=STACKED_BATCH, seq=STACKED_SEQ, loss=float(want),
         bit_equal=True, round_trip_exact=True, leaves=len(a),
         stack_leaves=len(tree_leaves(sp["stack"])),
         stack_gib=stack_bytes / 2**30, loss_ms=ms,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches, seconds=time.perf_counter() - t_phase)
    del params, sp, back
    torch.cuda.empty_cache()


def dryrun_worker(part: str, device_type: str = "cuda") -> dict:
    """One part of the dry-run phase, in a process of its own (each starts
    its own default process group): "one_card", train_dense's
    configuration as a one-card cell built from the dry-run's own pieces
    on a 1x1 mesh of a fake group, fake tensors on the card's device type;
    or "arch:shape", a production cell on the 16x16 mesh of 256 fake
    ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    if part != "one_card":
        arch, shape = part.split(":")
        rec = dryrun.run_cell(arch, shape, multi_pod=False,
                              device_type=device_type)
        rec["seconds"] = time.perf_counter() - t0
        return rec
    start_process_group("fake", 1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type)
        set_activation_mesh(mesh)
        model = get_model(get_config(DENSE_ARCH))
        opt = make_optimizer(OptimizerConfig(name="adafactor"))
        rules = make_rules(mesh)
        ps, osd, ap, aos = train_state_shardings(rules, model, opt)
        step = make_train_step(model, opt, microbatches=2, grad_shardings=ps)
        batch = model.train_inputs(DENSE_BATCH, DENSE_SEQ)
        fm = FakeTensorMode(allow_non_fake_inputs=True)
        args = (dryrun.place(fm, ap, ps, device_type),
                dryrun.place(fm, aos, osd, device_type),
                dryrun.place(fm, batch, batch_spec(rules, batch),
                             device_type))
        one_card = dryrun.measure(dryrun.Cell(step, args, {}, {}), fm)
    finally:
        set_activation_mesh(None)
        stop_process_group()
    one_card["seconds"] = time.perf_counter() - t0
    return one_card


def run_workers(parts: list) -> list:
    """`dryrun_worker` on each part, all in parallel subprocesses; each
    one's result, or a failed check. Every process is stopped on the way
    out."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dryrun-worker", part],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for part in parts]
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    out = []
    try:
        for part, proc in zip(parts, procs):
            stdout, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            check(proc.returncode == 0, f"dryrun {part}: {stderr[-3000:]}")
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_dryrun(dense: dict) -> None:
    """The dry-run in subprocesses, one a part, run in parallel
    (`dryrun_worker`): (a) the one-card cell's counted FLOPs against
    `dense_train_bounds`' count and its counted peak against train_dense's
    measured one; (b) the production cell's record. No cell launches a
    kernel (fake tensors)."""
    t_phase = time.perf_counter()
    one, *records = run_workers(["one_card"] + [f"{a}:{s}" for a, s in
                                               DRYRUN_CELLS])
    cfg = get_config(DENSE_ARCH)
    # non-reentrant checkpointing recomputes a layer's forward only as far
    # as its backward needs: the FFN's last product (h @ w2), whose output
    # no gradient reads, is not recomputed (XLA drops it from the
    # reference's remat as dead code alike); the bound counts it
    not_recomputed = (2 * DENSE_BATCH * DENSE_SEQ * cfg.d_model * cfg.d_ff
                      * cfg.num_layers)
    count = dense["bf16_flops"] + dense["f32_flops"] - not_recomputed
    ratio = one["cost"]["flops_per_device"] / count
    peak_rel = one["memory"]["peak_gib"] / dense["peak_gib"] - 1
    check(DRYRUN_FLOPS_RATIO[0] <= ratio <= DRYRUN_FLOPS_RATIO[1],
          f"one-card dry-run FLOPs x{ratio} of dense_train_bounds'")
    check(abs(peak_rel) <= DRYRUN_PEAK_REL,
          f"one-card dry-run peak {one['memory']['peak_gib']} GiB against "
          f"train_dense's {dense['peak_gib']} GiB")
    cells = []
    for rec in records:
        coll = rec["collectives"]
        check(rec["ok"] and coll["total_count"] > 0,
              f"{rec['arch']} x {rec['shape']}: {rec}")
        share = rec["cost"]["flops_per_device"] / rec["model_flops"]
        check(share <= 1 / 16, f"{rec['arch']} x {rec['shape']}: per-device "
                               f"FLOPs {share} of the global count")
        cells.append(dict(rec, per_device_share=share))
    emit("dryrun", one_card=dict(
             arch=DENSE_ARCH, mesh={"data": 1, "model": 1},
             microbatches=2, batch=DENSE_BATCH, seq=DENSE_SEQ,
             flops_per_device=one["cost"]["flops_per_device"],
             analytic_flops=count, bound_flops=count + not_recomputed,
             not_recomputed_flops=not_recomputed, flops_ratio=ratio,
             peak_gib=one["memory"]["peak_gib"], memory=one["memory"],
             measured_peak_gib=dense["peak_gib"], peak_rel_gap=peak_rel,
             collectives=one["collectives"], step_s=one["compile_s"],
             seconds=one["seconds"]),
         cells=cells, roofline_figures="H100 SXM data sheet: 989 TFLOP/s "
         "bf16, 3.35 TB/s, NVLink 450 GB/s a direction; projections, not "
         "measurements",
         tolerance=dict(flops_ratio=DRYRUN_FLOPS_RATIO,
                        peak_rel=DRYRUN_PEAK_REL, per_device_share=1 / 16),
         seconds=time.perf_counter() - t_phase)


def phase_sharding(seed: int, dev, dense: dict) -> None:
    """The sharding slice: shard_train, shard_moe, stacked, dryrun, each
    freeing its weights before the next; each launches every kernel 0
    times."""
    phase_shard_train(seed, dev)
    phase_shard_moe(seed, dev)
    phase_stacked(seed, dev)
    phase_dryrun(dense)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dryrun-worker", metavar="PART",
                    help="run one part of the dryrun phase and print it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.dryrun_worker:
        print(json.dumps(dryrun_worker(args.dryrun_worker)), flush=True)
        return 0
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
    phase_serving(args.seed, dev)
    phase_moe_serving(args.seed, dev)
    phase_families(args.seed, dev)
    dense = phase_training(args.seed, dev)
    phase_sharding(args.seed, dev, dense)
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
