"""Time variants of the replay_scan kernel beside the kernel as built, at
chip_smoke.py's two replay shapes, with each cell's cycles, on one NVIDIA GPU.

    python3 tools/replay_scan_variants.py [VARIANT ...]

A variant is src/repro_torch/kernels/csrc/replay_scan.cu with lines
replaced, a comma-separated list of:

    static_off      every evicting step scores in full: rows with w_cb = 0
                    take the path (and the warp rule) of the other rows
    static=ONE/PER  kStaticOne = ONE, kStaticPer = PER
    full=ONE/PER    kFullOne = ONE, kFullPer = PER

(default: static_off, and two settings of each warp rule). Each variant is
compiled with the port's nvcc flags, all at once, under
build/repro_torch_kernels/variants/, and launched through replay_scan_cuda
in place of the built kernel. The shapes are replay_parity's and
replay_full's (twemcache_like, 20,000 requests over 2,000 objects and
200,000 over 20,000, chip_smoke.py's policies, price vectors and budgets,
seed 1). For each shape every variant must give the kernel's dollars and
hits bit for bit; then the kernel, each variant and the kernel again are
timed (chip_smoke.time_ms: the median of 5 CUDA-event windows, the SM clock
sampled beside them by `SmClock`) and print one JSON line each: the time,
the slowest and the median cell (`replay_cells`), the
slowest cell among rows with w_cb = 0 and among the rest, and every cell's
cycles. Then the card's name and power limit. Exits non-zero without a card
or if a variant's results differ.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core import twemcache_like  # noqa: E402
from repro_torch.core.policies_torch import stack_policy_weights  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.replay_scan import (WORK_COLUMNS,  # noqa: E402
                                             replay_scan_cuda)

DEFAULT = ["static_off", "static=640/320", "static=2048/320",
           "full=64/64", "full=256/256"]
SHAPES = {"parity": (2000, 20_000, chip_smoke.PARITY_BUDGETS, 10),
          "full": (20_000, 200_000, chip_smoke.FULL_BUDGETS, 3)}
SEED = 1


class SmClock:
    """The SM clock sampled beside a timing window: `nvidia-smi
    --query-gpu=clocks.sm` every 100 ms while the block runs, stopped when
    it ends. `mhz` holds the samples."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.mhz = [int(x) for x in out.split() if x.strip().isdigit()]
        return False


def replay_cells(work, budgets, T: int) -> dict:
    """Where one replay_scan launch over the (policies x prices x budgets)
    grid spent its cycles, from its work counters: the slowest and the
    median cell by clock64() cycles, each with its evicting steps, the
    cycles from reaching them to their victims (share and per step), and
    the rest (the walk, staging and chunk barriers) per request."""
    w = work.cpu().numpy().reshape(-1, len(WORK_COLUMNS))
    col = {name: w[:, j] for j, name in enumerate(WORK_COLUMNS)}
    shape = (len(chip_smoke.POLICIES), len(chip_smoke.PRICES), len(budgets))
    order = np.argsort(col["cycles"], kind="stable")

    def cell(c: int) -> dict:
        q, p, k = np.unravel_index(c, shape)
        cycles, evict = int(col["cycles"][c]), int(col["evict_cycles"][c])
        steps = int(col["scored_steps"][c])
        return dict(policy=chip_smoke.POLICIES[q],
                    price=chip_smoke.PRICES[p],
                    budget=int(budgets[k]), cycles=cycles,
                    evicting_steps=steps, evict_cycles=evict,
                    evict_share=evict / cycles,
                    cycles_per_evicting_step=evict / steps if steps else None,
                    other_cycles_per_request=(cycles - evict) / T)

    return dict(slowest=cell(int(order[-1])),
                median=cell(int(order[len(order) // 2])),
                cycles_all=col["cycles"].tolist())


def edit(source: str, variant: str) -> str:
    """The kernel's source with `variant`'s lines replaced."""
    for part in variant.split(","):
        name, _, value = part.partition("=")
        if name == "static_off":
            old, new = ("row.static_row = w[5] == 0.0f;",
                        "row.static_row = false;")
        elif name in ("static", "full"):
            one, per = (int(v) for v in value.split("/"))
            k = "kStatic" if name == "static" else "kFull"
            old = next((ln for ln in source.splitlines()
                        if ln.startswith(f"constexpr int {k}One = ")), "")
            new = f"constexpr int {k}One = {one}, {k}Per = {per};"
        else:
            raise SystemExit(f"unknown variant part: {part}")
        if source.count(old) != 1:
            raise SystemExit(f"{part}: the source has no single line {old!r}")
        source = source.replace(old, new)
    return source


def build(variants: list) -> dict:
    """Each variant's library, compiled in parallel."""
    root = _build.BUILD_ROOT / "variants"
    source = (_build.CSRC / "replay_scan.cu").read_text()
    libs, cmds = {}, []
    for i, variant in enumerate(variants):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "replay_scan.cu").write_text(edit(source, variant))
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                     str(_build.CSRC), "-shared", str(d / "replay_scan.cu"),
                     "-o", str(d / "lib.so")])
    _build._run(cmds)
    for i, variant in enumerate(variants):
        lib = ctypes.CDLL(str(root / str(i) / "lib.so"))
        for name in ("replay_scan_launch", "replay_scan_shared_limit"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name]
        libs[variant] = lib
    return libs


@contextlib.contextmanager
def kernel_of(lib):
    """replay_scan_cuda launches `lib`'s kernel (None: the built one)."""
    saved = _build.library()
    _build._state["lib"] = lib or saved
    try:
        yield
    finally:
        _build._state["lib"] = saved


def main() -> int:
    variants = sys.argv[1:] or DEFAULT
    if not torch.cuda.is_available():
        print("replay_scan_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build(variants)
    weights = stack_policy_weights(chip_smoke.POLICIES)
    static_rows = np.repeat(weights[:, 5] == 0,
                            len(chip_smoke.PRICES))   # per (policy, price)
    for shape, (N, T, budgets, reps) in SHAPES.items():
        tr = twemcache_like(n_objects=N, n_requests=T, seed=SEED)
        x = chip_smoke.replay_inputs(weights, tr.ids,
                                     chip_smoke.price_matrix(tr), tr.sizes,
                                     budgets, dev)
        d0, h0, _ = replay_scan_cuda(**x)
        for variant, lib in libs.items():
            with kernel_of(lib):
                d, h, _ = replay_scan_cuda(**x)
            if not (chip_smoke.same_bits(d, d0) and torch.equal(h, h0)):
                raise SystemExit(f"{shape} {variant}: results differ from "
                                 "the kernel's")
        for variant in ["kernel", *variants, "kernel"]:
            with kernel_of(libs.get(variant)):
                _, _, work = replay_scan_cuda(**x)
                with SmClock() as clock:
                    ms = chip_smoke.time_ms(lambda: replay_scan_cuda(**x),
                                            reps=reps, rounds=5)
            cells = replay_cells(work, budgets, T)
            cycles = np.array(cells["cycles_all"]).reshape(len(static_rows),
                                                           len(budgets))
            print(json.dumps(dict(
                shape=shape, T=T, N=N, budgets=budgets.tolist(),
                variant=variant, ms=ms, sm_clock_mhz=clock.mhz,
                slowest=cells["slowest"], median=cells["median"],
                slowest_static_row_cycles=int(cycles[static_rows].max()),
                slowest_other_row_cycles=int(cycles[~static_rows].max()),
                evict_cycles_sum=int(work[..., 4].sum()),
                cycles_sum=int(work[..., 3].sum()),
                cycles=cycles.tolist())), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
