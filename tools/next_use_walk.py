"""Time a next_use source with the one-warp walk's C interface beside the
port's next_use on the same ids, on one NVIDIA GPU.

    python3 tools/next_use_walk.py WALK.cu

WALK.cu exposes `next_use_launch(ids, out, table, T, n, table_in_shared,
stream)` and `next_use_max_shared_entries()`, the interface of the design
that src/repro_torch/kernels/csrc/next_use.cu replaced (one warp walks the
trace backwards against a last-seen table; see that file's history). The
script builds WALK.cu with the port's nvcc flags (under
build/repro_torch_kernels/), checks its output against
next_use_cuda on replay_full's trace (twemcache_like, 200,000 requests over
20,000 objects) and on 2^26 uniform ids over 2^22 objects, and prints one
JSON line per shape with both device times (torch.profiler, as
chip_smoke.py's kernels line), then the card's name and power limit. It
exits non-zero without a card or if the outputs differ.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core import twemcache_like  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.next_use import next_use_cuda  # noqa: E402


def load_walk(source: str) -> ctypes.CDLL:
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    out = os.path.join(tempfile.mkdtemp(dir=_build.BUILD_ROOT), "walk.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", source,
                    "-o", out], check=True)
    lib = ctypes.CDLL(out)
    vp = ctypes.c_void_p
    lib.next_use_launch.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, vp]
    lib.next_use_launch.restype = ctypes.c_int
    lib.next_use_max_shared_entries.restype = ctypes.c_int
    return lib


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.splitlines()[2], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("next_use_walk: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    walk = load_walk(sys.argv[1])
    tr = twemcache_like(n_objects=20000, n_requests=200_000, seed=1)
    shapes = [("replay_full's trace (Zipf)",
               torch.tensor(tr.ids.astype(np.int32), device=dev), 20_000),
              ("uniform, cold",
               chip_smoke.uniform_ids(1, chip_smoke.NU_BYTES_T,
                                      chip_smoke.NU_BYTES_N, dev),
               chip_smoke.NU_BYTES_N)]
    stream = torch.cuda.current_stream().cuda_stream
    for label, ids, n in shapes:
        T = ids.numel()
        out = torch.empty_like(ids)
        in_shared = int(n <= walk.next_use_max_shared_entries())
        table = torch.empty(0 if in_shared else n, dtype=torch.int32,
                            device=dev)

        def run_walk():
            err = walk.next_use_launch(ids.data_ptr(), out.data_ptr(),
                                       table.data_ptr(), T, n, in_shared,
                                       stream)
            chip_smoke.check(err == 0, f"walk launch failed: {err}")

        run_walk()
        chip_smoke.check(torch.equal(out, next_use_cuda(ids, n)),
                         f"the walk and next_use_cuda differ: {label}")
        print(json.dumps({
            "T": T, "N": n, "data": label,
            "walk_device_ms": chip_smoke.device_time(run_walk, reps=2)["ms"],
            "next_use_device_ms": chip_smoke.device_time(
                lambda: next_use_cuda(ids, n))["ms"]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
