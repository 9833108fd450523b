"""Build and load the port's CUDA kernels.

Every `.cu` file under `csrc/` is compiled by `nvcc` for `sm_90a` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with `ctypes`. The library lands
in `build/repro_torch_kernels/<hash>/` at the root of the checkout, keyed by
a hash of the sources, the headers they include and the flags, at first
use; later loads in the same checkout reuse it. ptxas' report of each
kernel's registers, shared memory and spills lands beside it, in
`ptxas.log`. A failed build raises: nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")
# diagnostics only: ptxas prints each kernel's resources, the code is the same
PTXAS_REPORT = ("-Xptxas", "-v")
_LIB_NAME = "librepro_torch_kernels.so"
PTXAS_LOG = "ptxas.log"

_lock = threading.Lock()
_state: dict = {"lib": None}

_vp = ctypes.c_void_p
_SIGNATURES = {
    # scores, is_bf16, touch, mask, out_idx, out_score, rows, n,
    # touch_row_stride, stream
    "evict_argmin_launch": ([_vp, ctypes.c_int, _vp, _vp, _vp, _vp,
                             ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                             _vp], ctypes.c_int),
    # ids, T, n, positions, counters, spare, status, status_words, stream
    "next_use_stats_launch": ([_vp, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int, _vp, _vp, _vp, ctypes.c_longlong,
                               _vp], ctypes.c_int),
    # ids, out, rank, buffers, counters, spare, status, T, n, positions,
    # seen, stream
    "next_use_one_wave_launch": ([_vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, _vp, _vp], ctypes.c_int),
    "next_use_one_wave_items": ([], ctypes.c_longlong),
    "next_use_range_word": ([], ctypes.c_int),
    # ids, out, rank, buffers, counters, status, T, passes, tile_items,
    # partition_shift, stream
    "next_use_sort_launch": ([_vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, _vp],
                             ctypes.c_int),
    "next_use_counter_words": ([], ctypes.c_int),
    # deltas, deltas_int32, occ, scratch, T, stream
    "interval_occupancy_launch": ([_vp, ctypes.c_int, _vp, _vp,
                                   ctypes.c_longlong, _vp], ctypes.c_int),
    # deltas, deltas_int32, zcap, occ, excess, scratch, T, stream
    "occupancy_feasible_launch": ([_vp, ctypes.c_int, _vp, _vp, _vp, _vp,
                                   ctypes.c_longlong, _vp], ctypes.c_int),
    "occupancy_scan_scratch_floats": ([ctypes.c_longlong], ctypes.c_longlong),
    "occupancy_scan_error_chain": ([ctypes.c_longlong], ctypes.c_longlong),
    # ids, nxt, rank, weights, costs, c_over_s, neg_cost_floor, sizes,
    # budgets, dollars, hits, work, map_global, slots_global, T, N, Q, P, K,
    # map_shared, slots_shared, dynamic_bytes, stream
    "replay_scan_launch": ([_vp] * 14 + [ctypes.c_int] * 7
                           + [ctypes.c_longlong, _vp], ctypes.c_int),
    "replay_scan_shared_limit": ([], ctypes.c_longlong),
    # ids, nxt, rank, weights, costs, c_over_s, neg_cost_floor, byte_sizes,
    # byte_budgets, dollars, hits, work, map_global, slots_global, bounds,
    # T, N, Q, P, K, map_shared, slots_shared, dynamic_bytes, stream
    "replay_bytes_launch": ([_vp] * 15 + [ctypes.c_int] * 7
                            + [ctypes.c_longlong, _vp], ctypes.c_int),
    "replay_bytes_shared_limit": ([], ctypes.c_longlong),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their output, or raise if one failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def _build(target: Path, sources: list[Path]) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        outs = _run([[nvcc, *NVCC_FLAGS, *PTXAS_REPORT, "-c", str(src),
                      "-o", str(obj)] for src, obj in zip(sources, objs)])
        (target.parent / PTXAS_LOG).write_text("".join(
            f"== {src.name}\n{out}" for src, out in zip(sources, outs)))
        staged = Path(tmp) / _LIB_NAME
        _run([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
               "-o", str(staged)]])
        os.replace(staged, target)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from `csrc/` on first use."""
    with _lock:
        if _state["lib"] is None:
            sources = _sources()
            target = BUILD_ROOT / _key(sources) / _LIB_NAME
            if not target.exists():
                _build(target, sources)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _state["lib"] = lib
        return _state["lib"]
