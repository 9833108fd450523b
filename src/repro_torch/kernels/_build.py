"""Build and load the port's CUDA kernels.

Every `.cu` file under `csrc/` is compiled by `nvcc` for `sm_90a` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with `ctypes`. The library lands
in `build/repro_torch_kernels/<hash>/` at the root of the checkout, keyed by
a hash of the sources and flags, at first use; later loads in the same
checkout reuse it. A failed build raises: nothing falls back to the plain
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
_LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_state: dict = {"lib": None}

_vp = ctypes.c_void_p
_SIGNATURES = {
    # scores, is_bf16, touch, mask, out_idx, out_score, rows, n,
    # touch_row_stride, stream
    "evict_argmin_launch": ([_vp, ctypes.c_int, _vp, _vp, _vp, _vp,
                             ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                             _vp], ctypes.c_int),
    # ids, out, global_table, T, n, table_in_shared, stream
    "next_use_launch": ([_vp, _vp, _vp, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, _vp], ctypes.c_int),
    "next_use_max_shared_entries": ([], ctypes.c_int),
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
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _build(target: Path, sources: list[Path]) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(sources, objs)])
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
