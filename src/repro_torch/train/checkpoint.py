"""Atomic, resumable checkpoints, in the reference's on-disk layout.

Layout:  <dir>/step_<N>.tmp/...   (write)
         <dir>/step_<N>/          (atomic rename on completion)
           manifest.json           {step, leaf paths, shapes, dtypes, extra}
           arr_<k>.npy             one file per tree leaf

The port of `repro.train.checkpoint`. Leaves are numbered in JAX's order
(dict keys sorted, list items in order) and each `path` is written as
`jax.tree_util.keystr` writes it (`['params']['layers'][0]['wq']`), by this
module's own code; a bfloat16 leaf is stored as its uint16 bit pattern
with `"dtype": "bfloat16"`. So a checkpoint written by either package
loads in the other.
"""
from __future__ import annotations

import json
import pathlib
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..core import resolve_device
from ..models.convert import tensor_to_numpy

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _flatten_with_paths(tree, path: str = "") -> list:
    """[(keystr path, leaf)] in JAX's leaf order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """`like`'s structure (its own key order) holding `leaves`, which come
    in JAX's leaf order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def save_checkpoint(directory, step: int, tree: Any,
                    extra: Optional[dict] = None) -> pathlib.Path:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step:08d}.tmp"
    final = d / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = tensor_to_numpy(leaf)     # bfloat16 as its uint16 bits
        dtype = "bfloat16" if leaf.dtype == torch.bfloat16 else str(arr.dtype)
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({
            "path": path,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)   # atomic commit
    return final


def latest_step(directory) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and not p.name.endswith(".tmp") \
                and (p / "manifest.json").exists():
            steps.append(int(p.name[5:]))
    return max(steps) if steps else None


def load_checkpoint(directory, step: int, like: Any,
                    device=None) -> tuple[Any, dict]:
    """Restore a tree saved by save_checkpoint.

    `like` (tensors or meta tensors) gives the tree's structure and each
    leaf's shape; the leaves go to `device`, or where None to the `like`
    leaf's device (the card for a meta leaf, unless told otherwise).
    """
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_like = _flatten_with_paths(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: {len(flat_like)} vs "
                         f"{len(manifest['leaves'])}")
    leaves = []
    for (path, leaf), rec in zip(flat_like, manifest["leaves"]):
        arr = np.load(d / rec["file"])
        if rec["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want = tuple(leaf.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{rec['path']}: shape {tuple(t.shape)}, "
                             f"expected {want}")
        dev = device if device is not None else (
            leaf.device if leaf.device.type != "meta" else None)
        leaves.append(t.to(resolve_device(dev)))
    return _unflatten(like, leaves), manifest["extra"]
