"""Device meshes on `torch.distributed`.

The port of `repro.launch.mesh`:

  single-pod:  (16, 16)      -> ("data", "model")       256 devices
  multi-pod:   (2, 16, 16)   -> ("pod", "data", "model") 512 devices

A `DeviceMesh` needs a default process group of the mesh's size, and a
process has one default group. Importing this module starts none:
`start_process_group` starts the one the caller names, with no network
and no cluster:

  "nccl"  one card, world size 1, an in-process `HashStore`;
  "gloo"  the CPU, world size 1, likewise;
  "fake"  `world_size` ranks of which this process is rank 0, every
          collective a no-op (`torch.testing`'s fake backend): the
          production meshes' dry-run, under fake tensors.
"""
from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh",
           "start_process_group", "stop_process_group", "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def start_process_group(backend: str, world_size: int = 1) -> None:
    """Start this process's default group as rank 0 of `world_size`."""
    if backend == "fake":
        # importing the module registers the backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    elif backend in ("nccl", "gloo"):
        if world_size != 1:
            raise ValueError(f"{backend}: one process, world size 1")
        store = dist.HashStore()
    else:
        raise ValueError(f"backend {backend!r}")
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size)


def stop_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` with named axes over the default group,
    which must have prod(shape) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} on a group of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """(1, n) mesh over the group's n ranks (same axis names)."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device_type)
