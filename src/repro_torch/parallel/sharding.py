"""Logical-axis -> mesh-axis sharding rules (FSDP + TP, divisibility-aware)
onto a `DeviceMesh` and DTensor placements.

The port of `repro.parallel.sharding`, with the reference's rules.
Parameters declare logical axes (`models/common.ParamDef`); this module
maps them onto the mesh's named axes:

  embed           -> FSDP over ("pod", "data")   (ZeRO-3 style)
  heads/kv_heads/
  mlp/vocab       -> tensor-parallel over "model"
  expert          -> replicated in the baseline; "model" under
                     expert-parallelism (moe_ep)

Every rule is divisibility-checked against the actual dimension: if a dim
does not divide by the mesh-axes product the rule drops leading axes, then
gives up to None (replicated). kv_heads smaller than the TP width therefore
replicate, and the KV-cache *sequence* axis picks up the TP sharding
instead (see `kv_cache_sharding`).

A spec is a `PartitionSpec`: one entry per tensor dim, each None, a mesh
axis name or a tuple of names, as JAX's. DTensor's placements run the
other way, one per *mesh* dim naming the tensor dim it shards
(`placements`). Where several mesh axes shard one tensor dim, DTensor
splits it in mesh-dim order, outermost first, so a spec's tuple must list
its axes in the mesh's order to give JAX's local shards; every rule here
does, and `placements` refuses a tuple that does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

from ..models.common import tree_map, tree_zip_map

__all__ = ["PartitionSpec", "NamedSharding", "ShardingRules", "make_rules",
           "params_sharding", "batch_spec", "kv_cache_sharding",
           "mesh_axis_size", "placements"]


class PartitionSpec(tuple):
    """Per-tensor-dim mesh axes, equal entry by entry to JAX's
    `PartitionSpec` (a tuple of None, names and tuples of names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any object with an
    `axis_names` tuple and a `shape` dict (the rules' tests use such)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def mesh_axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements on `mesh` for a spec: Shard(d) on each mesh dim
    that shards tensor dim d, Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}: DTensor would split the dim "
                             f"in another order than the spec")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of JAX's `NamedSharding`, with
    the DTensor placements it stands for."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


class ShardingRules:
    def __init__(self, mesh, rules: dict[str, Any], dp_axes):
        self.mesh = mesh
        self.rules = rules
        self.dp_axes = dp_axes  # axes the batch is sharded over

    def _fit(self, dim: int, axes) -> Optional[Any]:
        """Return axes (possibly shortened) that evenly divide dim.

        Axis tuples are ordered smallest-first (("pod","data")): when the
        full product doesn't divide, drop the *leading* (small) axes so the
        fallback keeps the widest parallelism (e.g. 16 rows on a 2x16
        ("pod","data") axis shard 16-way over "data", not 2-way over "pod").
        """
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        while axes:
            if dim % mesh_axis_size(self.mesh, axes) == 0:
                return axes if len(axes) > 1 else axes[0]
            axes = axes[1:]
        return None

    def spec_for(self, shape: Sequence[int],
                 logical: Sequence[Optional[str]]) -> PartitionSpec:
        used: set[str] = set()
        out = []
        for dim, name in zip(shape, logical):
            axes = self.rules.get(name) if name else None
            axes = self._fit(dim, axes)
            # a mesh axis may appear only once per spec
            if axes is not None:
                flat = (axes,) if isinstance(axes, str) else tuple(axes)
                if any(a in used for a in flat):
                    axes = None
                else:
                    used.update(flat)
            out.append(axes)
        return P(*out)


def make_rules(mesh, *, moe_ep: bool = False) -> ShardingRules:
    """Default FSDP+TP rules for this mesh (single- or multi-pod)."""
    names = axis_names(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    rules = {
        "embed": fsdp,
        "vocab": tp,
        "heads": tp,
        "kv_heads": tp,
        "mlp": tp,
        "expert": tp if moe_ep else None,
    }
    if moe_ep:
        # expert-parallel: experts over "model"; expert matrices FSDP only
        rules = dict(rules, expert=tp, mlp=fsdp)
    return ShardingRules(mesh, rules, dp_axes=fsdp)


def params_sharding(rules: ShardingRules, abstract_params, axes_tree):
    """NamedSharding tree matching the (abstract) parameter tree."""
    return tree_zip_map(
        lambda p, axes: NamedSharding(rules.mesh,
                                      rules.spec_for(p.shape, axes)),
        abstract_params, axes_tree)


def batch_spec(rules: ShardingRules, abstract_batch):
    """Input batch: leading (batch) dim over the DP axes when divisible."""
    def one(x):
        axes = rules._fit(x.shape[0], rules.dp_axes)
        return NamedSharding(rules.mesh, P(*([axes] + [None] * (x.ndim - 1))))
    return tree_map(one, abstract_batch)


def kv_cache_sharding(rules: ShardingRules, abstract_caches):
    """Decode caches. 4D KV tensors (B, S, G, hd): batch over DP when
    divisible; G over TP when divisible, otherwise the *sequence* axis picks
    up TP (flash-decode style). Caches of S < 8192 keys whose G does not
    divide replicate: that beats the resharding traffic of a TP-sharded
    shift cache. A batch of one with a long sequence spreads the sequence
    over every axis. Low-rank recurrent states (B, ...): batch over DP,
    the rest replicated.
    """
    mesh = rules.mesh
    tp = rules.rules.get("heads")

    def one(x):
        baxes = rules._fit(x.shape[0], rules.dp_axes)
        if x.ndim == 4:
            B, S, G, hd = x.shape
            gaxes = rules._fit(G, tp)
            if gaxes is None and S < 8192:
                return NamedSharding(mesh, P(baxes, None, None, None))
            if gaxes is None:
                saxes = rules._fit(S, tp)
                if baxes is None and saxes is not None:
                    dp = ((rules.dp_axes,) if isinstance(rules.dp_axes, str)
                          else rules.dp_axes)
                    all_axes = rules._fit(
                        S, tuple(a for a in (*dp, tp) if a is not None))
                    return NamedSharding(mesh, P(None, all_axes, None, None))
                return NamedSharding(mesh, P(baxes, saxes, None, None))
            return NamedSharding(mesh, P(baxes, None, gaxes, None))
        # (B, d) recurrent state, (B, w, d) conv state, (B, H, hd),
        # (B, H, hd, hd) mLSTM matrix state
        return NamedSharding(mesh, P(*([baxes] + [None] * (x.ndim - 1))))
    return tree_map(one, abstract_caches)


def distribute(tree, shardings):
    """Place each tensor of `tree` (whole, on one process) as a DTensor by
    its NamedSharding in `shardings` (a tree of the same structure)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_zip_map(
        lambda t, s: distribute_tensor(t, s.mesh, s.placements),
        tree, shardings)
