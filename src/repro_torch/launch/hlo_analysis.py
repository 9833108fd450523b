"""Per-device cost of one eager step: operations, bytes, collectives and
live memory, counted on each rank's local tensors.

The counterpart of `repro.launch.hlo_analysis`, which parses a compiled
XLA module. This module reads no HLO: PyTorch runs the step eagerly, and
`StepCounter`, a dispatch mode, sees each operation as it runs. Around
DTensor code it steps aside for each DTensor-level operation (returns
NotImplemented), so DTensor desugars it into the local operations and
collectives that one rank runs, and counts those. Counting at the DTensor
level would count the global operation: a product sharded 256 ways would
count 256 times its per-device work. Operations that DTensor's sharding
propagation runs on tensors of its own (shape inference on fake tensors
of another mode, or on meta tensors) are not counted.

What it counts, per device:

* `flops`: `torch.utils.flop_counter`'s formulas (2 m n k a matrix
  product, and the attention and convolution kernels), on local shapes;
  as `FlopCounterMode`, an operation without a formula is decomposed where
  it can be, and otherwise counts none.
* `bytes accessed`: the bytes of each local operation's tensor inputs
  (each distinct tensor once) plus its outputs, with no fusion: every
  elementwise op reads and writes memory. Views (outputs that alias an
  input without writing it) and collectives count none.
* collectives: each `_c10d_functional` collective, by the reference's five
  kind names, with its **result** bytes on this device. Eager execution
  issues every loop trip, so there is no trip multiplication.
* memory: the bytes of live storages, arguments registered beforehand
  (`register`) and every storage an operation creates, freed when its last
  tensor goes; `peak_bytes` is the most at any point of the step.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["CollectiveStats", "StepCounter", "analyze_collectives",
           "cost_analysis_dict", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_kind.values()))


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    """t's storage; a DTensor's is its local shard's."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.untyped_storage()


class StepCounter(TorchDispatchMode):
    """Count a step's local operations (see the module's docstring).
    `fake_mode` is the FakeTensorMode the step's tensors belong to (None
    for real tensors): fake tensors of any other mode are DTensor's own.

        counter = StepCounter(fake_mode)
        counter.register(params, opt_state, batch)
        with counter:
            step(params, opt_state, batch)
    """

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict = defaultdict(float)
        self.coll_count: dict = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._live: dict = {}
        self._arguments: set = set()

    # ---- memory ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        s = _storage(t)
        key = id(s)
        if key in self._live:
            return 0
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(s, self._release, key)
        return n

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def register(self, *trees) -> int:
        """Count the storages of `trees` (DTensors by their local shards)
        as live arguments of the step; returns their bytes."""
        n = sum(self._track(t) for t in _tensors(trees))
        self._arguments.update(id(_storage(t)) for t in _tensors(trees))
        self.argument_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def new_bytes(self, tree) -> int:
        """The bytes of the storages of `tree` (a step's outputs) that are
        not among the registered arguments'."""
        sizes = {id(s): s.nbytes() for s in map(_storage, _tensors(tree))}
        return sum(n for k, n in sizes.items() if k not in self._arguments)

    # ---- dispatch ----------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        for t in tensors:
            if isinstance(t, FakeTensor):
                if t.fake_mode is not self.fake_mode:
                    return True
            elif t.device.type == "meta":
                return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor desugars it for us
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if self._foreign(ins):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not \
                torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._foreign(outs):
            return out
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            if name in COLLECTIVE_KINDS:
                kind = COLLECTIVE_KINDS[name]
                self.coll_bytes[kind] += sum(_nbytes(t) for t in outs)
                self.coll_count[kind] += 1
            elif name not in ("wait_tensor", "_wrap_tensor_autograd"):
                raise NotImplementedError(f"collective {packet} has no kind")
            for t in outs:
                self._track(t)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not _is_view(func):
            seen = {}
            for t in ins:
                seen.setdefault(id(t), _nbytes(t))
            self.bytes_accessed += sum(seen.values()) + sum(
                _nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def _is_view(func) -> bool:
    """Every output aliases an input and none is written: a view (or a
    metadata query)."""
    rets = func._schema.returns
    return all(r.alias_info is not None and not r.alias_info.is_write
               for r in rets) if rets else True


def analyze_collectives(counter: StepCounter) -> CollectiveStats:
    """The collectives a counted step issued, by kind: result bytes on
    this device and counts."""
    return CollectiveStats(dict(counter.coll_bytes), dict(counter.coll_count))


def cost_analysis_dict(counter: StepCounter) -> dict:
    """The counted step's per-device cost under XLA's key names."""
    return {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes_accessed)}
