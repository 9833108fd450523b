"""Shared model substrate on PyTorch: configs, parameter definitions, layer
primitives.

The port of `repro.models.common`. Every architecture declares its
parameters with `ParamDef`s (`param_defs(cfg)`); `init_params` materialises
them on a device from a `torch.Generator`. The layer primitives repeat the
reference's operations in its order and with its casts: the attention
logits are formed in the parameter dtype and only then taken to float32,
`rms_norm` multiplies the cast-back result by its weight in the parameter
dtype, the rotary products promote to float32 and are cast back. Matrix
products go to `torch.matmul`, as the reference leaves them to XLA. The
training loss `softmax_xent` and the per-layer remat `checkpoint_layer`
(`torch.utils.checkpoint` in place of `jax.checkpoint`) are the
reference's.

Sharding hints (`constrain`, `set_activation_mesh`, `tp_divides`) are
the reference's: with a launcher mesh set they redistribute DTensor
activations (`repro_torch.parallel`); on plain tensors they do nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

DEFAULT_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axis names, len == ndim
    init: str = "normal"              # normal | zeros | ones
    scale: float = 0.02
    dtype: Any = None                 # default -> cfg param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact figures from the assignment table)."""
    name: str
    family: str                   # dense | moe | xlstm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    rope_theta: float = 1e4
    rope_fraction: float = 1.0    # chatglm applies RoPE to half the head dim
    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_expert: int = 0             # routed-expert hidden dim (d_ff of an expert)
    moe_every: int = 1            # 1 = every layer is MoE (layer 0 stays dense
                                  # when first_dense is set)
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # local/global attention (gemma3, recurrentgemma's attn layers)
    window: int = 0               # 0 = full attention
    global_every: int = 0         # gemma3: every Nth layer is global
    # hybrid (recurrentgemma): pattern period 3 -> (rec, rec, attn)
    attn_every: int = 0
    rglru_conv_width: int = 4
    # enc-dec (whisper)
    encoder_layers: int = 0
    cross_attend: bool = False
    # vlm
    num_vision_tokens: int = 0
    mrope_sections: tuple[int, ...] = ()
    # activations / norms
    act: str = "swiglu"           # swiglu | gelu
    logit_softcap: float = 0.0
    # dtypes
    param_dtype: Any = DEFAULT_DTYPE
    # training
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def is_moe_layer(self, layer: int) -> bool:
        if self.num_experts == 0:
            return False
        if layer < self.first_k_dense:
            return False
        return (layer % self.moe_every) == (self.moe_every - 1) \
            if self.moe_every > 1 else True

    def is_global_layer(self, layer: int) -> bool:
        """gemma3: 5 local : 1 global."""
        if self.global_every <= 0:
            return self.window == 0
        return (layer % self.global_every) == (self.global_every - 1)

    def is_attn_layer(self, layer: int) -> bool:
        """recurrentgemma: (rec, rec, attn) repeating."""
        if self.attn_every <= 0:
            return True
        return (layer % self.attn_every) == (self.attn_every - 1)


# ---------------------------------------------------------------------------
# parameter materialization
# ---------------------------------------------------------------------------

def tree_map(fn, tree: Any) -> Any:
    """Apply `fn` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ParamDef):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_zip_map(fn, tree: Any, *others: Any) -> Any:
    """`fn(leaf, *others' entries at the same place)` over the leaves of
    `tree`, into its structure: the others are read by the same keys and
    indices (their insertion order does not matter), and what they hold
    below `tree`'s leaves is handed to `fn` whole."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_zip_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, in its order."""
    out = []
    tree_map(out.append, tree)
    return out


def init_params(defs: Any, generator: torch.Generator, dtype,
                device=None) -> Any:
    """Materialise a ParamDef tree on `device` (the generator's own device
    when None): normal draws in float32 times the scale, then cast; zeros;
    ones. One generator draws every leaf in the tree's order; the values are
    not JAX's (parity tests carry JAX's weights across instead)."""
    device = generator.device if device is None else torch.device(device)

    def make(d: ParamDef) -> torch.Tensor:
        dt = d.dtype or dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * d.scale).to(dt)

    return tree_map(make, defs)


def abstract_params(defs: Any, dtype) -> Any:
    """Meta tensors of a ParamDef tree: shapes and dtypes, no storage."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype,
                                          device="meta"), defs)


def axes_tree(defs: Any) -> Any:
    """The logical axes of a ParamDef tree, one tuple a leaf."""
    return tree_map(lambda d: d.axes, defs)


# ---------------------------------------------------------------------------
# activation sharding hints (set by the launcher; identities without a mesh)
# ---------------------------------------------------------------------------

_ACT_MESH = None


def set_activation_mesh(mesh):
    """Launcher hook: `constrain` hints resolve against this DeviceMesh
    ("pod"/"data" = DP+FSDP, "model" = TP). None disables every hint."""
    global _ACT_MESH
    _ACT_MESH = mesh


def constrain(x, *axes):
    """Redistribute the DTensor x to the spec `axes` on the launcher mesh:
    each entry is a mesh-axis name, a tuple of names, or None. Axes missing
    from the mesh or not dividing the dim are dropped. The identity on a
    plain tensor and when no mesh is set."""
    from torch.distributed.tensor import DTensor
    if _ACT_MESH is None or not isinstance(x, DTensor):
        return x
    from ..parallel.sharding import axis_sizes, placements
    sizes = axis_sizes(_ACT_MESH)
    spec = []
    for dim, ax in zip(x.shape, axes):
        if ax is None:
            spec.append(None)
            continue
        axt = (ax,) if isinstance(ax, str) else tuple(ax)
        axt = tuple(a for a in axt if a in sizes)
        size = math.prod(sizes[a] for a in axt)
        if axt and dim % size == 0:
            spec.append(axt if len(axt) > 1 else axt[0])
        else:
            spec.append(None)
    spec += [None] * (x.ndim - len(spec))
    return x.redistribute(_ACT_MESH, placements(_ACT_MESH, spec))


DP_AXES = ("pod", "data")


def unshard_fsdp(tree):
    """Each DTensor of tree replicated on the data-parallel axes, its
    other placements kept: FSDP's gather of a layer's weights before they
    are used, which is the layout GSPMD gives the reference's FSDP
    products. DTensor's own choice for a product of row-sharded
    activations and FSDP-sharded weights can instead move the activations
    (every rank then holds every row). The gradient's way back is a
    reduce-scatter. Plain tensors pass through."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        pl = [Replicate() if name in DP_AXES else q
              for name, q in zip(mesh.mesh_dim_names, t.placements)]
        return t.redistribute(mesh, pl)
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# local regions: each rank's part of a DTensor computation, on plain tensors
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class Region:
    """The layout of a local region on `mesh`: the rows of the activations
    (their dim 0, B of them) split over the data-parallel axes when those
    divide B (else every rank takes them all), and the tensor-parallel
    axis "model" splitting what the caller names where `tp_split` (else
    replicated). Inside, each rank runs the plain code on its local
    tensors; DTensor sees only the redistributions at the borders.

    `enter(t, rows, tp, grad_rows, grad_tp)` gives t's local tensor in the
    layout (rows on the data-parallel axes, tp on "model") and declares
    its local gradient's layout: partial where every rank's part of the
    computation adds to it. `leave(t, rows, tp)` makes a DTensor of a
    local result."""

    def __init__(self, mesh, B: int, tp_split: bool):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(self.names, mesh.shape))
        dp = math.prod(sizes[a] for a in DP_AXES if a in sizes)
        self.rows = dp > 1 and B % dp == 0
        self.tp = tp_split and "model" in sizes

    def placements(self, rows, tp) -> list:
        from torch.distributed.tensor import Replicate
        return [(rows if self.rows else Replicate()) if n in DP_AXES
                else (tp if self.tp and n == "model" else Replicate())
                for n in self.names]

    def enter(self, t, rows, tp, grad_rows, grad_tp):
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(t, DTensor):     # alike on every rank
            t = DTensor.from_local(t, self.mesh, [Replicate()] * len(
                self.names), run_check=False)
        return t.redistribute(self.mesh, self.placements(rows, tp)) \
            .to_local(grad_placements=self.placements(grad_rows, grad_tp))

    def leave(self, t, rows, tp):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self.placements(rows, tp),
                                  run_check=False)

    def tp_index(self) -> int:
        """This rank's coordinate on "model" (0 where it is not split)."""
        return self.mesh.get_local_rank("model") if self.tp else 0


def rows_region(fn, weights, *acts):
    """fn(weights, *acts) for DTensor activations, in a local region that
    splits only the rows (dim 0 of every tensor of `acts`: activations,
    positions, caches, states) over the data-parallel axes and gives each
    rank `weights` (a tree) whole: the layers of the recurrent families
    and whisper, whose scans, chunk loops and two attentions DTensor has
    no rules for, with no tensor parallelism inside (every "model" rank
    runs the same layer). fn's tensors come back as rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    first = next(t for t in tree_leaves(list(acts)) if is_dtensor(t))
    r = Region(first.device_mesh, first.shape[0], False)
    wl = tree_map(lambda t: r.enter(t, Replicate(), Replicate(), Partial(),
                                    Replicate()), weights)
    al = tree_map(lambda t: None if t is None else r.enter(
        t, Shard(0), Replicate(), Shard(0), Replicate()), list(acts))
    return tree_map(lambda t: r.leave(t, Shard(0), Replicate())
                    if isinstance(t, torch.Tensor) else t, fn(wl, *al))


def tp_size(mesh) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)


def embed_lookup(table, tokens):
    """table[tokens]. On a DTensor table, in a local region: rows of the
    tokens on the data-parallel axes, the vocabulary split on "model"
    where it divides (each rank looks up the tokens in its slice, zeros
    the others'; the slices' sum is taken on token space)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    V = table.shape[0]
    r = Region(table.device_mesh, tokens.shape[0],
               V % tp_size(table.device_mesh) == 0)
    tl = r.enter(table, Replicate(), Shard(0), Partial(), Shard(0))
    ids = r.enter(tokens, Shard(0), Replicate(), Shard(0), Replicate())
    lo = r.tp_index() * tl.shape[0]
    local = ids - lo
    ok = (local >= 0) & (local < tl.shape[0])
    rows = torch.where(ok[..., None], tl[local.clamp(0, tl.shape[0] - 1)],
                       0)
    out = r.leave(rows, Shard(0), Partial())
    return out.redistribute(r.mesh, r.placements(Shard(0), Replicate()))


def tp_divides(n: int) -> bool:
    """True when dim n divides the active mesh's "model" axis (False when
    no mesh is set: hints are identities then anyway)."""
    if _ACT_MESH is None:
        return False
    from ..parallel.sharding import axis_sizes
    sizes = axis_sizes(_ACT_MESH)
    return "model" in sizes and n % sizes["model"] == 0


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_angles(positions, dim, theta):
    """positions (...,), dim even -> (..., dim/2) angles."""
    dev = positions.device
    freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=dev) / dim))
    return positions.to(torch.float32)[..., None] * freq


def apply_rope(x, positions, theta=1e4, fraction=1.0):
    """x: (B, S, H, D). Rotates the first `fraction` of D."""
    D = x.shape[-1]
    rd = int(D * fraction)
    rd -= rd % 2
    xr, xp = x[..., :rd], x[..., rd:]
    ang = _rope_angles(positions, rd, theta)          # (B, S, rd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], -1) if rd < D else out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta=1e4):
    """qwen2-vl M-RoPE: three position streams over head-dim sections.

    x: (B, S, H, D); positions3: (3, B, S); sections: half-dim split sizes
    summing to D/2.
    """
    D = x.shape[-1]
    half = D // 2
    assert sum(sections) == half, (sections, half)
    dev = x.device
    freq = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=dev) / D))
    # choose which position stream drives each frequency band
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=dev),
        torch.tensor(sections, device=dev), output_size=half)
    pos = positions3.to(torch.float32)[sec_id]             # (half, B, S)
    ang = (pos * freq[:, None, None]).permute(1, 2, 0)     # (B, S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0), with no switch to x for large x
    (F.softplus has one above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x):
    """`jax.nn.log_sigmoid`: -softplus(-x)."""
    return -softplus(-x)


def linear_recurrence(l, r):
    """The associative combine of y_t = a_t y_{t-1} + b_t on pairs (a, b),
    as RG-LRU and sLSTM write it."""
    return l[0] * r[0], r[0] * l[1] + r[1]


def _interleave(a, b, dim: int):
    """[a0, b0, a1, b1, ...] along `dim` (a may be one longer), formed as
    JAX forms it: each side padded with zeros and the two added, so a
    negative zero comes out positive, as there."""
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = a.new_zeros(shape)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out + 0


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple `elems` along `dim` with the associative
    `fn(left, right) -> tuple`: `jax.lax.associative_scan`'s odd/even
    recursion, step for step (pairs [0:-1:2] with [1::2], recurse, combine
    the odd results with [2::2], interleave), so `fn` is applied to the
    same operands in the same order and float results keep JAX's bits.
    O(log S) rounds of tensor ops, not S."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _mask(Sq, Sk, causal, window, q_offset, k_offset, device, kidx=None,
          k_valid=None):
    """(Sq, Sk) bool: the key is at a position >= 0, and (causal) not after
    the query, and (window) within the last `window` positions."""
    qpos = torch.arange(Sq, device=device) + q_offset
    if kidx is None:
        kidx = torch.arange(Sk, device=device)
    kpos = kidx + k_offset
    mask = (kpos[None, :] >= 0).expand(Sq, Sk)
    if k_valid is not None:
        mask = mask & (kidx[None, :] < k_valid)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def attention(q, k, v, *, causal=True, window=0, q_offset=0, k_offset=0,
              logit_softcap=0.0):
    """GQA attention, full materialization. q: (B, Sq, H, D); k/v: (B, Sk, G, D).

    `q_offset` positions the queries inside the kv timeline (decode /
    chunked prefill); `k_offset` positions the keys (shift-window caches,
    possibly negative — negative key positions are masked out).
    `window` > 0 limits attention to the last W keys.
    """
    B, Sq, H, D = q.shape
    G = k.shape[2]
    q = q.reshape(B, Sq, G, H // G, D)
    logits = torch.einsum("bqghd,bkgd->bgqhk", q, k).to(torch.float32)
    logits = logits * (1.0 / math.sqrt(D))
    if logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    mask = _mask(Sq, k.shape[1], causal, window, q_offset, k_offset, q.device)
    # a Python scalar: a tensor made from one here would be a copy to the
    # card, which waits for the stream
    logits = torch.where(mask[None, None, :, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgqhk,bkgd->bqghd", probs, v)
    return out.reshape(B, Sq, H * D)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      k_offset=0, logit_softcap=0.0, kv_chunk=1024):
    """Online-softmax attention over KV chunks, a Python loop in place of
    the reference's `lax.scan`: the live score slab is O(Sq * kv_chunk)
    instead of O(Sq * Sk). KV heads are expanded to the full H inside the
    loop, as the reference does."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    rep = H // G
    nchunks = -(-Sk // kv_chunk)
    pad = nchunks * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for ci in range(nchunks):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kbh = torch.repeat_interleave(k[:, sl], rep, dim=2)  # (B, chunk, H, D)
        vbh = torch.repeat_interleave(v[:, sl], rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kbh).to(torch.float32) \
            * scale
        logits = constrain(logits, DP_AXES, "model", None, None)
        if logit_softcap > 0:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        kidx = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = _mask(Sq, kv_chunk, causal, window, q_offset, k_offset, dev,
                     kidx=kidx, k_valid=Sk)
        logits = torch.where(mask[None, None, :, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vbh).to(torch.float32)
        acc = constrain(acc, DP_AXES, "model", None, None)
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2).reshape(B, Sq, H * D)


def ffn(x, w1, w3, w2, act="swiglu"):
    if act == "swiglu":
        h = F.silu(x @ w1) * (x @ w3)
    else:
        h = F.gelu(x @ w1, approximate="tanh")   # jax.nn.gelu's default
    return h @ w2


def softmax_xent(logits, labels, vocab: int):
    """Mean cross-entropy; logits (B,S,V) f32, labels (B,S) int.

    The gold logit is taken with a masked sum, as the reference takes it
    (not `gather`): the sum rounds as the reference's does, and its
    gradient is a dense `where`, with no scatter. DTensor logits go
    through a local region: each rank's rows, the vocabulary whole (the
    logits are gathered over "model"), the mean over ranks' rows a sum of
    their shares.
    """
    if is_dtensor(logits):
        from torch.distributed.tensor import Partial, Replicate, Shard
        B = logits.shape[0]
        r = Region(logits.device_mesh, B, False)
        ll = r.enter(logits, Shard(0), Replicate(), Shard(0), Replicate())
        loss = softmax_xent(ll, r.enter(labels, Shard(0), Replicate(),
                                        Shard(0), Replicate()), vocab)
        if r.rows:        # this rank's share of the mean over all rows
            loss = loss * (ll.shape[0] / B)
        return r.leave(loss, Partial(), Replicate()).redistribute(
            r.mesh, r.placements(Replicate(), Replicate()))
    logz = torch.logsumexp(logits, -1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None], logits, 0.0).sum(-1)
    return (logz - gold).mean()


def checkpoint_layer(fn, *args):
    """`fn(*args)` with its activations recomputed in the backward pass
    instead of kept: the reference's per-layer `jax.checkpoint`."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
