"""Wrapper of the CUDA `next_use` kernels (`csrc/next_use.cu`).

The port of `src/repro/kernels/next_use.py:next_use_pallas`: a stable LSD
radix sort of the positions by id whose last pass writes next(t), the
successor inside each run of equal ids, and, when asked, the frequency
rank[t] beside it (t's place in its id's run, plus one). The plain PyTorch
versions are `ref.next_use_ref` and `ref.frequency_rank_ref`; `ops.next_use`
picks between the kernel and them.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["next_use_cuda", "plan", "digit_passes"]

RADIX_BITS = 8                 # bits of id sorted per pass
TILE_ITEMS = (2048, 4096)      # requests a block ranks in one pass
TILE_SWITCH = 2**20            # above this T the larger tile
PARTITION_T = 2**22            # above this T next(t) is written by t's group
RADIX = 2**RADIX_BITS


def digit_passes(max_id: int) -> int:
    """Radix passes that sort ids up to `max_id`: ceil(bit_length / 8),
    and at least one, since the last pass also forms next(t): 1 below 256,
    2 below 65,536, 3 below 2^24."""
    return max(1, -(-int(max_id).bit_length() // RADIX_BITS))


def plan(T: int, num_objects: int, one_wave_items: int = 0) -> dict:
    """A call's path and scratch, from T, the id bound and the largest T
    whose first-pass tiles all have a block on the card at once
    (`one_wave_items`, from the library; 0 rules that path out).

    `path`: "one_wave" up to one_wave_items (a cooperative first pass with
    the stats folded in, then the later passes; the pass count comes from
    the data on the card), else "direct" up to PARTITION_T (a stats kernel,
    a read-back, then the radix passes, the last of which writes next(t)),
    else "grouped" (the last pass writes sorted pairs; a successor pass
    groups (t, next) by t's top 8 bits and a write follows). `positions`:
    digit positions histogrammed (the passes ids below `num_objects` can
    need; the data may need fewer). `tile_items` and `tiles`: the radix
    passes' tiling. `partition_shift`: the shift that leaves t's top 8 bits
    (grouped), else -1. `buffers`: int32 words of the ping-pong pair
    buffers. `status_words`: uint64 words of the two look-back tables.
    """
    positions = digit_passes(max(num_objects - 1, 0))
    if T <= one_wave_items:
        path = "one_wave"
    elif T <= PARTITION_T:
        path = "direct"
    else:
        path = "grouped"
    tile = TILE_ITEMS[0] if T <= TILE_SWITCH else TILE_ITEMS[1]
    tiles = -(-T // tile)
    shift = max((T - 1).bit_length() - RADIX_BITS, 0)
    return dict(path=path, positions=positions, tile_items=tile, tiles=tiles,
                partition_shift=shift if path == "grouped" else -1,
                buffers=4 * T if positions > 1 or path == "grouped" else 0,
                status_words=2 * tiles * RADIX)


# (device index, stream) -> [two counter sets (histograms, range, tickets,
# pass count), the set the next call uses]. Zeroed once; each call's first
# kernel zeroes the other set, which the call before used, so the next call
# finds it zero whatever this one does. The oldest is dropped past _KEEP
# streams; the caching allocator reuses its memory in stream order.
_counters: dict = {}
_KEEP = 16


def _counter_sets(lib, dev: torch.device, stream: int):
    key = (dev.index, stream)
    entry = _counters.get(key)
    if entry is None:
        if len(_counters) >= _KEEP:
            _counters.pop(next(iter(_counters)))
        entry = _counters[key] = [torch.zeros(
            2, lib.next_use_counter_words(), dtype=torch.int32, device=dev), 0]
    sets, use = entry
    entry[1] = 1 - use
    return sets, sets[use], sets[1 - use]


def _sorted_by_passes(lib, ids, out, rank, buffers, counters, spare, status,
                      p, num_objects, stream) -> int:
    """The direct and grouped paths: the stats kernel, one read-back of the
    range and the largest id, then the radix passes. Returns the CUDA error
    of the launches."""
    T = ids.shape[0]
    err = lib.next_use_stats_launch(
        ids.data_ptr(), T, num_objects, p["positions"], counters.data_ptr(),
        spare.data_ptr(), status.data_ptr(), status.numel(),
        stream.cuda_stream)
    if err:
        return err
    word = lib.next_use_range_word()
    outside, max_id = counters[word:word + 2].tolist()
    if outside:
        raise ValueError(f"next_use_cuda: ids outside [0, {num_objects})")
    return lib.next_use_sort_launch(
        ids.data_ptr(), out.data_ptr(), _ptr(rank), buffers.data_ptr(),
        counters.data_ptr(), status.data_ptr(), T, digit_passes(max_id),
        p["tile_items"], p["partition_shift"], stream.cuda_stream)


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def next_use_cuda(ids: torch.Tensor, num_objects: int, rank: bool = False):
    """next(t) per request (T where the object never recurs), on the card.

    ids: (T,) contiguous int32 CUDA tensor with values in [0, num_objects).
    Returns (T,) int32, launched on the current stream; the path is
    `plan`'s. With `rank`, returns (next, rank): rank[t], the count of
    ids[t] in ids[:t+1] (int32), written by the same pass as next(t), with
    a third look-back table for its hand-offs between tiles; without, the
    kernels get a null rank and launch and write as they would with no
    rank at all. Each path synchronises once, to check the range: an id
    outside [0, num_objects) raises ValueError (for the one-wave path after
    its kernels ran on the ids), a refused launch RuntimeError.
    """
    if not ids.is_cuda:
        raise ValueError("next_use_cuda: ids is not a CUDA tensor")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("next_use_cuda: ids must be a contiguous (T,) int32 "
                         "tensor")
    T = ids.shape[0]
    if num_objects < 1 or T >= 2**31 - 1:
        raise ValueError(f"next_use_cuda: unsupported T={T}, "
                         f"num_objects={num_objects}")
    out = torch.empty(T, dtype=torch.int32, device=ids.device)
    ranks = torch.empty_like(out) if rank else None
    if T == 0:
        return (out, ranks) if rank else out
    lib = _build.library()
    dev = ids.device
    with torch.cuda.device(dev):
        p = plan(T, num_objects, lib.next_use_one_wave_items())
        stream = torch.cuda.current_stream(dev)
        sets, counters, spare = _counter_sets(lib, dev, stream.cuda_stream)
        buffers = torch.empty(p["buffers"], dtype=torch.int32, device=dev)
        tables = p["status_words"] + (p["tiles"] * RADIX if rank else 0)
        status = torch.empty(tables, dtype=torch.int64, device=dev)
        if p["path"] == "one_wave":
            seen = torch.empty(2, dtype=torch.int32, pin_memory=True)
            err = lib.next_use_one_wave_launch(
                ids.data_ptr(), out.data_ptr(), _ptr(ranks),
                buffers.data_ptr(), counters.data_ptr(), spare.data_ptr(),
                status.data_ptr(), T, num_objects, p["positions"],
                seen.data_ptr(), stream.cuda_stream)
            if err == 0:
                stream.synchronize()
                if seen[0]:
                    raise ValueError(f"next_use_cuda: ids outside "
                                     f"[0, {num_objects})")
        else:
            err = _sorted_by_passes(lib, ids, out, ranks, buffers, counters,
                                    spare, status, p, num_objects, stream)
        if err != 0:
            sets.zero_()
            raise RuntimeError(f"next_use kernel launch failed: CUDA error "
                               f"{err}")
    next_use_cuda.launches += 1
    if rank:
        next_use_cuda.rank_launches += 1
        return out, ranks
    return out


next_use_cuda.launches = 0
next_use_cuda.rank_launches = 0     # the calls that wrote the rank
