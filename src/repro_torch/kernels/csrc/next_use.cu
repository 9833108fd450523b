// next_use: next(t), the index of the next request of the same object, or T
// when the object never recurs. Belady and cost-Belady read it.
//
// Replaces: src/repro/kernels/next_use.py, next_use_pallas (body _kernel),
// the Pallas TPU kernel that walks the trace backwards one block per
// sequential grid step against a last-seen table kept in VMEM scratch.
//
// Why no walk: the walk's chain of dependences (request t needs the table as
// the requests after t left it) belongs to the walk, not to the function.
// The trace is in time order, so a stable sort of the positions by id lists
// each object's requests in time order, and next(t) is the successor inside
// each run of equal ids. A sort uses every SM.
//
// The sort: LSD radix passes over (id, t) pairs on 8-bit digits, stable by
// construction (after Onesweep, Adinets and Merrill 2022), P of them with
// P = ceil(bit_length(max id) / 8), at least one. A pass (radix_pass,
// pass_tail) gives each block a tile, by ticket so that tiles start in
// order and a tile waits only on earlier, running ones. Each warp ranks its
// requests in order: 8 ballots group equal digits, the group's lowest lane
// adds the group to the warp's count in shared memory. The tile's count of
// each digit goes to the later tiles through a decoupled look-back: one
// 64-bit word per tile and digit holds a flag, a count and the last tile so
// far that holds the digit, so no fence is needed, and a thread reads 4
// earlier words at once (8, 16 and 32 were slower on an H100: registers
// cost more than round trips). The pairs are staged in shared memory in
// sorted order; every pass but the last writes them out as runs of
// consecutive addresses. The first pass makes t from the index. Tiles are
// 2048 requests (512 threads, 4 each) up to 2^20 requests, 4096 (256
// threads, 16 each) above.
//
// next(t): for sorted position k, next[t_k] = t_{k+1} if id_{k+1} == id_k,
// else T. The last pass writes it: within a digit's run in the tile the
// next staged pair is the successor; the run's last pair goes to the other
// look-back table, where the next tile holding the digit (known from the
// look-back) reads it; the last pair of a digit over all tiles gets T. That
// pass writes no sorted pairs, and its only wait is on an earlier tile.
// Writing next(t) is a scatter on t, the one uncoalesced stream.
//
// rank[t] (when the caller passes a rank array; the frequency the replay
// reads, the count of ids[t] in ids[:t+1]) is t's place in its id's run over
// the sorted order, plus one. The pass that forms next(t) writes it too: in
// the tile, a pair's id run starts at the last run head at or before it (a
// max-scan of the staged pairs' head positions: per warp row with
// shuffles, then over warps), so every id run of a digit but the tile's
// first gets its rank from the tile alone, j - start + 1. The first id run
// of a digit may continue the run of the nearest earlier tile that holds
// the digit (the one the look-back names, whose last pair the kPair word
// already hands over): if that pair has the same id, the run adds the rank
// that tile handed off. Each tile hands off the rank of its last pair of
// each digit in a third table (kPrefix | rank, one word per tile and
// digit), at once where its digit holds more than one id, else once its
// own carry is known: a hot id whose run spans many tiles (a Zipf head
// holds ~19 k of memcache's 200 k requests, ~9 tiles of 2048) makes a chain
// of such waits, each on an earlier, running tile, as the look-back's are.
// On the grouped path the successor pass writes the rank, its tiles being
// runs of the sorted order (one segment a tile, handed to the next tile).
// A call without a rank array passes null and skips all of it: the same
// launches, bytes and waits as without the rank.
//
// Three paths, by T (the wrapper's plan):
//   one wave, while every tile of 2048 requests has a block on the card at
//     once: first_pass, one cooperative launch, reads each tile's ids once
//     for the histograms of every digit position, the range check and the
//     largest id, waits on one grid barrier, hands the range and the
//     largest id to pinned host memory, and runs the first pass on the ids
//     in its registers; the later passes read the pass count the data needs
//     from the counters and exit past it. No stats kernel, no copy back.
//   direct, up to 2^22: stats_kernel does that reading; the wrapper reads the
//     range and the largest id back and launches P passes.
//   grouped, above 2^22: a random 4-byte write into an array far past the
//     50 MB L2 costs a sector's round trip, so the last id pass writes
//     sorted pairs, radix_pass<kSuccessors> groups the (t, next(t)) pairs by
//     t's top 8 bits (its digit starts are known: digit d at d << shift),
//     and write_kernel writes them in order of blocks, so that the blocks on
//     the card at once write into a few groups' windows of out, which the L2
//     holds.
// Calls on a stream alternate between two counter sets, each call zeroing
// the other for the next. No library sort (no CUB, Thrust or torch.sort):
// warp intrinsics, shared memory and one cooperative-groups grid barrier.
//
// What bounds it on an H100: bytes. The function needs 8*T (each id read
// once, each result written once), 12*T with the rank. Per request the
// paths move: the ids read once for the statistics (4 bytes), 8 written by
// the first pass, 16 by each middle pass, and 8 read plus a 4-byte scatter
// by the last; the grouped path's last id pass writes sorted pairs (8) and
// its successor pass and write add 16 and 12. In all, 16P - 8 bytes one
// wave (24 at P = 2), 16P - 4 direct, 16P + 28 grouped (76 at P = 3, T =
// 2^26), plus 4096 / tile bytes of look-back state. The rank adds a 4-byte
// scatter on t (in the last id pass, or the grouped path's successor pass)
// and 2048 / tile bytes of hand-offs: 28 bytes one wave at P = 2. At T =
// 200,000 the latency of each pass's chain (load, rank, look-back, scatter)
// and the launches, not the bytes, set the time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // stats and write kernels' block
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;  // a pass's first kRadix threads
                                         // own one digit each
constexpr int kMaxPositions = 4;         // 32-bit ids: at most 4 digit passes
constexpr int kStatsItems = 4;           // ids a stats thread reads
constexpr int kWindow = 4;               // look-back words read at once
constexpr unsigned kFull = 0xffffffffu;

// counters (uint32, zero at the start of a call): a histogram of kRadix
// words for each digit position, the count of ids outside [0, n), the
// largest id, one tile ticket for each radix pass, and the pass count the
// data needs (left by first_pass for the later passes). Calls on a stream
// alternate between two such sets; the first kernel of a call zeroes the
// other set, which the call before used, for the call after.
constexpr int kBad = kMaxPositions * kRadix;
constexpr int kTop = kBad + 1;
constexpr int kTicket = kTop + 1;
constexpr int kNeeded = kTicket + kMaxPositions + 1;
constexpr int kCounterWords = kNeeded + 1;

// Look-back words, the flag in the top two bits:
//   kAggregate | count: this tile's count of the digit;
//   kPrefix | (nearest + 1) << 32 | count: the count in this and all earlier
//     tiles, and the last of those tiles that holds the digit (-1: none);
//   kPair | id << 31 | t (the last pass, in the other table): the tile's
//     last pair of the digit in sorted order.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kPair = kPrefix | kAggregate;
constexpr unsigned long long kNearestMask = (1ull << 21) - 1;  // 2^20 tiles

// Blocks of a radix pass an SM should hold: bounds its registers.
constexpr int min_blocks(int block) { return block >= 512 ? 2 : 3; }

// Exclusive scan of one value per thread over a block of kBlock threads.
// `tmp` is kBlock / 32 words of shared memory. Contains two __syncthreads.
template <int kBlock>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w)
    if (w < warp) before += tmp[w];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const int* __restrict__ ids, long long T, int n, int positions,
             unsigned* __restrict__ counters, unsigned* __restrict__ spare,
             unsigned long long* __restrict__ status, long long status_words) {
  __shared__ unsigned hist[kMaxPositions * kRadix];
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < kCounterWords; j += kThreads) spare[j] = 0;
  for (int j = threadIdx.x; j < kMaxPositions * kRadix; j += kThreads)
    hist[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned bad = 0;
  int top = 0;
  auto take = [&](int id) {
    bad += (id < 0) | (id >= n);
    top = max(top, id);
    for (int q = 0; q < positions; ++q)
      atomicAdd(&hist[q * kRadix + (((unsigned)id >> (kRadixBits * q)) &
                                    (kRadix - 1))], 1u);
  };
  // 16-byte loads where the ids are aligned, then the tail one by one
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(ids) & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(ids);
    const long long nv = T / 4;
    for (long long e = first; e < nv; e += stride) {
      const int4 x = v[e];
      take(x.x);
      take(x.y);
      take(x.z);
      take(x.w);
    }
    head = nv * 4;
  }
  for (long long e = head + first; e < T; e += stride) take(ids[e]);
  for (long long j = first; j < status_words; j += stride) status[j] = 0;

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_down_sync(kFull, bad, o);
    top = max(top, __shfl_down_sync(kFull, top, o));
  }
  if ((threadIdx.x & 31) == 0) {
    if (bad) atomicAdd(&counters[kBad], bad);
    atomicMax(reinterpret_cast<int*>(&counters[kTop]), top);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < positions * kRadix; j += kThreads)
    if (hist[j]) atomicAdd(&counters[j], hist[j]);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

struct Back {
  unsigned prefix;     // count of the digit in all earlier tiles
  long long nearest;   // the last earlier tile holding the digit, or -1
};

// Walks back over the earlier tiles' words of digit `d`, kWindow at a time,
// adding tile counts until a word holds a prefix; a word not yet published
// is read again. `tile` > 0.
__device__ __forceinline__ Back look_back(const unsigned long long* status,
                                          long long tile, int d) {
  Back b{0, -1};
  bool found = false;
  long long j = tile - 1;
  while (true) {
    unsigned long long s[kWindow];
#pragma unroll
    for (int w = 0; w < kWindow; ++w)
      s[w] = j - w >= 0 ? load_status(status + (j - w) * kRadix + d) : kPrefix;
    bool stop = false, done = false;
    int used = 0;
#pragma unroll
    for (int w = 0; w < kWindow; ++w) {
      if (!stop) {
        if (s[w] == 0) {
          stop = true;
        } else {
          b.prefix += (unsigned)s[w];
          ++used;
          if (s[w] & kPrefix) {
            if (!found)
              b.nearest = (long long)((s[w] >> 32) & kNearestMask) - 1;
            found = stop = done = true;
          } else if (!found && (unsigned)s[w] > 0) {
            b.nearest = j - w;
            found = true;
          }
        }
      }
    }
    if (done) return b;
    j -= used;
  }
}

// Ranks a warp's 32 * kItems requests (item i of lane l is request
// warp_base + 32 i + l) by the digit at `shift`, in request order: lanes
// with the same digit form a group, whose lowest lane adds the group's size
// to the warp's count of the digit. pos[i]: the earlier requests of the
// warp with the same digit. Requests at T and beyond take no part.
template <int kItems>
__device__ __forceinline__ void rank_in_warp(const int (&key)[kItems],
                                             long long warp_base, long long T,
                                             int shift, unsigned* count,
                                             unsigned (&pos)[kItems]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = warp_base + i * 32 + lane < T;
    const unsigned d = ((unsigned)key[i] >> shift) & (kRadix - 1);
    unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
    for (int b = 0; b < kRadixBits; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned ones = __ballot_sync(kFull, bit);
      peers &= bit ? ones : ~ones;
    }
    if (!valid) peers = 1u << lane;
    const int leader = __ffs(peers) - 1;
    unsigned before = 0;
    if (valid && lane == leader) {
      before = count[d];
      count[d] = before + __popc(peers);
    }
    before = __shfl_sync(kFull, before, leader);
    pos[i] = before + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
}

enum Mode { kIds, kSuccessors };

// Shared memory of one pass over a tile of kBlock * kItems requests.
template <int kBlock, int kItems>
struct PassSmem {
  unsigned warp_count[kBlock / 32][kRadix];
  int stage_key[kBlock * kItems];
  int stage_val[kBlock * kItems];
  unsigned dest_base[kRadix];  // global start less tile-local start
  unsigned tile_first[kRadix];  // kSuccessors: the counts first
  unsigned run_end[kRadix];     // a digit's run ends here in the tile
  unsigned scan_tmp[kBlock / 32];
  unsigned tile_slot;
  int after[2];                 // kSuccessors: the pair after the tile
  // the rank (only when asked for): per run of the hand-off, the length of
  // its first id's run in the tile and the count that id had before the tile
  unsigned first_len[kRadix];
  unsigned carry[kRadix];
  unsigned rank_tmp[kBlock / 32];
};

// rank[t] = the count of ids[t] in ids[:t+1]: the place of pair t in its
// id's run over the whole sorted order, plus one. A tile's staged pairs lie
// in sorted order within each of its "segments" (kIds: the run of a digit,
// pairs [tile_first[d], run_end[d]); kSuccessors: the whole tile), and a
// segment continues the same segment of the nearest earlier tile that holds
// it. `seg(key, s, f, e)` names the segment of a staged key and its pairs
// [f, e). Every id's run in a segment but the first gets its rank from the
// tile alone: j - start + 1, start the last run head at or before j (a
// max-scan of head positions, per warp row with a carry, then over warps).
// The first id's run may continue from the earlier tile, so this phase only
// notes its length; the segment's last rank goes to `row[s]` (kPrefix |
// rank, a hand-off read by the next tile holding the segment) here unless
// the first run is the whole segment. Ends with a barrier.
template <int kBlock, int kItems, typename Seg>
__device__ __forceinline__ void rank_in_tile(PassSmem<kBlock, kItems>& sm,
                                             unsigned n_tile, Seg seg,
                                             int* __restrict__ rank,
                                             unsigned long long* row) {
  constexpr int kWarpTile = 32 * kItems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned wbase = warp * kWarpTile;
  auto head_at = [&](unsigned j) {
    return j < n_tile && (j == 0 || sm.stage_key[j] != sm.stage_key[j - 1]);
  };
  unsigned top = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned j = wbase + i * 32 + lane;
    if (head_at(j)) top = j;
  }
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) sm.rank_tmp[warp] = top;
  __syncthreads();
  unsigned start = 0;  // the last head before this warp's pairs
  for (int w = 0; w < warp; ++w) start = max(start, sm.rank_tmp[w]);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned j = wbase + i * 32 + lane;
    unsigned x = head_at(j) ? j : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = max(x, y);
    }
    x = max(x, start);
    start = __shfl_sync(kFull, x, 31);
    if (j < n_tile) {
      const int k = sm.stage_key[j];
      unsigned s, f, e;
      seg(k, s, f, e);
      if (x != f) {
        rank[sm.stage_val[j]] = (int)(j - x + 1);
        if (j + 1 == e) store_status(row + s, kPrefix | (j - x + 1));
      } else if (j + 1 == e || sm.stage_key[j + 1] != k) {
        sm.first_len[s] = j - f + 1;
      }
    }
  }
  __syncthreads();
}

// After rank_in_tile and a barrier that follows the owners' carry into
// sm.carry: the ranks of each segment's first id's run, carry included.
template <int kBlock, int kItems, typename Seg>
__device__ __forceinline__ void rank_first_runs(PassSmem<kBlock, kItems>& sm,
                                                unsigned n_tile, Seg seg,
                                                int* __restrict__ rank) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned j = i * kBlock + threadIdx.x;
    if (j < n_tile) {
      unsigned s, f, e;
      seg(sm.stage_key[j], s, f, e);
      if (j - f < sm.first_len[s])
        rank[sm.stage_val[j]] = (int)(j - f + 1 + sm.carry[s]);
    }
  }
}

// The count a segment's first id had before this tile: the rank the nearest
// earlier tile holding the segment handed off, once it is there.
__device__ __forceinline__ unsigned rank_handed_off(
    const unsigned long long* word) {
  unsigned long long v;
  do {
    v = load_status(word);
  } while (!(v & kPrefix));
  return (unsigned)v;
}

// One stable pass of 8-bit digits at `shift` over a tile whose keys (and,
// for kSuccessors, values) are in registers; warp_count is zero. Thread d <
// kRadix owns digit d. status: this pass's look-back table, zero on entry.
//   kIds: (id, t) pairs by the id's digit. digit_total: this pass's count of
//     digit `tid` over all tiles. Unless `last`, the values are loaded
//     (from vals_in, or the positions) while the look-back waits, the pairs
//     are written sorted to keys_out/vals_out, and `other`, the next pass's
//     table (or nullptr), gets the tile's row zeroed. If `last` (the caller
//     has loaded the values), the sorted ids are whole: next(t) goes to
//     keys_out (the output) for each pair whose successor is in the tile;
//     the tile's last pair of each digit goes to `other`, where the next
//     tile holding the digit (known from the look-back) reads it and writes
//     its next(t); the last pair of a digit over all tiles gets T. With
//     `rank` (else nullptr), rank[t] too, each digit's run a segment of
//     rank_in_tile whose hand-off is rank_tab's row of the tile.
//   kSuccessors: (t, next(t)) pairs by t's top 8 bits (shift: bit_length of
//     T - 1, less 8, at least 0; digit d starts at d << shift). The tile
//     counts are published before the ranking (counted with shared atomics),
//     the id passes' after (from the ranking's own counts): each was the
//     faster on an H100 for its pass.
template <int kBlock, int kItems, int kMode>
__device__ __forceinline__ void pass_tail(
    PassSmem<kBlock, kItems>& sm, int (&key)[kItems], int (&val)[kItems],
    const int* __restrict__ vals_in, int* __restrict__ keys_out,
    int* __restrict__ vals_out, unsigned* __restrict__ counters, bool last,
    unsigned long long* status, unsigned long long* other, long long T,
    int shift, long long tile, unsigned digit_total, int* __restrict__ rank,
    unsigned long long* rank_tab) {
  constexpr int kTile = kBlock * kItems;
  constexpr int kWarpTile = 32 * kItems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool owner = tid < kRadix;
  const long long base = tile * kTile;
  const long long warp_base = base + warp * kWarpTile;
  const long long left = T - base;
  const unsigned n_tile = left < kTile ? (unsigned)left : kTile;
  unsigned long long* mine = status + tile * kRadix + tid;
  unsigned digit_start;
  if constexpr (kMode == kIds) {
    digit_start = block_exclusive_scan<kBlock>(digit_total, sm.scan_tmp);
  } else {
    const long long s = (long long)tid << shift;
    digit_start = (unsigned)(s < T ? s : T);
  }

  unsigned count = 0, first = 0;
  Back back{0, -1};
  auto publish = [&]() {  // the tile's count of digit `tid`
    if (owner)
      store_status(mine, (tile == 0 ? kPrefix : kAggregate) | count |
                             (tile == 0 && count ? 1ull << 32 : 0ull));
    first = block_exclusive_scan<kBlock>(count, sm.scan_tmp);
    if (owner) sm.tile_first[tid] = first;
  };
  auto resolve = [&]() {  // the earlier tiles' count, then this tile's prefix
    if (owner && tile > 0) {
      back = look_back(status, tile, tid);
      const long long nearest = count ? tile : back.nearest;
      store_status(mine, kPrefix | (unsigned long long)(nearest + 1) << 32 |
                             (back.prefix + count));
    }
  };
  unsigned pos[kItems];
  if constexpr (kMode == kSuccessors) {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (warp_base + i * 32 + lane < T)
        atomicAdd(&sm.tile_first[((unsigned)key[i] >> shift) & (kRadix - 1)],
                  1u);
    __syncthreads();
    count = owner ? sm.tile_first[tid] : 0u;
    publish();
    resolve();
  }
  rank_in_warp<kItems>(key, warp_base, T, shift, sm.warp_count[warp], pos);
  __syncthreads();
  {
    // Thread `tid` owns digit `tid`: the counts of the earlier warps, then
    // (kIds) the tile's count, published, and where the digit starts in the
    // tile (and, unless `last`, in the earlier tiles: the values load
    // during the wait).
    unsigned run = 0;
    if (owner) {
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) {
        const unsigned c = sm.warp_count[w][tid];
        sm.warp_count[w][tid] = run;
        run += c;
      }
    }
    if constexpr (kMode == kIds) {
      count = run;
      publish();
      if (!last) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const long long e = warp_base + i * 32 + lane;
          if (e < T) val[i] = vals_in ? vals_in[e] : (int)e;
        }
        resolve();
        if (owner && other) other[tile * kRadix + tid] = 0;
      }
    }
  }
  if (owner) {
    sm.dest_base[tid] = digit_start + back.prefix - first;  // wraps < 2^31
    sm.run_end[tid] = first + count;
  }
  __syncthreads();

  // Stage the pairs in the tile's sorted order.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (warp_base + i * 32 + lane < T) {
      const unsigned d = ((unsigned)key[i] >> shift) & (kRadix - 1);
      pos[i] += sm.tile_first[d] + sm.warp_count[warp][d];
      sm.stage_key[pos[i]] = key[i];
      sm.stage_val[pos[i]] = val[i];
    }
  }
  __syncthreads();

  if (kMode == kSuccessors || !last) {
    // runs of equal digits go to consecutive addresses
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned j = i * kBlock + tid;
      if (j < n_tile) {
        const int k = sm.stage_key[j];
        const unsigned at =
            sm.dest_base[((unsigned)k >> shift) & (kRadix - 1)] + j;
        keys_out[at] = k;
        vals_out[at] = sm.stage_val[j];
      }
    }
    return;
  }
  // The last pass needs only the tile's own order for most of next(t):
  // within a digit's run the next staged pair is the successor. These
  // writes, and the run's last pair for the next tile holding the digit,
  // go out before the look-back, whose wait they overlap.
  int* out = keys_out;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned j = i * kBlock + tid;
    if (j < n_tile) {
      const int k = sm.stage_key[j];
      if (j + 1 < sm.run_end[((unsigned)k >> shift) & (kRadix - 1)])
        out[sm.stage_val[j]] =
            sm.stage_key[j + 1] == k ? sm.stage_val[j + 1] : (int)T;
    }
  }
  const unsigned end = first + count - 1;
  if (owner && count)
    store_status(other + tile * kRadix + tid,
                 kPair |
                     (unsigned long long)((unsigned)sm.stage_key[end] &
                                          0x7fffffffu) << 31 |
                     ((unsigned)sm.stage_val[end] & 0x7fffffffu));
  auto digit_run = [&](int k, unsigned& s, unsigned& f, unsigned& e) {
    s = ((unsigned)k >> shift) & (kRadix - 1);
    f = sm.tile_first[s];
    e = sm.run_end[s];
  };
  unsigned long long* rank_row = rank ? rank_tab + tile * kRadix : nullptr;
  if (rank)
    rank_in_tile<kBlock, kItems>(sm, n_tile, digit_run, rank, rank_row);
  resolve();
  if (owner && count) {
    // the run's last pair gets T if no later request has this digit; the
    // run's first pair is the successor of the nearest earlier tile's last
    if (back.prefix + count == digit_total) out[sm.stage_val[end]] = (int)T;
    unsigned carry = 0;
    if (back.nearest >= 0) {
      unsigned long long v;
      do {
        v = load_status(other + back.nearest * kRadix + tid);
      } while ((v & kPair) != kPair);
      const bool same = (int)((v >> 31) & 0x7fffffffu) ==
                        ((unsigned)sm.stage_key[first] & 0x7fffffffu);
      out[v & 0x7fffffffu] = same ? sm.stage_val[first] : (int)T;
      if (rank && same)
        carry = rank_handed_off(rank_tab + back.nearest * kRadix + tid);
    }
    if (rank) {
      sm.carry[tid] = carry;
      if (sm.first_len[tid] == count)
        store_status(rank_row + tid, kPrefix | (count + carry));
    }
  }
  if (rank) {
    __syncthreads();
    rank_first_runs<kBlock, kItems>(sm, n_tile, digit_run, rank);
  }
}

// One radix pass over the tile the block takes by ticket (so tiles start in
// order and a tile waits only on earlier, running ones). vals_in == nullptr:
// the values are the positions. passes: the id passes of the call, or 0 to
// read the count the first pass left in the counters; a pass past it exits
// at once. hist of this pass: counters + pass * kRadix.
//   kIds: the pass `pass` of the ids into keys_out/vals_out; the last one
//     writes next(t) into `out` instead, unless `grouped` (then a
//     kSuccessors pass follows).
//   kSuccessors: reads pairs sorted by id, forms (t, next(t)) from each pair
//     and the next, and groups them by t's top 8 bits. With `rank`, writes
//     rank[t] first, the tile one segment of rank_in_tile and its hand-off
//     rank_tab's row of the tile.
// rank, rank_tab: nullptr unless the call writes the rank; then rank_tab is
// a zeroed table of the tiles' rank hand-offs, read by the pass that forms
// next(t).
template <int kBlock, int kItems, int kMode>
__global__ void __launch_bounds__(kBlock, min_blocks(kBlock))
radix_pass(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
           int* __restrict__ keys_out, int* __restrict__ vals_out,
           int* __restrict__ out, unsigned* __restrict__ counters, int pass,
           int passes, int grouped,
           unsigned long long* status, unsigned long long* other,
           long long T, int shift, int* __restrict__ rank,
           unsigned long long* rank_tab) {
  constexpr int kTile = kBlock * kItems;
  constexpr int kWarpTile = 32 * kItems;
  __shared__ PassSmem<kBlock, kItems> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool owner = tid < kRadix;
  if (kMode == kIds && passes == 0) {
    passes = (int)*reinterpret_cast<volatile unsigned*>(&counters[kNeeded]);
    if (pass >= passes) return;
  }
  if (tid == 0) sm.tile_slot = atomicAdd(&counters[kTicket + pass], 1u);
  const unsigned digit_total =
      kMode == kIds && owner ? counters[pass * kRadix + tid] : 0u;
  for (int j = tid; j < kBlock / 32 * kRadix; j += kBlock)
    (&sm.warp_count[0][0])[j] = 0;
  if (owner) sm.tile_first[tid] = 0;
  __syncthreads();
  const long long tile = sm.tile_slot;
  const long long base = tile * kTile;
  const long long warp_base = base + warp * kWarpTile;

  const bool last = kMode == kIds && pass + 1 == passes && !grouped;
  int key[kItems], val[kItems];
  if constexpr (kMode == kIds) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long e = warp_base + i * 32 + lane;
      key[i] = e < T ? keys_in[e] : 0;
      val[i] = last && e < T ? (vals_in ? vals_in[e] : (int)e) : 0;
    }
  } else {
    // (id, t) in id order; the pair after each is its neighbour in shared
    // memory, or for the tile's last the first pair of the next tile
    const long long left = T - base;
    const int n_tile = left < kTile ? (int)left : kTile;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long e = warp_base + i * 32 + lane;
      const int j = warp * kWarpTile + i * 32 + lane;
      if (e < T) {
        sm.stage_key[j] = keys_in[e];
        sm.stage_val[j] = vals_in ? vals_in[e] : (int)e;
      }
    }
    if (tid == 0 && base + kTile < T) {
      sm.after[0] = keys_in[base + kTile];
      sm.after[1] = vals_in ? vals_in[base + kTile] : (int)(base + kTile);
    }
    __syncthreads();
    if (rank) {
      // the pairs are in the global sorted order: the tile is one segment,
      // continuing tile - 1's if the pair before the tile has the same id
      auto whole = [&](int, unsigned& s, unsigned& f, unsigned& e) {
        s = 0;
        f = 0;
        e = (unsigned)n_tile;
      };
      unsigned long long* row = rank_tab + tile * kRadix;
      rank_in_tile<kBlock, kItems>(sm, (unsigned)n_tile, whole, rank, row);
      if (tid == 0) {
        const unsigned carry =
            tile > 0 && keys_in[base - 1] == sm.stage_key[0]
                ? rank_handed_off(row - kRadix)
                : 0u;
        sm.carry[0] = carry;
        if (sm.first_len[0] == (unsigned)n_tile)
          store_status(row, kPrefix | (n_tile + carry));
      }
      __syncthreads();
      rank_first_runs<kBlock, kItems>(sm, (unsigned)n_tile, whole, rank);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = warp * kWarpTile + i * 32 + lane;
      key[i] = 0;
      val[i] = (int)T;
      if (j < n_tile) {
        key[i] = sm.stage_val[j];
        const bool end = j + 1 == kTile;
        if (base + j + 1 < T &&
            (end ? sm.after[0] : sm.stage_key[j + 1]) == sm.stage_key[j])
          val[i] = end ? sm.after[1] : sm.stage_val[j + 1];
      }
    }
  }
  pass_tail<kBlock, kItems, kMode>(sm, key, val, vals_in,
                                   last ? out : keys_out,
                                   vals_out, counters, last, status, other,
                                   T, shift, tile, digit_total, rank,
                                   rank_tab);
}

// The first pass when every tile has a block on the card at once (a
// cooperative launch guarantees it), with the stats kernel's work folded
// in: each block reads its tile's ids once, histograms them (all `positions`
// digit positions), finds the ids outside [0, n) and the largest, and
// zeroes its rows of both look-back tables (and, with `rank`, of the rank
// hand-off table after them; block 0 also the spare counter set); after one
// grid barrier block 0
// hands the range count and the largest id to the host (`seen`, pinned
// memory written over the bus while the pass goes on) and leaves the pass
// count the data needs in the counters for the later passes; then the
// first radix pass runs on the ids already in registers.
template <int kBlock, int kItems>
__global__ void __launch_bounds__(kBlock, min_blocks(kBlock))
first_pass(const int* __restrict__ ids, int* __restrict__ keys_out,
           int* __restrict__ out, unsigned* __restrict__ counters,
           unsigned* __restrict__ spare, unsigned long long* status,
           long long T, int n, int positions, int* seen,
           int* __restrict__ rank) {
  constexpr int kTile = kBlock * kItems;
  constexpr int kWarpTile = 32 * kItems;
  __shared__ PassSmem<kBlock, kItems> sm;
  __shared__ unsigned hist[kMaxPositions * kRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool owner = tid < kRadix;
  const long long tile = blockIdx.x;
  const long long words = (long long)gridDim.x * kRadix;
  const long long warp_base = tile * kTile + warp * kWarpTile;
  for (int j = tid; j < kMaxPositions * kRadix; j += kBlock) hist[j] = 0;
  if (tile == 0)
    for (int j = tid; j < kCounterWords; j += kBlock) spare[j] = 0;
  for (int j = tid; j < kBlock / 32 * kRadix; j += kBlock)
    (&sm.warp_count[0][0])[j] = 0;
  if (owner) {
    sm.tile_first[tid] = 0;
    status[tile * kRadix + tid] = 0;
    status[words + tile * kRadix + tid] = 0;
    if (rank) status[2 * words + tile * kRadix + tid] = 0;
  }
  __syncthreads();

  int key[kItems], val[kItems];
  unsigned bad = 0;
  int top = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long e = warp_base + i * 32 + lane;
    key[i] = 0;
    val[i] = (int)e;
    if (e < T) {
      key[i] = ids[e];
      bad += (key[i] < 0) | (key[i] >= n);
      top = max(top, key[i]);
      for (int q = 0; q < positions; ++q)
        atomicAdd(&hist[q * kRadix + (((unsigned)key[i] >> (kRadixBits * q)) &
                                      (kRadix - 1))], 1u);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_down_sync(kFull, bad, o);
    top = max(top, __shfl_down_sync(kFull, top, o));
  }
  if (lane == 0) {
    if (bad) atomicAdd(&counters[kBad], bad);
    atomicMax(reinterpret_cast<int*>(&counters[kTop]), top);
  }
  __syncthreads();
  for (int j = tid; j < positions * kRadix; j += kBlock)
    if (hist[j]) atomicAdd(&counters[j], hist[j]);
  cooperative_groups::this_grid().sync();

  const unsigned largest = __ldcg(&counters[kTop]);
  int passes = 1;
  while (passes < positions && (largest >> (kRadixBits * passes))) ++passes;
  if (tile == 0 && tid == 0) {
    volatile int* v = seen;
    v[0] = (int)__ldcg(&counters[kBad]);
    v[1] = (int)largest;
    counters[kNeeded] = passes;
  }
  pass_tail<kBlock, kItems, kIds>(
      sm, key, val, nullptr, passes == 1 ? out : keys_out, keys_out + T,
      counters, passes == 1, status, status + words, T, 0, tile,
      owner ? __ldcg(&counters[tid]) : 0u, rank, status + 2 * words);
}

// (t, next(t)) pairs grouped by t's top 8 bits, written in order of blocks.
__global__ void __launch_bounds__(kThreads)
write_kernel(const int* __restrict__ ts, const int* __restrict__ nexts,
             int* __restrict__ out, long long T) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k < T) out[ts[k]] = nexts[k];
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      count = 132;
  }
  return count;
}

// Passes `from` to `passes` - 1 (passes == 0: as many as the first pass
// left in the counters, launching `positions` and letting the extra ones
// exit), then, if grouped, the successor pass and the write. With `rank`
// (else nullptr), the pass that forms next(t) writes rank[t] too, its
// hand-offs in the third table of `status`.
template <int kBlock, int kItems>
int run_passes(const int* ids, int* out, int* rank, int* buffers,
               unsigned* counters, unsigned long long* status, long long T,
               int from, int passes, int positions, int partition_shift,
               cudaStream_t stream) {
  constexpr long long kTile = kBlock * kItems;
  const unsigned tiles = (unsigned)((T + kTile - 1) / kTile);
  const long long words = (long long)tiles * kRadix;
  unsigned long long* rank_tab = rank ? status + 2 * words : nullptr;
  const bool grouped = partition_shift >= 0;
  const int launched = passes ? passes : positions;
  for (int p = from; p < launched; ++p) {
    const int* keys_in = p ? buffers + (long long)((p - 1) % 2) * 2 * T : ids;
    int* keys_out = buffers + (long long)(p % 2) * 2 * T;
    radix_pass<kBlock, kItems, kIds><<<tiles, kBlock, 0, stream>>>(
        keys_in, p ? keys_in + T : nullptr, keys_out, keys_out + T, out,
        counters, p, passes, grouped ? 1 : 0, status + (p % 2) * words,
        status + ((p + 1) % 2) * words, T, kRadixBits * p, rank, rank_tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!grouped) return 0;
  const int* keys_in = buffers + (long long)((passes - 1) % 2) * 2 * T;
  int* ts = buffers + (long long)(passes % 2) * 2 * T;
  radix_pass<kBlock, kItems, kSuccessors><<<tiles, kBlock, 0, stream>>>(
      keys_in, keys_in + T, ts, ts + T, nullptr, counters, passes, passes, 1,
      status + (passes % 2) * words, nullptr, T, partition_shift, rank,
      rank_tab);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_kernel<<<(unsigned)((T + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>(ts, ts + T, out, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest T for which first_pass's tiles of 2048 requests all have a block
// on the card at once: the one-wave path up to it. 0 if the card cannot
// tell or has no cooperative launch.
extern "C" long long next_use_one_wave_items() {
  int device = 0, per_sm = 0, cooperative = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                             device) != cudaSuccess ||
      !cooperative ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, first_pass<512, 4>, 512, 0) != cudaSuccess)
    return 0;
  return (long long)per_sm * sm_count() * 2048;
}

// Words of one counter set (uint32). The caller zeroes two sets once and
// hands each call the one the call before did not use (`counters`) and the
// other (`spare`), which the call zeroes for the call after.
extern "C" int next_use_counter_words() { return kCounterWords; }

// Word of the counters buffer that holds the count of ids outside [0, n);
// the largest id follows it.
extern "C" int next_use_range_word() { return kBad; }

// The one-wave path, T <= next_use_one_wave_items(): first_pass (one
// cooperative launch: the ids' histograms, range and largest id, then the
// first radix pass), then radix passes 1 to positions - 1, each of which
// exits if the data needs fewer; the last the data needs writes next(t)
// into out (T,) int32, and rank[t] into rank (T,) int32 unless rank is
// null. counters, spare: this call's zeroed counter set and the other one.
// seen: 2 int32 of pinned host memory that get the count of ids outside
// [0, n) and the largest id (valid once the stream has passed first_pass).
// buffers: 4*T int32 (none when positions == 1); status: two look-back
// tables of ceil(T / 2048) * 256 uint64 words, a third (the rank's
// hand-offs) with rank (no zeroing needed). positions: the digit passes ids
// below n can need (1 to 4). Returns the first CUDA error of the launches,
// 0 on success.
extern "C" int next_use_one_wave_launch(const void* ids, void* out,
                                        void* rank, void* buffers,
                                        void* counters, void* spare,
                                        void* status, long long T, int n,
                                        int positions, void* seen,
                                        void* stream) {
  if (positions < 1 || positions > kMaxPositions)
    return (int)cudaErrorInvalidValue;
  const int* ids_p = static_cast<const int*>(ids);
  int* out_p = static_cast<int*>(out);
  int* buffers_p = static_cast<int*>(buffers);
  unsigned* counters_p = static_cast<unsigned*>(counters);
  unsigned* spare_p = static_cast<unsigned*>(spare);
  unsigned long long* status_p = static_cast<unsigned long long*>(status);
  int* seen_p = static_cast<int*>(seen);
  int* rank_p = static_cast<int*>(rank);
  void* args[] = {&ids_p, &buffers_p, &out_p,     &counters_p, &spare_p,
                  &status_p, &T,      &n,         &positions,  &seen_p,
                  &rank_p};
  const long long tiles = (T + 2047) / 2048;
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)first_pass<512, 4>, dim3((unsigned)tiles), dim3(512), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return run_passes<512, 4>(ids_p, out_p, rank_p, buffers_p, counters_p,
                            status_p, T, 1, 0, positions, -1,
                            (cudaStream_t)stream);
}

// ids: (T,) int32, T >= 1. Histograms the ids' low `positions` bytes into
// counters (this call's zeroed set), counts the ids outside [0, n) and
// finds the largest (at next_use_range_word and the word after), and zeroes
// the spare set and status[0, status_words) (both look-back tables).
// Returns the CUDA error of the launch.
extern "C" int next_use_stats_launch(const void* ids, long long T, int n,
                                     int positions, void* counters,
                                     void* spare, void* status,
                                     long long status_words, void* stream) {
  if (positions < 0 || positions > kMaxPositions)
    return (int)cudaErrorInvalidValue;
  constexpr long long kPerBlock = kStatsItems * kThreads;
  long long blocks = (T + kPerBlock - 1) / kPerBlock;
  if (blocks > 8LL * sm_count()) blocks = 8LL * sm_count();
  stats_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(ids), T, n, positions,
      static_cast<unsigned*>(counters), static_cast<unsigned*>(spare),
      static_cast<unsigned long long*>(status), status_words);
  return (int)cudaGetLastError();
}

// After next_use_stats_launch on the same counters and stream: `passes`
// (>= 1) radix passes in tiles of `tile_items` requests (2048 or 4096), the
// last of which writes next(t) into out (T,) int32 when partition_shift < 0;
// else a successor pass groups the (t, next(t)) pairs by t >> partition_shift
// (t's top 8 bits) and write_kernel writes them. Unless rank is null, the
// pass that forms next(t) also writes rank[t] into rank (T,) int32.
// buffers: 4*T int32 (none for one direct pass); status: two look-back
// tables of ceil(T / tile_items) * 256 uint64 words, a third with rank, all
// zeroed by the stats launch. Returns the first CUDA error of the launches,
// 0 on success.
extern "C" int next_use_sort_launch(const void* ids, void* out, void* rank,
                                    void* buffers, void* counters,
                                    void* status, long long T, int passes,
                                    int tile_items, int partition_shift,
                                    void* stream) {
  if (passes < 1 || passes > kMaxPositions || partition_shift > 31)
    return (int)cudaErrorInvalidValue;
  const int* in = static_cast<const int*>(ids);
  int* o = static_cast<int*>(out);
  int* r = static_cast<int*>(rank);
  int* b = static_cast<int*>(buffers);
  unsigned* c = static_cast<unsigned*>(counters);
  unsigned long long* s = static_cast<unsigned long long*>(status);
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_items == 2048)
    return run_passes<512, 4>(in, o, r, b, c, s, T, 0, passes, passes,
                              partition_shift, st);
  if (tile_items == 4096)
    return run_passes<256, 16>(in, o, r, b, c, s, T, 0, passes, passes,
                               partition_shift, st);
  return (int)cudaErrorInvalidValue;
}
