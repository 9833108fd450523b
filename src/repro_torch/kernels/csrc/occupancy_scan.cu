// occupancy_scan: the occupancy profile of a retention schedule, i.e. the
// inclusive float32 prefix sum of its range-add deltas (the LHS of eq. (2)),
// and, fused into the same scan, its worst excess max(occ - zcap) over the
// per-instant cap. cost_foo(validate=True) checks its rounded schedule with
// the second.
//
// Replaces: src/repro/kernels/interval_occupancy.py, two Pallas TPU kernels
// that share one scan:
//   interval_occupancy_pallas (body _kernel): a block cumsum plus a running
//     total carried in SMEM scratch across a sequential grid;
//   occupancy_feasible_pallas (body _feas_kernel): the same, with a running
//     max of occ - zcap carried beside the total; its padding carries
//     zcap = +3.4e38.
//
// What bounds it on an H100: bytes. occupancy_feasible reads deltas and zcap
// and writes occ once each, 12*T bytes; interval_occupancy 8*T. One add and
// one compare per item are far below the card's rate. At the 200,000 items
// of cost-FOO's CDN trace the bound is 0.72 us, less than a launch, so there
// the latency of one pass sets the time.
//
// Design: one device kernel per call, one pass over the data.
//   * One block of 256 threads a tile. A tile is 4096 items (16 a thread);
//     up to 2^21 items, where the grid fits in one wave of the card, it is
//     2048 (8 a thread), so that twice the blocks share a short call. A
//     block takes a ticket from an atomic counter in the scratch: ticket /
//     tiles is the call's number, ticket % tiles its tile. So every lower
//     tile is already running when a block starts, and a wait on a lower
//     tile cannot deadlock.
//   * The tile is loaded with 16-byte vector loads, neighbouring threads on
//     neighbouring addresses, and staged in shared memory with one padding
//     float every 32 (conflict-free both ways). Each thread then scans its
//     run of 16 consecutive items from shared memory; Kogge-Stone scans over
//     the lanes and over the 8 warps give each item its in-tile prefix L and
//     the tile its aggregate.
//   * The aggregate is published at once, as a float64, in a 16-byte word
//     {value, tag} written and read as one vector access, so a reader sees
//     value and tag together. The tag is the call's number + 1, so nothing
//     is reset between calls and no reset kernel runs.
//   * Carries have a fixed association. Node (l, j) of a radix-256 tree is
//     the float64 sum of tiles [j*256^l, (j+1)*256^l): level 0 is the tile
//     aggregates, and the block that makes the 256th arrival at a node (an
//     arrival counter per node, read modulo 256) reads its 256 children, one
//     a thread, adds them in a fixed shuffle tree and publishes the node.
//     Tile k = sum_l a_l 256^l takes as carry the sum over levels, top level
//     first, of the a_l nodes to its left under the same parent, each level
//     read one node a thread and added in the same fixed tree. What a carry
//     is made of, and in what order, depends only on k: two runs give equal
//     bits. Up to 256 tiles (2^19 items) there is one level and a block
//     reads only the aggregates of the tiles before it; at 2^26 two.
//   * Each item's output is float32(carry + double(L)): one rounding from
//     float64 to float32 after the in-tile chain.
//   * The cap: occupancy_feasible loads zcap beside the deltas, takes
//     max(occ - zcap) over the tile as it stores occ, and publishes the tile
//     maximum in a tagged word; the block of the last tile, which started
//     last, waits for all of them and takes their max. A max is exact in
//     any order. No other block waits or counts at its end.
// Sums in a tile are float32, as in the reference; int32 deltas are
// converted to float32 item by item before they are added, like
// astype(float32). The ragged tail is masked (a masked item adds 0.0 and is
// left out of the max), offsets are 64-bit, and a base pointer that is not
// 16-byte aligned takes scalar loads. A NaN propagates into the excess, as
// in torch.amax.
//
// Scratch: the ticket counter, the tree's nodes, its arrival counters and
// the tile maxima, laid out by the tile count alone. It must be zeroed once
// when allocated and then belongs to one stream; the wrapper keeps one per
// (device, stream, size). Every call adds `tiles` to the ticket counter and
// 256 to each arrival counter it uses, so the next call finds them as it
// needs them.
//
// Rounding: every output equals any other summation order's bit for bit
// when all partial sums are exact in float32 (integer-valued deltas whose
// absolute sum stays below 2^24): then every float32 and float64 addition
// is exact. In general, with u = 2^-24 and A_p = sum_{q<=p} |d_q|:
//   * L is a float32 tree sum of the tile's items up to p in which no item
//     passes through more than D = (I - 1) + 5 + 3 + 1 + 1 additions, with
//     I items a thread: I - 1 in the thread's run, 5 in the lane scan, 3 in
//     the warp scan, 1 to join warp and lane offsets, 1 to add the item's
//     run prefix; so |L - exact| <= gamma_D * (its items' |d|). D is 25
//     with 16 items a thread and 17 with 8.
//   * A tile aggregate passes D - 2 float32 additions.
//   * The carry adds the aggregates in float64: 10 shuffle additions per
//     tree level (block_sum) and one per level to join the levels, fewer
//     than 45 additions in all for at most 4 levels, an error below
//     45 * 2^-53 of the aggregates' sum of |.|.
//   * float64(carry + L) rounds once more at 2^-53, float32(...) at u.
// So |occ[p] - exact| <= (u + gamma_D + O(u^2) + O(2^-47)) * A_p
//                     <  k * u * A_p  with k = D + 2,
// 19 up to 2^21 items and 27 above, which occupancy_scan_error_chain
// returns (the reduce-then-scan this replaced had k = 2*ceil(tiles/1024)
// + 36 with 4096-item tiles: 38 up to 4M items, 68 at 2^26).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixLog = 8;               // kThreads == 1 << kRadixLog
constexpr int kMaxLevels = 4;              // 256^4 tiles: more than any int
constexpr long long kSmallMaxT = 1LL << 21;   // 8 items a thread up to here
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == 1 << kRadixLog, "one tree child per thread");

// One node of the carry tree: a float64 value and the tag of the call that
// wrote it, stored and loaded as one 16-byte access.
struct alignas(16) Node {
  unsigned long long bits;
  unsigned long long tag;
};

struct Layout {
  int levels;                      // tree levels: 256^levels >= tiles
  long long count[kMaxLevels];     // nodes at each level (level 0: tiles)
  long long node_off[kMaxLevels];  // byte offset of each level's nodes
  long long ctr_off[kMaxLevels];   // byte offset of its arrival counters
  long long tmax_off;              // byte offset of the tile maxima (Nodes)
  long long bytes;
};

int items_per_thread(long long T) { return T <= kSmallMaxT ? 8 : 16; }

long long num_tiles(long long T) {
  const long long tile = (long long)kThreads * items_per_thread(T);
  return (T + tile - 1) / tile;
}

long long align16(long long b) { return (b + 15) / 16 * 16; }

Layout make_layout(long long tiles) {
  Layout lay{};
  lay.levels = 1;
  while (lay.levels < kMaxLevels &&
         (1LL << (kRadixLog * lay.levels)) < tiles)
    ++lay.levels;
  long long at = 16;   // header: the ticket counter (8 bytes), padding
  for (int l = 0; l < lay.levels; ++l) {
    const long long span = 1LL << (kRadixLog * l);
    lay.count[l] = (tiles + span - 1) / span;
    lay.node_off[l] = at;
    at += lay.count[l] * (long long)sizeof(Node);
  }
  for (int l = 1; l < lay.levels; ++l) {
    lay.ctr_off[l] = at;
    at = align16(at + lay.count[l] * 4);
  }
  lay.tmax_off = at;
  lay.bytes = at + tiles * (long long)sizeof(Node);
  return lay;
}

__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// max that returns NaN if either side is NaN, like torch.amax.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void store_node(Node* p, double v,
                                           unsigned long long tag) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p),
               "l"((unsigned long long)__double_as_longlong(v)), "l"(tag)
               : "memory");
}

// The value of node *p once the call tagged `tag` has written it. A wait
// of more than 2^26 polls (seconds; a real one takes microseconds) means a
// scratch that was not zeroed or is shared between streams: trap, and the
// launch fails, rather than hang the card.
__device__ __forceinline__ double wait_node(const Node* p,
                                            unsigned long long tag) {
  unsigned long long bits, t;
  for (unsigned polls = 0;; ++polls) {
    asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(bits), "=l"(t)
                 : "l"(p)
                 : "memory");
    if (t == tag) return __longlong_as_double((long long)bits);
    if (polls == (1u << 26)) __trap();
    if (polls >= 8) __nanosleep(32);
  }
}

// Inclusive Kogge-Stone scan over the 32 lanes of a warp: log2(32) = 5
// additions on any summand's path.
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = o + v;
  }
  return v;
}

// The value of the next lower lane (0 for lane 0): exclusive from inclusive
// without a subtraction.
__device__ __forceinline__ float lane_exclusive(float incl, int lane) {
  const float o = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.0f : o;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_down_sync(kFull, m, off));
  return m;
}

// Sum of one float64 a thread in a fixed tree (shuffles within each warp,
// then over the warp sums); the result is in thread 0. Every thread of the
// block calls it.
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = 0.0;
  if (warp == 0) {
    r = lane < kWarps ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      r += __shfl_down_sync(kFull, r, off);
  }
  __syncthreads();
  return r;
}

// Four items from q on, 0.0 past T; int32 converted to float32 one by one.
__device__ __forceinline__ void load4(const float* p, long long q,
                                      long long T, bool vec, float v[4]) {
  if (vec && q + 3 < T) {
    const float4 f = *reinterpret_cast<const float4*>(p + q);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = q + e < T ? p[q + e] : 0.0f;
  }
}

__device__ __forceinline__ void load4(const int* p, long long q, long long T,
                                      bool vec, float v[4]) {
  if (vec && q + 3 < T) {
    const int4 f = *reinterpret_cast<const int4*>(p + q);
    v[0] = __int2float_rn(f.x); v[1] = __int2float_rn(f.y);
    v[2] = __int2float_rn(f.z); v[3] = __int2float_rn(f.w);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = q + e < T ? __int2float_rn(p[q + e]) : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* p, long long q, long long T,
                                       bool vec, const float v[4]) {
  if (vec && q + 3 < T) {
    *reinterpret_cast<float4*>(p + q) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (q + e < T) p[q + e] = v[e];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename D, bool kCap, int kItems>
__global__ void __launch_bounds__(kThreads)
occupancy_scan(const D* __restrict__ deltas, const float* __restrict__ zcap,
               float* __restrict__ occ, float* __restrict__ excess,
               unsigned char* __restrict__ scratch,
               const __grid_constant__ Layout lay, long long T) {
  constexpr int kTile = kThreads * kItems;
  constexpr int kVecs = kItems / 4;   // 16-byte vectors a thread moves
  __shared__ float buf[kTile + kTile / 32];
  __shared__ float warp_part[kWarps];
  __shared__ double red[kWarps];
  __shared__ long long s_tile;
  __shared__ unsigned long long s_tag;
  __shared__ float s_agg;
  __shared__ double s_carry;
  __shared__ int s_flag;

  unsigned long long* tickets =
      reinterpret_cast<unsigned long long*>(scratch);
  Node* tmax = reinterpret_cast<Node*>(scratch + lay.tmax_off);
  const long long tiles = lay.count[0];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    const unsigned long long ticket = atomicAdd(tickets, 1ull);
    const unsigned long long call = ticket / (unsigned long long)tiles;
    s_tag = call + 1;
    s_tile = (long long)(ticket - call * (unsigned long long)tiles);
  }
  __syncthreads();
  const long long tile = s_tile;
  const unsigned long long tag = s_tag;
  const long long base = tile * kTile;

  // 1. Stage the tile: coalesced 16-byte loads into padded shared memory.
  const bool d_vec = aligned16(deltas);
  const bool z_vec = kCap && aligned16(zcap);
  const bool o_vec = aligned16(occ);
  float zc[kCap ? kItems : 1];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int x = (k * kThreads + tid) * 4;
    float v[4];
    load4(deltas, base + x, T, d_vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) buf[pad(x + e)] = v[e];
    if constexpr (kCap) load4(zcap, base + x, T, z_vec, zc + 4 * k);
  }
  __syncthreads();

  // 2. In-tile scan: each thread's run of 16 in place, then lanes and warps.
  const int r0 = tid * kItems;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int at = pad(r0 + j);
    s += buf[at];
    buf[at] = s;
  }
  const float incl = warp_inclusive_scan(s, lane);
  const float lane_off = lane_exclusive(incl, lane);
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w =
        warp_inclusive_scan(lane < kWarps ? warp_part[lane] : 0.0f, lane);
    const float w_off = lane_exclusive(w, lane);
    __syncwarp();
    if (lane < kWarps) warp_part[lane] = w_off;
    if (lane == kWarps - 1) s_agg = w;
  }
  __syncthreads();
  const float run_off = warp_part[warp] + lane_off;

  // 3. Publish the aggregate, then form every tree node this tile completes.
  auto nodes = [&](int l) {
    return reinterpret_cast<Node*>(scratch + lay.node_off[l]);
  };
  if (tid == 0) store_node(nodes(0) + tile, (double)s_agg, tag);
  for (int l = 1; l < lay.levels; ++l) {
    const long long j = tile >> (kRadixLog * l);
    if (((j + 1) << (kRadixLog * l)) > tiles) break;   // node never complete
    if (tid == 0) {
      unsigned* ctr = reinterpret_cast<unsigned*>(scratch + lay.ctr_off[l]);
      __threadfence();
      const unsigned old = atomicAdd(ctr + j, 1u);
      s_flag = (old & (kThreads - 1)) == kThreads - 1;
    }
    __syncthreads();
    if (!s_flag) break;
    __threadfence();
    const double v = wait_node(nodes(l - 1) + (j << kRadixLog) + tid, tag);
    const double sum = block_sum(v, red);
    if (tid == 0) store_node(nodes(l) + j, sum, tag);
  }

  // 4. The carry: per level, the nodes left of this tile under its parent,
  //    one a thread, in the fixed tree; levels added top first.
  double carry = 0.0;
  for (int l = lay.levels - 1; l >= 0; --l) {
    const long long a = (tile >> (kRadixLog * l)) & (kThreads - 1);
    if (a == 0) continue;
    const long long first = (tile >> (kRadixLog * (l + 1))) << kRadixLog;
    const double v = tid < a ? wait_node(nodes(l) + first + tid, tag) : 0.0;
    carry = carry + block_sum(v, red);
  }
  if (tid == 0) s_carry = carry;
  __syncthreads();
  carry = s_carry;

  // 5. Outputs: float32(carry + L), staged back and stored coalesced.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int at = pad(r0 + j);
    buf[at] = __double2float_rn(carry + (double)(run_off + buf[at]));
  }
  __syncthreads();
  float m = neg_inf();
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int x = (k * kThreads + tid) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = buf[pad(x + e)];
    store4(occ, base + x, T, o_vec, v);
    if constexpr (kCap) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (base + x + e < T) m = nan_max(m, v[e] - zc[4 * k + e]);
    }
  }
  if constexpr (kCap) {
    m = warp_max(m);
    if (lane == 0) warp_part[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = warp_max(lane < kWarps ? warp_part[lane] : neg_inf());
      if (lane == 0) store_node(tmax + tile, (double)m, tag);
    }
  }

  // 6. With the cap, the last tile's block takes the max of the tile maxima.
  if constexpr (kCap) {
    if (tile != tiles - 1) return;
    __syncthreads();   // warp 0 is done with warp_part
    float mm = neg_inf();
    for (long long i = tid; i < tiles; i += kThreads)
      mm = nan_max(mm, (float)wait_node(tmax + i, tag));
    mm = warp_max(mm);
    if (lane == 0) warp_part[warp] = mm;
    __syncthreads();
    if (warp == 0) {
      mm = warp_max(lane < kWarps ? warp_part[lane] : neg_inf());
      if (lane == 0) excess[0] = mm;
    }
  }
}

template <typename D, int kItems>
void launch_items(const D* d, const float* zcap, float* occ, float* excess,
                  unsigned char* s, const Layout& lay, long long T,
                  cudaStream_t stream) {
  const unsigned grid = (unsigned)lay.count[0];
  if (zcap == nullptr)
    occupancy_scan<D, false, kItems><<<grid, kThreads, 0, stream>>>(
        d, nullptr, occ, nullptr, s, lay, T);
  else
    occupancy_scan<D, true, kItems><<<grid, kThreads, 0, stream>>>(
        d, zcap, occ, excess, s, lay, T);
}

template <typename D>
int launch(const void* deltas, const void* zcap, void* occ, void* excess,
           void* scratch, long long T, void* stream_ptr) {
  if (T < 1 || num_tiles(T) > INT_MAX) return (int)cudaErrorInvalidValue;
  const Layout lay = make_layout(num_tiles(T));
  const D* d = static_cast<const D*>(deltas);
  const float* z = static_cast<const float*>(zcap);
  float* out = static_cast<float*>(occ);
  float* ex = static_cast<float*>(excess);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (items_per_thread(T) == 8)
    launch_items<D, 8>(d, z, out, ex, s, lay, T, stream);
  else
    launch_items<D, 16>(d, z, out, ex, s, lay, T, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call on T items needs. The scratch must be zeroed
// before its first call and then serve one stream only.
extern "C" long long occupancy_scan_scratch_floats(long long T) {
  return make_layout(num_tiles(T < 1 ? 1 : T)).bytes / 4;
}

// k of the rounding bound in the note above: |occ[p] - exact| is below
// k * 2^-24 * sum_{q<=p} |d_q|.
extern "C" long long occupancy_scan_error_chain(long long T) {
  return (items_per_thread(T) - 1) + 5 + 3 + 1 + 1 + 2;
}

// deltas: (T,) float32, or int32 when deltas_int32 != 0; occ: (T,) float32;
// scratch: occupancy_scan_scratch_floats(T) floats, zeroed before its first
// call. Starts one kernel on the stream. Returns the CUDA error of the
// launch, 0 on success.
extern "C" int interval_occupancy_launch(const void* deltas, int deltas_int32,
                                         void* occ, void* scratch,
                                         long long T, void* stream) {
  if (deltas_int32)
    return launch<int>(deltas, nullptr, occ, nullptr, scratch, T, stream);
  return launch<float>(deltas, nullptr, occ, nullptr, scratch, T, stream);
}

// As interval_occupancy_launch, plus zcap: (T,) float32 and excess: one
// float32, max(occ - zcap). Starts one kernel on the stream.
extern "C" int occupancy_feasible_launch(const void* deltas, int deltas_int32,
                                         const void* zcap, void* occ,
                                         void* excess, void* scratch,
                                         long long T, void* stream) {
  if (zcap == nullptr) return (int)cudaErrorInvalidValue;
  if (deltas_int32)
    return launch<int>(deltas, zcap, occ, excess, scratch, T, stream);
  return launch<float>(deltas, zcap, occ, excess, scratch, T, stream);
}
