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
// one compare per item are far below the card's rate. At the 200,000
// requests of cost-FOO's CDN trace the bound is 0.72 us, less than one
// launch, so there the launches set the time.
//
// Design: blocks on Hopper run in no order and nothing carries from one to
// the next, so the TPU's carried total becomes reduce-then-scan. One call of
// an entry point starts three device kernels on the caller's stream
// (interval_occupancy_launch), or four with the cap
// (occupancy_feasible_launch):
//   1. tile_sums: one block of 256 threads per tile of 4096 items, 16
//      consecutive items a thread. Each thread adds its items in order, then
//      a warp-shuffle tree and a tree over the 8 warp sums give the tile sum.
//   2. carry_scan: one block of 1024 threads turns the tile sums into
//      exclusive carries, in place. Each thread adds a run of
//      R = ceil(tiles / 1024) consecutive sums in order; a Kogge-Stone scan
//      over the lanes and one over the 32 warp totals give each run its
//      offset, and the thread writes the run's carries.
//   3. scan_tiles: each block reads its tile again, scans it (running sum in
//      the thread, Kogge-Stone scans over lanes and over the 8 warps), adds
//      its carry and writes occ. With the cap it also reduces max(occ - zcap)
//      over its tile to one float.
//   4. max_reduce (with the cap): one block takes the max of the tile maxima.
//      A max is exact and does not depend on order.
// Sums are float32, as in the reference; int32 deltas are converted to
// float32 item by item before they are added, like astype(float32). There
// are no float atomics, so two runs give equal bits. The ragged tail is
// masked (a masked item adds 0.0 and is left out of the max), and offsets
// are 64-bit. A NaN propagates into the excess, as in torch.amax.
//
// Rounding: every output equals any other summation order's bit for bit
// when all partial sums are exact in float32 (integer-valued deltas whose
// absolute sum stays below 2^24). In general occ[p] is a tree sum of
// d_0..d_p in which no summand passes through more than
// D = 2R + 35 additions: 15 (items) + 5 (warp tree) + 3 (warp-sum tree) in
// tile_sums; (R - 1) + 5 + 5 + 1 + (R - 1) in carry_scan; 3 in scan_tiles
// (carry + warp offset + lane offset + the thread's running sum). So
// |occ[p] - exact| <= gamma_D * sum_{q<=p} |d_q|
//                  <  k * 2^-24 * sum_{q<=p} |d_q|
// with k = D + 1 = 2R + 36, which occupancy_scan_error_chain returns; k is 38
// up to 4M items and 68 at 2^26.
//
// Left for later: a single pass with decoupled look-back, vector or TMA
// loads, and staging the strided per-thread loads and stores through shared
// memory.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr long long kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kCarryThreads = 1024;
constexpr int kCarryWarps = kCarryThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// max that returns NaN if either side is NaN, like torch.amax.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
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

template <typename D>
__global__ void __launch_bounds__(kThreads)
tile_sums(const D* __restrict__ deltas, float* __restrict__ sums,
          long long T) {
  const long long first =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long q = first + i;
    s += q < T ? to_f32(deltas[q]) : 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(kFull, s, off);
  __shared__ float warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_sum[lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      w += __shfl_down_sync(kFull, w, off);
    if (lane == 0) sums[blockIdx.x] = w;
  }
}

// sums: (tiles,) tile sums in, exclusive carries out.
__global__ void __launch_bounds__(kCarryThreads)
carry_scan(float* __restrict__ sums, long long tiles) {
  const long long run = (tiles + kCarryThreads - 1) / kCarryThreads;
  const long long lo = (long long)threadIdx.x * run;
  const long long hi = lo + run < tiles ? lo + run : tiles;
  float total = 0.0f;
  for (long long i = lo; i < hi; ++i) total += sums[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float incl = warp_inclusive_scan(total, lane);
  const float lane_off = lane_exclusive(incl, lane);
  __shared__ float warp_off[kCarryWarps];
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {   // kCarryWarps == 32: one warp total a lane
    const float w = warp_inclusive_scan(warp_off[lane], lane);
    warp_off[lane] = lane_exclusive(w, lane);
  }
  __syncthreads();
  float r = warp_off[warp] + lane_off;
  for (long long i = lo; i < hi; ++i) {
    const float v = sums[i];
    sums[i] = r;
    r += v;
  }
}

template <typename D, bool kCap>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const D* __restrict__ deltas, const float* __restrict__ zcap,
           const float* __restrict__ carry, float* __restrict__ occ,
           float* __restrict__ tile_max, long long T) {
  const long long first =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  float p[kItems];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long q = first + i;
    s += q < T ? to_f32(deltas[q]) : 0.0f;
    p[i] = s;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float incl = warp_inclusive_scan(s, lane);
  const float lane_off = lane_exclusive(incl, lane);
  __shared__ float warp_off[kWarps];
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w =
        warp_inclusive_scan(lane < kWarps ? warp_off[lane] : 0.0f, lane);
    const float w_off = lane_exclusive(w, lane);
    if (lane < kWarps) warp_off[lane] = w_off;
  }
  __syncthreads();
  const float base = (carry[blockIdx.x] + warp_off[warp]) + lane_off;
  float m = neg_inf();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long q = first + i;
    if (q < T) {
      const float o = base + p[i];
      occ[q] = o;
      if constexpr (kCap) m = nan_max(m, o - zcap[q]);
    }
  }
  if constexpr (kCap) {
    __shared__ float warp_m[kWarps];
    m = warp_max(m);
    if (lane == 0) warp_m[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = warp_max(lane < kWarps ? warp_m[lane] : neg_inf());
      if (lane == 0) tile_max[blockIdx.x] = m;
    }
  }
}

__global__ void __launch_bounds__(kCarryThreads)
max_reduce(const float* __restrict__ tile_max, float* __restrict__ out,
           long long tiles) {
  float m = neg_inf();
  for (long long i = threadIdx.x; i < tiles; i += kCarryThreads)
    m = nan_max(m, tile_max[i]);
  m = warp_max(m);
  __shared__ float warp_m[kCarryWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(warp_m[lane]);
    if (lane == 0) out[0] = m;
  }
}

long long num_tiles(long long T) { return (T + kTile - 1) / kTile; }

// Three kernels, or four when zcap is given; scratch holds 2 * tiles floats
// (tile sums, then carries, in the first half; tile maxima in the second).
template <typename D>
int launch(const void* deltas, const void* zcap, void* occ, void* excess,
           void* scratch, long long T, void* stream_ptr) {
  const long long tiles = num_tiles(T);
  if (T < 1 || tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const D* d = static_cast<const D*>(deltas);
  float* sums = static_cast<float*>(scratch);
  float* tmax = sums + tiles;
  float* out = static_cast<float*>(occ);
  const unsigned grid = (unsigned)tiles;
  cudaError_t err;
  tile_sums<D><<<grid, kThreads, 0, stream>>>(d, sums, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  carry_scan<<<1, kCarryThreads, 0, stream>>>(sums, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (zcap == nullptr) {
    scan_tiles<D, false><<<grid, kThreads, 0, stream>>>(d, nullptr, sums, out,
                                                         nullptr, T);
    return (int)cudaGetLastError();
  }
  scan_tiles<D, true><<<grid, kThreads, 0, stream>>>(
      d, static_cast<const float*>(zcap), sums, out, tmax, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  max_reduce<<<1, kCarryThreads, 0, stream>>>(
      tmax, static_cast<float*>(excess), tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call on T items needs.
extern "C" long long occupancy_scan_scratch_floats(long long T) {
  return 2 * num_tiles(T);
}

// k of the rounding bound in the note above: |occ[p] - exact| is below
// k * 2^-24 * sum_{q<=p} |d_q|.
extern "C" long long occupancy_scan_error_chain(long long T) {
  const long long run = (num_tiles(T) + kCarryThreads - 1) / kCarryThreads;
  return 2 * run + 36;
}

// deltas: (T,) float32, or int32 when deltas_int32 != 0; occ: (T,) float32;
// scratch: occupancy_scan_scratch_floats(T) floats. Starts three kernels on
// the stream. Returns the CUDA error of the launches, 0 on success.
extern "C" int interval_occupancy_launch(const void* deltas, int deltas_int32,
                                         void* occ, void* scratch,
                                         long long T, void* stream) {
  if (deltas_int32)
    return launch<int>(deltas, nullptr, occ, nullptr, scratch, T, stream);
  return launch<float>(deltas, nullptr, occ, nullptr, scratch, T, stream);
}

// As interval_occupancy_launch, plus zcap: (T,) float32 and excess: one
// float32, max(occ - zcap). Starts four kernels on the stream.
extern "C" int occupancy_feasible_launch(const void* deltas, int deltas_int32,
                                         const void* zcap, void* occ,
                                         void* excess, void* scratch,
                                         long long T, void* stream) {
  if (zcap == nullptr) return (int)cudaErrorInvalidValue;
  if (deltas_int32)
    return launch<int>(deltas, zcap, occ, excess, scratch, T, stream);
  return launch<float>(deltas, zcap, occ, excess, scratch, T, stream);
}
