// evict_argmin: the eviction decision of every priority policy, batched over
// the cells of a replay sweep.
//
// Replaces: src/repro/kernels/evict_argmin.py, evict_argmin_pallas (body
// _kernel), the Pallas TPU kernel that reduces one (N,) object table with a
// running (score, touch, index) minimum carried in SMEM across a sequential
// grid.
//
// What bounds it on an H100: bytes. Each call reads C*N*(4 + 4 + 1) bytes
// (score, touch, mask) and does one compare per entry, far below the card's
// compare rate, so the floor is those bytes over 3.35 TB/s.
//
// Design: one block per row (cell), so the C rows of a sweep step run on C
// SMs at once. Each thread walks the row with a block-wide stride (adjacent
// threads on adjacent addresses, so loads coalesce) and keeps the
// lexicographic minimum of (s, touch, index) in registers, with
// s = mask ? float(score) : 3.4e38f. A warp-shuffle reduction and then one
// across warps in shared memory give the row's winner. Index and touch stay
// int32 all the way (the TPU kernel carried them in float32, which is exact
// only below 2^24). Scores compare with float < and ==, so -0.0 and 0.0 tie
// as in the plain version. A NaN anywhere in a row makes the plain version's
// min NaN and its answer index 0 with score s[0]; a flag reproduces that.
// The minimum is taken over all N entries, masked ones at 3.4e38f, so an
// empty row gives the plain version's answer and the index is always in
// [0, N).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (s1, t1, i1) < (s2, t2, i2) lexicographically.
__device__ __forceinline__ bool lex_less(float s1, int t1, int i1, float s2,
                                         int t2, int i2) {
  return s1 < s2 || (s1 == s2 && (t1 < t2 || (t1 == t2 && i1 < i2)));
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
evict_argmin_kernel(const S* __restrict__ scores,
                    const int* __restrict__ touch,
                    const unsigned char* __restrict__ mask,
                    int* __restrict__ out_idx, float* __restrict__ out_score,
                    int n, long long touch_row_stride) {
  const long long row = blockIdx.x;
  const S* srow = scores + row * n;
  const unsigned char* mrow = mask + row * n;
  const int* trow = touch + row * touch_row_stride;

  // Sentinel: +inf with the largest touch and index loses to every real
  // entry that is not NaN, including one whose score is +inf.
  float bs = __int_as_float(0x7f800000);
  int bt = INT_MAX;
  int bi = INT_MAX;
  int nan_seen = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float s = mrow[j] ? to_float(srow[j]) : kBig;
    const int t = trow[j];
    nan_seen |= (s != s);
    if (lex_less(s, t, j, bs, bt, bi)) {
      bs = s;
      bt = t;
      bi = j;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int ot = __shfl_down_sync(0xffffffffu, bt, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (lex_less(os, ot, oi, bs, bt, bi)) {
      bs = os;
      bt = ot;
      bi = oi;
    }
  }
  nan_seen = __any_sync(0xffffffffu, nan_seen);

  constexpr int kWarps = kThreads / 32;
  __shared__ float ws[kWarps];
  __shared__ int wt[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int wn[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = bs;
    wt[warp] = bt;
    wi[warp] = bi;
    wn[warp] = nan_seen;
  }
  __syncthreads();
  if (warp != 0) return;

  bs = lane < kWarps ? ws[lane] : __int_as_float(0x7f800000);
  bt = lane < kWarps ? wt[lane] : INT_MAX;
  bi = lane < kWarps ? wi[lane] : INT_MAX;
  nan_seen = lane < kWarps ? wn[lane] : 0;
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int ot = __shfl_down_sync(0xffffffffu, bt, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (lex_less(os, ot, oi, bs, bt, bi)) {
      bs = os;
      bt = ot;
      bi = oi;
    }
  }
  nan_seen = __any_sync(0xffffffffu, nan_seen);
  if (lane == 0) {
    if (nan_seen) {
      bi = 0;
      bs = mrow[0] ? to_float(srow[0]) : kBig;
    }
    out_idx[row] = bi;
    out_score[row] = bs;
  }
}

template <typename S>
int launch(const void* scores, const void* touch, const void* mask,
           void* out_idx, void* out_score, int rows, int n,
           long long touch_row_stride, void* stream) {
  evict_argmin_kernel<S><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const S*>(scores), static_cast<const int*>(touch),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out_idx),
      static_cast<float*>(out_score), n, touch_row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// scores: (rows, n) float32 (is_bf16 == 0) or bfloat16, contiguous;
// touch: int32 rows of n with the given row stride (0 broadcasts one row);
// mask: (rows, n) bytes, nonzero where the entry may be chosen.
// Writes out_idx (rows,) int32 and out_score (rows,) float32. Returns the
// CUDA error of the launch, 0 on success.
extern "C" int evict_argmin_launch(const void* scores, int is_bf16,
                                   const void* touch, const void* mask,
                                   void* out_idx, void* out_score, int rows,
                                   int n, long long touch_row_stride,
                                   void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(scores, touch, mask, out_idx, out_score,
                                 rows, n, touch_row_stride, stream);
  return launch<float>(scores, touch, mask, out_idx, out_score, rows, n,
                       touch_row_stride, stream);
}
