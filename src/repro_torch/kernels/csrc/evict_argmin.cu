// evict_argmin: the eviction decision of every priority policy, batched over
// the cells of a replay sweep.
//
// Replaces: src/repro/kernels/evict_argmin.py, evict_argmin_pallas (body
// _kernel), the Pallas TPU kernel that reduces one (N,) object table with a
// running (score, touch, index) minimum carried in SMEM across a sequential
// grid.
//
// What bounds it on an H100: bytes, and at the replay's shape (96 rows of
// 20,000 objects, a few hundred to a few thousand cached a row) latency.
// A dense read of each row is C*N*(4 + 4 + 1) bytes (score, touch, mask);
// what the data needs is every mask byte plus the score and touch of each
// cached entry. One compare per entry is far below the card's rate.
//
// Design: one launch; each row is split over a thread-block cluster of 8
// CTAs of 128 threads, so the replay's 96 rows run as 768 CTAs over all 132
// SMs in one wave.
//   * A CTA takes a contiguous slice of the row's 16-entry mask words; each
//     warp takes 32 words, one 16-byte mask load a lane. Then, in 4 rounds
//     (2 for bf16), every lane takes 4 (8) consecutive entries of one word,
//     its mask bytes passed by shuffle from the lane that loaded the word:
//     one 16-byte load of scores and 16-byte loads of touches, neighbouring
//     lanes on neighbouring addresses, so a warp's loads are contiguous. A
//     lane whose mask bytes are all zero loads no score and no touch, so an
//     empty word costs its mask bytes alone.
//   * Rows whose mask does not start on 16 bytes (N not a multiple of 16)
//     get a scalar head up to the first aligned word (rank 0) and a scalar
//     tail after the last whole word (the last rank). Scores or touches
//     whose address at the first word is not 16-byte aligned are loaded one
//     by one; that is uniform over a row.
//   * Each lane keeps the lexicographic minimum of (s, touch, index) with
//     s = mask ? float(score) : 3.4e38f in registers (the compare of
//     argmin_rule.cuh, which replay_scan.cu shares); a butterfly of
//     shuffles gives its warp's winner and NaN flag in every lane. Lanes
//     0..7 write it into that rank's shared memory (distributed shared
//     memory, map_shared_rank), so every CTA holds all 32 warp winners of
//     its row after one cluster barrier; each combines its local copy, and
//     all reach the same row winner. No atomics, no second launch, and no
//     CTA reads another's memory after the barrier, so none waits to exit.
//     A start-up barrier, arrived at on entry and waited for before the
//     first remote write, makes sure every CTA of the cluster is running.
//   * The first pass skips every lane's share whose mask bytes are all
//     zero, which is exact while the winner's s is below 3.4e38f: every
//     skipped entry has s = 3.4e38f and loses. When the winner's s is
//     3.4e38f or more (an empty row, or scores at or above it) the cluster
//     scans its row again densely, every entry, and combines once more; the
//     decision is the same in every CTA.
// Index and touch stay int32 (the TPU kernel carried them in float32, which
// is exact only below 2^24). Scores compare with float < and ==, so -0.0 and
// 0.0 tie as in the plain version. A NaN anywhere in a row makes the plain
// version's min NaN and its answer index 0 with score s[0]; a flag
// reproduces that (a NaN can only come from a cached entry, and every one
// is read). The minimum is taken over all N entries, masked ones at
// 3.4e38f, so the index is always in [0, N).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "argmin_rule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // CTAs a row
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // at most 64 registers a thread, so that the
                               // replay's 96 clusters are resident at once
constexpr int kWarps = kThreads / 32;
constexpr int kWord = 16;     // mask bytes in one 16-byte load
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Entries a lane takes in one 16-byte score load: 4 float32 or 8 bf16.
template <typename S>
constexpr int kPer = 16 / (int)sizeof(S);

// kPer<S> scores from p on, upcast to float32.
__device__ __forceinline__ void load_part(const float* p, bool vec, float* s) {
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    s[0] = f.x; s[1] = f.y; s[2] = f.z; s[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = p[e];
  }
}

__device__ __forceinline__ void load_part(const __nv_bfloat16* p, bool vec,
                                          float* s) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {   // bf16 is the high half of a float32
      s[2 * h] = __uint_as_float(w[h] << 16);
      s[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = __bfloat162float(p[e]);
  }
}

// E touches from p on.
template <int E>
__device__ __forceinline__ void load_touch(const int* p, bool vec, int* t) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const int4 f = reinterpret_cast<const int4*>(p)[k];
      t[4 * k] = f.x; t[4 * k + 1] = f.y; t[4 * k + 2] = f.z;
      t[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) t[e] = p[e];
  }
}

template <typename S>
__device__ __forceinline__ void take_entry(Best& b, int& nan_seen,
                                           const S* srow, const int* trow,
                                           const unsigned char* mrow, int j) {
  take(b, nan_seen, mrow[j] ? to_float(srow[j]) : kBig, trow[j], j);
}

// One warp's share of a slice: chunks of 32 mask words, one 16-byte load a
// lane, then kWord / E rounds in which each lane takes E consecutive
// entries of one word (scores and touches in 16-byte loads, neighbouring
// lanes on neighbouring addresses). A lane whose E mask bytes are all zero
// loads nothing, unless the pass is dense.
template <typename S>
__device__ __forceinline__ void take_words(Best& b, int& nan_seen,
                                           const S* srow, const int* trow,
                                           const unsigned char* mrow,
                                           int head, int lo, int hi,
                                           bool dense, bool s_vec, bool t_vec,
                                           int warp, int lane) {
  constexpr int E = kPer<S>;
  constexpr int kLanesPerWord = kWord / E;
  constexpr int kRounds = kLanesPerWord;     // 32 words, 32 / L a round
  for (int c0 = lo + 32 * warp; c0 < hi; c0 += 32 * kWarps) {
    const uint4 m =
        c0 + lane < hi
            ? *reinterpret_cast<const uint4*>(mrow + head + (c0 + lane) * kWord)
            : make_uint4(0u, 0u, 0u, 0u);
    float sv[kRounds][E];
    int tv[kRounds][E];
    unsigned long long bits[kRounds];
    bool act[kRounds];
    int j0[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int src = r * (32 / kLanesPerWord) + lane / kLanesPerWord;
      const int part = lane % kLanesPerWord;
      const unsigned x = __shfl_sync(kFull, m.x, src);
      const unsigned y = __shfl_sync(kFull, m.y, src);
      const unsigned z = __shfl_sync(kFull, m.z, src);
      const unsigned w = __shfl_sync(kFull, m.w, src);
      if (E == 4)
        bits[r] = part == 0 ? x : part == 1 ? y : part == 2 ? z : w;
      else
        bits[r] = part == 0 ? (x | (unsigned long long)y << 32)
                            : (z | (unsigned long long)w << 32);
      act[r] = c0 + src < hi && (dense || bits[r] != 0);
      j0[r] = head + (c0 + src) * kWord + part * E;
      if (act[r]) {
        load_part(srow + j0[r], s_vec, sv[r]);
        load_touch<E>(trow + j0[r], t_vec, tv[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (!act[r]) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool cached = (bits[r] >> (8 * e)) & 0xffu;
        take(b, nan_seen, cached ? sv[r][e] : kBig, tv[r][e], j0[r] + e);
      }
    }
  }
}

// A warp's winner, as every CTA of the cluster receives it.
struct alignas(16) Slot {
  Best best;
  int nan_seen;
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename S>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks)
    evict_argmin_kernel(const S* __restrict__ scores,
                    const int* __restrict__ touch,
                    const unsigned char* __restrict__ mask,
                    int* __restrict__ out_idx, float* __restrict__ out_score,
                    int n, long long touch_row_stride) {
  // Every CTA of the cluster must have started before any writes into its
  // shared memory: arrive now, wait just before the first remote write.
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row = blockIdx.x / kCluster;
  const S* srow = scores + row * n;
  const unsigned char* mrow = mask + row * n;
  const int* trow = touch + row * touch_row_stride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Head up to the first 16-byte aligned mask word, whole words, tail.
  const int head =
      min(n, (int)((kWord - (reinterpret_cast<uintptr_t>(mrow) & 15)) & 15));
  const int words = (n - head) / kWord;
  const int tail = head + words * kWord;
  const bool s_vec = aligned16(srow + head);
  const bool t_vec = aligned16(trow + head);
  const int lo = (int)((long long)words * rank / kCluster);
  const int hi = (int)((long long)words * (rank + 1) / kCluster);

  __shared__ Slot slots[2][kCluster * kWarps];

  Best r;
  int r_nan;
  for (int dense = 0;; dense = 1) {
    Best b = sentinel();
    int nan_seen = 0;
    if (rank == 0 && tid < head)
      take_entry(b, nan_seen, srow, trow, mrow, tid);
    if (rank == kCluster - 1 && tail + tid < n)
      take_entry(b, nan_seen, srow, trow, mrow, tail + tid);
    take_words(b, nan_seen, srow, trow, mrow, head, lo, hi, dense, s_vec,
               t_vec, warp, lane);

    // The warp's winner in every lane, then sent to every CTA's slots.
    b = warp_min(b);
    nan_seen = __any_sync(kFull, nan_seen);
    if (!dense) cluster_wait();   // the start-up barrier
    if (lane < kCluster)
      cluster.map_shared_rank(&slots[dense][0], lane)[rank * kWarps + warp] =
          Slot{b, nan_seen};
    cluster_arrive();
    cluster_wait();

    // The row's winner, combined from the local copy in the same order by
    // every warp of every CTA.
    r = sentinel();
    r_nan = 0;
    for (int k = lane; k < kCluster * kWarps; k += 32) {
      const Slot q = slots[dense][k];
      if (less(q.best, r)) r = q.best;
      r_nan |= q.nan_seen;
    }
    r = warp_min(r);
    r_nan = __any_sync(kFull, r_nan);
    if (dense || r_nan || r.s < kBig) break;   // the same in every CTA
  }

  if (rank == 0 && tid == 0) {
    if (r_nan) {
      out_idx[row] = 0;
      out_score[row] = mrow[0] ? to_float(srow[0]) : kBig;
    } else {
      out_idx[row] = r.i;
      out_score[row] = r.s;
    }
  }
}

template <typename S>
int launch(const void* scores, const void* touch, const void* mask,
           void* out_idx, void* out_score, int rows, int n,
           long long touch_row_stride, void* stream) {
  if (rows < 1 || n < 1 || (long long)rows * kCluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  evict_argmin_kernel<S>
      <<<rows * kCluster, kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const S*>(scores), static_cast<const int*>(touch),
          static_cast<const unsigned char*>(mask), static_cast<int*>(out_idx),
          static_cast<float*>(out_score), n, touch_row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// scores: (rows, n) float32 (is_bf16 == 0) or bfloat16, contiguous;
// touch: int32 rows of n with the given row stride (0 broadcasts one row);
// mask: (rows, n) bytes, nonzero where the entry may be chosen.
// Writes out_idx (rows,) int32 and out_score (rows,) float32. One cluster
// launch of 8 CTAs a row. Returns the CUDA error of the launch, 0 on
// success (a refused cluster launch is an error; nothing falls back).
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
