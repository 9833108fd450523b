// replay_scan: the paper's sweep -- the replay of one trace under every
// (policy, price vector, budget) cell -- as one launch.
//
// Replaces: src/repro/core/policies_jax.py, _simulate (the lax.scan whose
// step picks its victim with kernels.evict_argmin, the Pallas kernel
// evict_argmin_pallas on a TPU), vmapped three deep by _sweep_grid into the
// one grid program of sweep_jax. The plain version is the port's step loop,
// src/repro_torch/core/policies_torch.py, _replay(use_kernel=False).
//
// What bounds it on an H100: latency. Each cell is a chain of T dependent
// steps. The bytes it must move (the trace once, three cost columns and a
// size a request, the outputs) and its operations (one score a cached
// object on each step that evicts) are both far below the card's rates.
//
// Design: one CTA of 512 threads a cell, cell c = (q*P + p)*K + k; the CTA
// walks the T requests itself, as the scan does.
//   * A cell's cache is a table of slots, not an (N,) row: a slot holds the
//     object, its last touch, its next use, the part of its score fixed at
//     the touch (sb = static + w_bel * bel), its size and -max(cost, 1e-30).
//     An (N,) object -> slot map answers is_hit. A cached object's touch and
//     next use change only when it is requested, and a request always
//     touches it, so the table is exact. A victim's slot takes the object
//     that displaces it; a miss with room appends.
//   * Only a miss with used >= budget needs the victim (the plain version's
//     do_evict). Thread 0 walks the requests alone -- hits and misses with
//     room touch one slot -- until such a step, a chunk's end or a full
//     table; there every thread meets at a barrier. On an evicting step all
//     threads score the used slots and reduce (score, touch, object) with
//     argmin_rule.cuh's compare, the rule of evict_argmin.cu.
//   * Every score repeats the plain version's float32 operations in its
//     order, written as __fadd_rn / __fmul_rn / __fdiv_rn so that no
//     multiply-add is contracted whatever the flags, and evaluated for every
//     weight, zero or not (0 * inf is NaN there too). Dollars add up in step
//     order in float32.
//   * The NaN rule: a NaN among the scores makes the plain version's min NaN;
//     its victim is then object 0 with object 0's score (3.4e38 when object 0
//     is not cached), evicted when that score is below 3.4e38. A miss always
//     inserts, so when no score is below 3.4e38 the table grows past its
//     budget, up to all N objects.
//   * Requests are staged, not chased: all threads gather a chunk of 512
//     requests (id, next use, frequency rank, cost, cost / size, size,
//     -max(cost, 1e-30)) into shared memory, so thread 0 reads no device
//     memory on its way. The frequency rank (the count of ids[t] in
//     ids[:t+1]) is the same in every cell and comes from the host.
//   * The map lives in shared memory while it takes at most half of what a
//     block may have, else in a (C, N) region of device memory. The slot
//     table starts in the shared memory left over; a cell whose table
//     outgrows it copies it once into its own region of N slots in device
//     memory, of the same layout, and goes on there. The host picks the
//     layout (kernels/replay_scan.py, plan()) and this file checks it.
//   * Per cell the kernel also writes its work: the steps that scored, the
//     slots scored over them, and the largest table it held.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "argmin_rule.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;          // requests staged at once
constexpr int kStageWords = 7;       // words a staged request
constexpr int kSlotWords = 6;        // words a slot
constexpr int kStageBytes = kChunk * kStageWords * 4;
constexpr float kBig = 3.4e38f;

// What thread 0 stopped at.
constexpr int kChunkDone = 0;   // the chunk is replayed
constexpr int kScore = 1;       // an evicting step needs its victim
constexpr int kSpill = 2;       // the table must move to device memory

// Where thread 0 is inside a step.
constexpr int kFresh = 0;       // nothing of the step done
constexpr int kDecided = 1;     // dollars and hits done; victim known
constexpr int kAppend = 2;      // dollars and hits done; append the object

struct Slots {
  int* obj;
  int* touch;
  int* nu;
  float* sb;
  float* size;
  float* negcf;
};

// Six arrays of `stride` words from base on.
__device__ __forceinline__ Slots slot_table(void* base, long long stride) {
  int* w = static_cast<int*>(base);
  return Slots{w, w + stride, w + 2 * stride,
               reinterpret_cast<float*>(w + 3 * stride),
               reinterpret_cast<float*>(w + 4 * stride),
               reinterpret_cast<float*>(w + 5 * stride)};
}

// The plain version's raw score of a cached object at step tf:
// (static + w_bel * bel) + w_cb * cb, cb = (size * gap) / -max(cost, 1e-30),
// gap = max(next - t, 1), cb = -3.4e38 for an object never used again.
__device__ __forceinline__ float score(float sb, int nu, float size,
                                       float negcf, float tf, int T,
                                       float w_cb) {
  const float gap = fmaxf(__fsub_rn(__int2float_rn(nu), tf), 1.0f);
  const float cb =
      nu >= T ? -kBig : __fdiv_rn(__fmul_rn(size, gap), negcf);
  return __fadd_rn(sb, __fmul_rn(w_cb, cb));
}

// The part of an object's score fixed at its touch at step tf:
// static = ((w0*t + w1*f) + w2*(L + c/s)) + w3*(L + f*(c/s)), plus
// w_bel * bel with bel = -next (-3.4e38 for an object never used again).
__device__ __forceinline__ float fixed_score(const float* w, float tf,
                                             float fi, float infl, float cos,
                                             int nu, int T) {
  const float a = __fmul_rn(w[0], tf);
  const float b = __fmul_rn(w[1], fi);
  const float c = __fmul_rn(w[2], __fadd_rn(infl, cos));
  const float d = __fmul_rn(w[3], __fadd_rn(infl, __fmul_rn(fi, cos)));
  const float stat = __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
  const float bel = nu >= T ? -kBig : -__int2float_rn(nu);
  return __fadd_rn(stat, __fmul_rn(w[4], bel));
}

struct Params {
  const int* ids;
  const int* nxt;
  const int* rank;
  const float* weights;      // (Q, 6)
  const float* costs;        // (P, N)
  const float* c_over_s;     // (P, N)
  const float* neg_cost_floor;  // (P, N)
  const float* sizes;        // (N,)
  const int* budgets;        // (K,)
  float* dollars;            // (C,)
  int* hits;                 // (C,)
  long long* work;           // (C, 3)
  int* map_global;           // (C, N), or null when the map is shared
  int* slots_global;         // (C, 6N), or null when N slots fit shared
  int T, N, P, K;
  int map_shared;            // 1: the map in shared memory
  int slots_shared;          // slots the shared table holds
};

struct Winner {
  Best best;
  int nan_seen;
};

__global__ void __launch_bounds__(kThreads, 1)
    replay_scan_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Winner winners[kWarps];
  __shared__ int ctl_event, ctl_used, ctl_t;

  const int cell = blockIdx.x;
  const int k = cell % p.K;
  const int pi = (cell / p.K) % p.P;
  const int q = cell / p.K / p.P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = p.T, N = p.N;

  int* st_id = reinterpret_cast<int*>(smem);
  int* st_nu = st_id + kChunk;
  int* st_rank = st_nu + kChunk;
  float* st_cost = reinterpret_cast<float*>(st_rank + kChunk);
  float* st_cos = st_cost + kChunk;
  float* st_size = st_cos + kChunk;
  float* st_negcf = st_size + kChunk;
  unsigned char* rest = smem + kStageBytes;
  int* map = p.map_shared ? reinterpret_cast<int*>(rest)
                          : p.map_global + (long long)cell * N;
  unsigned char* shared_slots =
      rest + (p.map_shared ? (((long long)N * 4 + 15) & ~15ll) : 0);
  Slots sl = slot_table(shared_slots, p.slots_shared);
  int capacity = p.slots_shared;   // slots the table holds where it is

  float w[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) w[j] = p.weights[q * 6 + j];
  const bool gd_active = __fadd_rn(w[2], w[3]) > 0.0f;
  const int budget = p.budgets[k];
  const long long row = (long long)pi * N;
  const float* cost_row = p.costs + row;
  const float* cos_row = p.c_over_s + row;
  const float* negcf_row = p.neg_cost_floor + row;

  for (int o = tid; o < N; o += kThreads) map[o] = -1;

  // thread 0's state; the other threads' copies go unused
  int used = 0, hits = 0, pend = kFresh, vslot = -1, peak = 0;
  float infl = 0.0f, dollars = 0.0f, vscore = 0.0f;
  long long scored_steps = 0, scored_slots = 0;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();   // thread 0 is done with the last chunk
    for (int r = tid; r < n; r += kThreads) {
      const int i = p.ids[t0 + r];
      st_id[r] = i;
      st_nu[r] = p.nxt[t0 + r];
      st_rank[r] = p.rank[t0 + r];
      st_cost[r] = cost_row[i];
      st_cos[r] = cos_row[i];
      st_negcf[r] = negcf_row[i];
      st_size[r] = p.sizes[i];
    }
    __syncthreads();
    int j = 0;   // thread 0's next request in the chunk
    for (;;) {
      if (tid == 0) {
        int event = kChunkDone;
        for (; j < n; ++j) {
          const int i = st_id[j];
          int s = -1;
          if (pend == kFresh) {
            s = map[i];
            const bool hit = s >= 0;
            dollars = __fadd_rn(dollars, hit ? 0.0f : st_cost[j]);
            hits += hit;
            if (!hit) {
              if (used >= budget) {
                event = kScore;
                ++scored_steps;
                scored_slots += used;
                break;
              }
              pend = kAppend;
            }
          } else if (pend == kDecided) {
            if (vslot >= 0) {   // the object takes the victim's slot
              if (gd_active) infl = vscore;
              s = vslot;
              map[sl.obj[s]] = -1;
              map[i] = s;
              sl.obj[s] = i;
              sl.size[s] = st_size[j];
              sl.negcf[s] = st_negcf[j];
              pend = kFresh;
            } else {
              pend = kAppend;
            }
          }
          if (pend == kAppend) {
            if (used == capacity) {
              event = kSpill;
              break;
            }
            s = used++;
            peak = max(peak, used);
            map[i] = s;
            sl.obj[s] = i;
            sl.size[s] = st_size[j];
            sl.negcf[s] = st_negcf[j];
            pend = kFresh;
          }
          // the touch: a hit, or the object just inserted
          const int nu = st_nu[j];
          sl.sb[s] = fixed_score(w, __int2float_rn(t0 + j),
                                 __int2float_rn(st_rank[j]), infl, st_cos[j],
                                 nu, T);
          sl.nu[s] = nu;
          sl.touch[s] = t0 + j;
        }
        ctl_event = event;
        ctl_used = used;
        ctl_t = t0 + j;
      }
      __syncthreads();
      const int event = ctl_event;
      if (event == kChunkDone) break;
      const int u = ctl_used;
      if (event == kSpill) {
        // the table moves to this cell's region of N slots, once
        const Slots g = slot_table(p.slots_global + (long long)cell *
                                   kSlotWords * N, N);
        for (int s = tid; s < u; s += kThreads) {
          g.obj[s] = sl.obj[s];
          g.touch[s] = sl.touch[s];
          g.nu[s] = sl.nu[s];
          g.sb[s] = sl.sb[s];
          g.size[s] = sl.size[s];
          g.negcf[s] = sl.negcf[s];
        }
        sl = g;
        capacity = N;
        __syncthreads();
        continue;
      }
      // an evicting step: the minimum of (score, touch, object) over the
      // cached objects (the requested one is not among them: a miss)
      const float tf = __int2float_rn(ctl_t);
      Best b = sentinel();
      int nan_seen = 0;
      for (int s = tid; s < u; s += kThreads)
        take(b, nan_seen,
             score(sl.sb[s], sl.nu[s], sl.size[s], sl.negcf[s], tf, T, w[5]),
             sl.touch[s], sl.obj[s]);
      b = warp_min(b);
      nan_seen = __any_sync(0xffffffffu, nan_seen);
      if (lane == 0) winners[warp] = Winner{b, nan_seen};
      __syncthreads();
      if (warp == 0) {
        const Winner x = lane < kWarps ? winners[lane]
                                       : Winner{sentinel(), 0};
        const Best r = warp_min(x.best);
        const int any_nan = __any_sync(0xffffffffu, x.nan_seen);
        if (tid == 0) {
          if (any_nan) {   // the plain version's victim 0
            vslot = map[0];
            vscore = vslot >= 0
                         ? score(sl.sb[vslot], sl.nu[vslot], sl.size[vslot],
                                 sl.negcf[vslot], tf, T, w[5])
                         : kBig;
          } else {
            vscore = r.s;
            vslot = r.s < kBig ? map[r.i] : -1;
          }
          if (!(vscore < kBig)) vslot = -1;   // nothing is evicted
          pend = kDecided;
        }
      }
    }
  }

  if (tid == 0) {
    p.dollars[cell] = dollars;
    p.hits[cell] = hits;
    p.work[3 * cell] = scored_steps;
    p.work[3 * cell + 1] = scored_slots;
    p.work[3 * cell + 2] = peak;
  }
}

long long shared_bytes(int N, int map_shared, int slots_shared) {
  return kStageBytes + (map_shared ? (((long long)N * 4 + 15) & ~15ll) : 0) +
         (long long)kSlotWords * 4 * slots_shared;
}

}  // namespace

// Dynamic shared memory a block of the kernel may take on the current
// device, or -1 on error.
extern "C" long long replay_scan_shared_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, replay_scan_kernel) != cudaSuccess)
    return -1;
  return (long long)optin - (long long)attr.sharedSizeBytes;
}

// ids, nxt, rank: (T,) int32; weights (Q, 6), costs, c_over_s and
// neg_cost_floor (P, N), sizes (N,) float32; budgets (K,) int32; all on the
// device, contiguous. Writes dollars (C,) float32, hits (C,) int32 and work
// (C, 3) int64 for C = Q*P*K cells. map_global: (C, N) int32 unless
// map_shared; slots_global: (C, 6N) int32 unless slots_shared == N.
// `dynamic_bytes` must be the layout's size as plan() computed it. One
// launch of C blocks on `stream`; returns its CUDA error, 0 on success.
extern "C" int replay_scan_launch(
    const void* ids, const void* nxt, const void* rank, const void* weights,
    const void* costs, const void* c_over_s, const void* neg_cost_floor,
    const void* sizes, const void* budgets, void* dollars, void* hits,
    void* work, void* map_global, void* slots_global, int T, int N, int Q,
    int P, int K, int map_shared, int slots_shared, long long dynamic_bytes,
    void* stream) {
  const long long cells = (long long)Q * P * K;
  if (T < 0 || N < 1 || cells < 1 || cells > INT_MAX || slots_shared < 1 ||
      slots_shared > N || (!map_shared && map_global == nullptr) ||
      (slots_shared < N && slots_global == nullptr) ||
      dynamic_bytes != shared_bytes(N, map_shared, slots_shared) ||
      dynamic_bytes > replay_scan_shared_limit())
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      replay_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dynamic_bytes);
  if (err != cudaSuccess) return (int)err;
  Params p{static_cast<const int*>(ids),
           static_cast<const int*>(nxt),
           static_cast<const int*>(rank),
           static_cast<const float*>(weights),
           static_cast<const float*>(costs),
           static_cast<const float*>(c_over_s),
           static_cast<const float*>(neg_cost_floor),
           static_cast<const float*>(sizes),
           static_cast<const int*>(budgets),
           static_cast<float*>(dollars),
           static_cast<int*>(hits),
           static_cast<long long*>(work),
           static_cast<int*>(map_global),
           static_cast<int*>(slots_global),
           T, N, P, K, map_shared, slots_shared};
  replay_scan_kernel<<<(int)cells, kThreads, (size_t)dynamic_bytes,
                       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
