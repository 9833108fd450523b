// replay_scan: the paper's sweep -- the replay of one trace under every
// (policy, price vector, budget) cell -- as one launch.
//
// Replaces: src/repro/core/policies_jax.py, _simulate (the lax.scan whose
// step picks its victim with kernels.evict_argmin, the Pallas kernel
// evict_argmin_pallas on a TPU), vmapped three deep by _sweep_grid into the
// one grid program of sweep_jax. The plain version is the port's step loop,
// src/repro_torch/core/policies_torch.py, _replay(use_kernel=False).
//
// What bounds it on an H100: the slowest cell's chain of dependent steps.
// One block replays one cell, and the launch lasts as long as its slowest
// cell. The bytes it must move (the trace once, three cost columns and a
// size a request, the outputs) and its operations (one score a cached
// object on each step that evicts) are both far below the card's rates;
// what counts is the latency of each step, above all of the steps that
// evict (a miss with a full cache), on a chain where one warp alone issues
// (PERF.md: about four cycles an instruction).
//
// Layout: one CTA of 512 threads a cell, cell c = (q*P + p)*K + k.
//   * The launch order. A block takes an SM's registers (launch bounds 512,
//     1), so a grid of more cells than the card has SMs replays in waves,
//     and the hardware hands out blocks in index order. In such a grid
//     block b replays the b-th cell in (class, q, p, k) order, the class of
//     row q read from its weights: 0 where w_cb != 0 (every evicting step
//     scores in full), 1 in GreedyDual rows (w_gd + w_gdsf > 0: the victim
//     rescored, infl carried), 2 where the score is fixed at the touch. The
//     rows that take longest thus start in the first wave, and within a
//     class the grid's own order holds. A grid of one wave keeps block b on
//     cell b: its cells all start at once, and moving them only moves which
//     SMs share a TPC, which cost cdn_bytes.panel96's slowest cell 2 % in
//     class order (PERF.md). Every block finds its cell from the (Q, 6)
//     weights and the SM count alone (launch_cell); every output stays
//     indexed by cell, so the order changes no result.
//   * A cell's cache is a table of slots, not an (N,) row: a slot holds the
//     object, its next use, the part of its score fixed at the touch (sb =
//     static + w_bel * bel), its size, -max(cost, 1e-30), and one 8-byte
//     key, (order image of sb) << 32 | touch. An (N,) object -> slot map
//     answers is_hit. A cached object's touch and next use change only when
//     it is requested, and a request always touches it, so the table is
//     exact. A victim's slot takes the object that displaces it; a miss with
//     room appends.
//   * Requests are staged, not chased: all threads gather a chunk of 512
//     requests into shared memory (id, next use, cost, size, -max(cost,
//     1e-30), cost / size, and the parts of sb known before the touch), so
//     the walk reads no device memory. The frequency rank (the count of
//     ids[t] in ids[:t+1]) is the same in every cell and comes from next_use.
//   * The map lives in shared memory while it takes at most half of what a
//     block may have, else in a (C, N) region of device memory. The slot
//     table starts in the shared memory left over; a cell whose table
//     outgrows it copies it once into its own region of N slots in device
//     memory, of the same layout, and goes on there. The host picks the
//     layout (kernels/replay_scan.py, plan()) and this file checks it. The
//     kernel is built twice, for a map in shared and in device memory, and
//     the walk and the scan twice, for a table in each, so that every
//     access is a shared or a global one and no pointer is chosen at run
//     time (a chosen one put the table's pointers in local memory).
//
// The walk. Warp 0 replays the chunk in lockstep, every lane on the same
// state, so its loads are broadcasts and an evicting step needs no hand-off
// at all: no __syncthreads, no shuffle, no control word. Runs of hits go a
// warp at a time: the 32 lanes look up the next 32 requests, every request
// before the first miss (__ballot_sync) is a hit as of its own step, and
// each slot in the run takes the touch of its last request there (an
// atomicMax on the key's touch word picks it; touches only grow).
//
// An evicting step, as short a chain as the table allows:
//   * The warps follow the table. Each chunk, every warp counts the same
//     scoring warps from the table its evicting steps will see, max(used,
//     budget): one warp while that is at most `one` slots, else one for
//     each `per` slots, 2 to 16 (kStaticOne/Per and kFullOne/Per below,
//     mirrored in kernels/replay_scan.py; the warps past the count wait at
//     the next chunk's barrier). Rows whose
//     score is fixed at the touch take one = 1,024, per = 320: their scan
//     is one 8-byte load and a 64-bit compare a slot, and a second warp
//     costs a barrier round trip and a second reduction, ~450 cycles, which
//     a one-warp scan of up to ~32 slots a lane does not exceed. The other
//     rows take one = per = 128: a slot costs a division and five more
//     words. Set from the per-cell cycles on the card (PERF.md).
//     With more than one warp, warp 0 writes the step into shared memory
//     and arrives at named barrier 1 (bar.arrive 1, 32 * warps), where the
//     helpers wait; they score their share, write their winner and arrive
//     at barrier 2, where warp 0 waits after scoring its own: one round
//     trip over the scoring warps alone, never a block barrier. A table
//     that grows inside a chunk is still covered (each lane loops over its
//     slots); the next chunk recounts.
//   * The argmin is redux.sync, not a shuffle tree (argmin_rule.cuh,
//     warp_argmin_distinct): a cached object's touch is the step it was
//     last requested, so touches are distinct and (score, touch) is a total
//     order, and the index compare of evict_argmin's rule is never reached.
//     Each lane keeps its least key over its slots (four chains of loads
//     and compares); the warp takes __reduce_min_sync of the image, and of
//     the touch only when several lanes hold that image, then shuffles the
//     key and slot from the lane that holds both, so the victim needs no map
//     read. Across warps the same reduction runs over the warps' winners. A
//     NaN score takes image 0, below every real one, so the first reduction
//     also tells whether a NaN is among the scores.
//   * No division in the cells whose score is fixed at the touch. Where
//     w_cb is +-0, a slot's score at step t is sb + w_cb * cb(t), which
//     equals sb in value (up to the sign of a zero, which the compare
//     ignores) whenever cb(t) is finite; when it is not, w_cb * cb is NaN.
//     Between a touch and the slot's next use, gap = max(next - t, 1) only
//     falls and float rounding is monotone, so |cb(t)| only shrinks: a term
//     finite at the touch stays finite. The staging evaluates each
//     request's term at its own step and keeps "not finite" in the top bit
//     of its next-use word (next use < 2^31); the slot keeps that word, and
//     warp 0 counts the cached slots whose bit is set. While the count is 0
//     an evicting step compares the stored keys alone; while it is above 0
//     the step scores every slot in full. Rows with w_cb != 0 always score
//     in full.
//   * The victim: the NaN rule (a NaN among the scores makes the plain
//     version's min NaN; its victim is then object 0 with object 0's score,
//     3.4e38 when object 0 is not cached) reads map[0]. Otherwise the
//     winner's slot is the victim when its score is below 3.4e38; in
//     GreedyDual rows its score is recomputed in full (slot_score) for that
//     one slot, so infl takes the plain version's bits, signed zeros
//     included; elsewhere the winner's image decides. A miss always
//     inserts, so when no score is below 3.4e38 the table grows past its
//     budget, up to all N objects.
//
// Every score repeats the plain version's float32 operations in its order,
// written as __fadd_rn / __fmul_rn / __fdiv_rn so that no multiply-add is
// contracted whatever the flags, and evaluated for every weight, zero or
// not (0 * inf is NaN there too); the parts of sb known before the touch
// are the same operations, done at staging. Dollars add up in step order
// in float32. Per cell the kernel also writes its work: the steps that
// scored, the slots the algorithm considers on them (used on each evicting
// step, whichever path scored it), the largest table it held, the cell's
// clock64() cycles from start to end, and the cycles from reaching each
// evicting step to its victim's decision; then, last in both kernels, the
// launch: the block that replayed the cell and %globaltimer (ns) at the
// block's start and end, from which a launch's span over its longest
// cell's own time tells how long cells waited for an SM.
//
// The byte replay (replay_bytes_kernel; plain version _replay with
// byte_sizes) is the same walk and the same evicting step, built a second
// time from the same functions (kBytes). Each object takes its whole-byte
// size (int32, staged in the size's word; its float32 value, which the
// scores read, is converted where it is needed) and a cell holds at most
// its budget B (int64) of bytes, counted exactly. A miss of an object
// larger than B is fetched through: billed, not admitted, nothing evicted.
// Any other miss scores and evicts victims one after the other, each
// setting infl in GreedyDual rows, until the object fits, then appends it;
// where no score is below 3.4e38 it is fetched through instead, so the
// cell never holds more than B bytes, nor more than N objects, which bounds
// its table as in the page kernel. A victim's slot takes the table's last slot, so the table stays dense. A
// slot has an eighth word, the whole-byte size; a cell writes three more
// counters, its victims, its fetch-throughs and the slots its evicting
// steps scored (rescanned_slots).
//
// The byte replay's cost-Belady rows (w_cb > 0) skip most of the scan. A
// cached slot's score there is sb + w_cb * cb(t), and while w_cb * cb was
// finite at the touch it never falls until the slot is touched again:
// gap = max(next - t, 1) falls, and each later operation (times size >= 0,
// over -max(cost, 1e-30) < 0, times w_cb > 0, plus sb) is monotone under
// round-to-nearest, so the slot's key (order image of the score, touch)
// never falls either. Any key computed earlier is a lower bound of the key
// now. Each group of 32 consecutive slots keeps such a bound (a key) in the
// cell's region of device memory, 0 at the start: a touch, an append, and
// the last slot moving into a victim's place lower it (atomicMin) with the
// slot's key at that step, which the staging computes whole where infl
// stays 0; a removed slot leaves it, still a bound of the rest. An evicting step
// (warp 0 alone) rescans the group of the least bound, and again while
// some group's bound lies below the best exact key found; a rescanned
// group's bound becomes its exact least key. The winner is the full scan's:
// its key is the least, and keys are distinct. The staging flags a term not
// finite at the touch (kBad) in these rows too; while a cached slot holds
// the flag, every step scans in full, as before, and that scan refreshes
// every group's bound exactly.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "argmin_rule.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;          // requests staged at once
constexpr int kStageWords = 9;       // words a staged request
constexpr int kSlotWords = 7;        // words a slot (the key takes two)
constexpr int kByteSlotWords = 8;    // and the whole-byte size
constexpr int kStageBytes = kChunk * kStageWords * 4;
constexpr int kWorkWords = 8;        // work counters a cell, the launch's 3
constexpr int kByteWorkWords = 11;   // and victims, fetch-throughs, rescans
constexpr int kGroup = 32;           // slots under one bound (the byte replay)
constexpr float kBig = 3.4e38f;
constexpr unsigned kBad = 0x80000000u;   // next-use word: w_cb * cb not finite
constexpr unsigned kNuMask = 0x7fffffffu;

// The scoring warps' rule (one, per), for rows whose score is fixed at the
// touch (w_cb == 0) and for the rest; see "The warps follow the table".
constexpr int kStaticOne = 1024, kStaticPer = 320;
constexpr int kFullOne = 128, kFullPer = 128;

// Named barriers of the scoring warps (0 is __syncthreads).
constexpr int kGoBarrier = 1;     // lane 0 published a step
constexpr int kDoneBarrier = 2;   // the helpers' winners are written

// What a chunk's replay stops at, and what warp 0 hands the helpers.
constexpr int kChunkDone = 0;   // the chunk is replayed
constexpr int kScore = 1;       // an evicting step: score your share
constexpr int kSpill = 2;       // the table must move to device memory
constexpr int kStatic = 4;      // flag on kScore: compare sb alone
constexpr int kRefresh = 8;     // flag on kScore: write the groups' bounds

struct Slots {
  unsigned long long* key;   // order_image(sb) << 32 | touch
  int* obj;
  unsigned* nu;              // next use, with kBad
  float* sb;
  float* size;
  float* negcf;
  int* bytes;                // the byte replay's whole-byte size, else null
};

// The arrays of a table of `stride` slots from base on (8-byte aligned, the
// key first, then five arrays of `stride` words, six in the byte replay).
// The base is either derived from the block's shared memory or from the
// cell's device region, never a pointer chosen between the two at run
// time, so that every access compiles to a shared or a global load and the
// table's pointers stay in registers.
template <bool kBytes>
__device__ __forceinline__ Slots slot_table(int* w, long long stride) {
  return Slots{reinterpret_cast<unsigned long long*>(w), w + 2 * stride,
               reinterpret_cast<unsigned*>(w + 3 * stride),
               reinterpret_cast<float*>(w + 4 * stride),
               reinterpret_cast<float*>(w + 5 * stride),
               reinterpret_cast<float*>(w + 6 * stride),
               kBytes ? w + 7 * stride : nullptr};
}


// cost-Belady's term at step tf: cb = (size * gap) / -max(cost, 1e-30),
// gap = max(next - t, 1), cb = -3.4e38 for an object never used again.
__device__ __forceinline__ float cost_belady(int nu, float size, float negcf,
                                             float tf, int T) {
  const float gap = fmaxf(__fsub_rn(__int2float_rn(nu), tf), 1.0f);
  return nu >= T ? -kBig : __fdiv_rn(__fmul_rn(size, gap), negcf);
}

// The plain version's raw score at step tf of an object whose score part
// fixed at the touch is sb: (static + w_bel * bel) + w_cb * cb.
__device__ __forceinline__ float score_of(float sb, unsigned nuw, float size,
                                          float negcf, float tf, int T,
                                          float w_cb) {
  return __fadd_rn(
      sb, __fmul_rn(w_cb, cost_belady(int(nuw & kNuMask), size, negcf, tf, T)));
}

// The raw score of the object in slot s at step tf.
__device__ __forceinline__ float slot_score(const Slots& sl, int s, float tf,
                                            int T, float w_cb) {
  return score_of(sl.sb[s], sl.nu[s], sl.size[s], sl.negcf[s], tf, T, w_cb);
}

// The part of an object's score fixed at its touch at step tf is
// sb = static + w_bel * bel, static = ((w0*t + w1*f) + w2*(L + c/s))
// + w3*(L + f*(c/s)), bel = -next (-3.4e38 for an object never used
// again), L = infl. Every term but the two that add L is known when the
// request is staged: the staging keeps ab = w0*t + w1*f, fc = f * (c/s)
// and wb = w_bel * bel, and the touch adds the rest in the same order.
// Rows with w_gd + w_gdsf <= 0 never change infl from 0, so there the
// staging computes sb whole (in ab) and the touch only stores it.
__device__ __forceinline__ float touch_score(const float* w, float ab,
                                             float cos, float fc, float wb,
                                             float infl) {
  const float c = __fmul_rn(w[2], __fadd_rn(infl, cos));
  const float d = __fmul_rn(w[3], __fadd_rn(infl, fc));
  return __fadd_rn(__fadd_rn(__fadd_rn(ab, c), d), wb);
}

// One lane's least key over slots first, first + stride, ... below u, on
// four chains (a chain's loads and compares overlap the others'). Where sb
// alone decides, the key is the slot's stored one: one 8-byte load and a
// 64-bit compare a slot. Else the score is computed in full and keyed.
template <bool kSbAlone>
__device__ __forceinline__ Key scan_share(const Slots sl, int u, int first,
                                          int stride, float tf, int T,
                                          float w_cb) {
  Key c[4] = {empty_key(), empty_key(), empty_key(), empty_key()};
  for (int s0 = first; s0 < u; s0 += 4 * stride) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = s0 + k * stride;
      const int sc = min(s, u - 1);   // in bounds; masked below
      Key x;
      if constexpr (kSbAlone)
        x = Key{sl.key[sc], sc};
      else
        x = Key{pack_key(order_image(slot_score(sl, sc, tf, T, w_cb)),
                         unsigned(sl.key[sc])),
                sc};
      if (s < u) c[k] = min_key(c[k], x);
    }
  }
  return min_key(min_key(c[0], c[1]), min_key(c[2], c[3]));
}

// A scoring warp's share of an evicting step, reduced over the warp.
__device__ __forceinline__ Key score_share(const Slots sl, int u, int first,
                                           int stride, bool sb_alone,
                                           float tf, int T, float w_cb) {
  return warp_argmin_distinct(
      sb_alone ? scan_share<true>(sl, u, first, stride, tf, T, w_cb)
               : scan_share<false>(sl, u, first, stride, tf, T, w_cb));
}

// The byte replay's cost-Belady bounds (see the header): the exact least
// key of group g's slots below u at step tf, in every lane of the warp.
__device__ __forceinline__ Key group_min(const Slots sl, int g, int u,
                                         float tf, int T, float w_cb) {
  const int s = g * kGroup + (threadIdx.x & 31);
  Key x = empty_key();
  if (s < u)
    x = Key{pack_key(order_image(slot_score(sl, s, tf, T, w_cb)),
                     unsigned(sl.key[s])),
            s};
  return warp_argmin_distinct(x);
}

// A scoring warp's share of a full scan in a bounded row: groups first,
// first + stride, ... (the slots the page kernel's shares give the warp),
// each group's exact least key written as its bound.
__device__ __forceinline__ Key refresh_share(const Slots sl,
                                             unsigned long long* bounds,
                                             int u, int first, int stride,
                                             float tf, int T, float w_cb) {
  Key best = empty_key();
  for (int g = first; g * kGroup < u; g += stride) {
    const Key m = group_min(sl, g, u, tf, T, w_cb);
    if ((threadIdx.x & 31) == 0) bounds[g] = m.key;
    best = min_key(best, m);
  }
  __syncwarp();
  return best;
}

// An evicting step's least key in a bounded row, by warp 0 alone: the
// group of the least bound below the best key found so far is rescanned
// (its bound becomes its exact least key) until no bound lies below it.
// Adds the slots rescanned to `rescanned`.
__device__ __forceinline__ Key bounded_min(const Slots sl,
                                           unsigned long long* bounds, int u,
                                           float tf, int T, float w_cb,
                                           long long& rescanned) {
  const int lane = threadIdx.x & 31;
  const int groups = (u + kGroup - 1) / kGroup;
  Key best = empty_key();
  __syncwarp();   // the lanes' bound updates are visible to every lane
  for (;;) {
    Key least = empty_key();   // this lane's least bound, its group
#pragma unroll 4
    for (int g = lane; g < groups; g += 32) {
      const unsigned long long b = bounds[g];
      if (b < least.key) least = Key{b, g};
    }
    least = warp_argmin_distinct(least);
    if (least.key >= best.key) return best;
    const Key m = group_min(sl, least.slot, u, tf, T, w_cb);
    if (lane == 0) bounds[least.slot] = m.key;
    __syncwarp();
    best = min_key(best, m);
    rescanned += min(kGroup, u - least.slot * kGroup);
  }
}

// Scoring warps for a table of u slots: one up to `one`, else one for
// each `per` slots, at least two and at most kWarps.
__device__ __forceinline__ int warps_for(long long u, int one, int per) {
  return u <= one ? 1
                  : (int)min((long long)kWarps, max(2ll, (u + per - 1) / per));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Arrive without waiting. Barrier completion orders the arriving threads'
// earlier shared-memory writes before the waiting threads' later reads. No
// warp arrives at a barrier twice before it completes: warp 0 arrives at
// barrier 1 for a step only after barrier 2 of the last one completed,
// which the helpers reach only after barrier 1 completed.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

struct Params {
  const int* ids;
  const int* nxt;
  const int* rank;
  const float* weights;      // (Q, 6)
  const float* costs;        // (P, N)
  const float* c_over_s;     // (P, N)
  const float* neg_cost_floor;  // (P, N)
  const float* sizes;        // (N,); null in the byte replay
  const int* budgets;        // (K,) pages; null in the byte replay
  const int* byte_sizes;     // (N,) the byte replay's sizes, else null
  const long long* byte_budgets;  // (K,) the byte replay's budgets, else null
  float* dollars;            // (C,)
  int* hits;                 // (C,)
  long long* work;           // (C, kWorkWords), (C, kByteWorkWords) in bytes
  int* map_global;           // (C, N), or null when the map is shared
  int* slots_global;         // (C, words * even(N)), or null when N fit
                             // shared (7 words a slot, 8 in the byte replay)
  int T, N, P, K;
  int map_shared;            // 1: the map in shared memory
  int slots_shared;          // slots the shared table holds
  unsigned long long* bounds;   // (C, ceil(N / 32)) the byte replay's group
                                // bounds, else null
  int sms;                   // the device's SMs (set by launch)
};

// The cell's replay state. Warp 0 runs the walk in lockstep, every lane on
// the same values (its loads are broadcasts, its stores one word each), so
// every lane holds this state and an evicting step needs no hand-off.
struct Cell {
  int used = 0, hits = 0, peak = 0;
  bool append = false;   // the request at j still has to be appended
  int bad = 0;           // cached slots whose w_cb * cb was not finite at touch
  float infl = 0.0f, dollars = 0.0f;
  long long scored_steps = 0, scored_slots = 0, evict_cycles = 0;
  long long held = 0;    // the byte replay: bytes cached
  long long victims = 0, fetch_through = 0, rescanned = 0;
};

// The staged chunk, read-only while it is walked.
struct Stage {
  const int* id;
  const unsigned* nu;   // next use, with kBad
  const float* cost;
  const float* size;
  const int* bytes;     // the byte replay: the whole-byte size, in size's place
  const float* negcf;
  const float* cos;     // cost / size
  const float* fc;      // frequency * cost / size
  const float* ab;      // w0*t + w1*f, or sb whole where infl stays 0
  const float* wb;      // w_bel * bel
  const unsigned* img;  // where infl stays 0: order_image(sb), in fc's place
  const unsigned* whole_img;   // where infl stays 0 in a bounded row: the
                               // order image of the whole score at the
                               // touch, in wb's place
};

// The score part fixed at the touch by request j, and its order image.
__device__ __forceinline__ float touch_sb(const Stage& st, int j,
                                         const float* w, bool gd_active,
                                         float infl, unsigned& img) {
  if (!gd_active) {
    img = st.img[j];
    return st.ab[j];
  }
  const float sb = touch_score(w, st.ab[j], st.cos[j], st.fc[j], st.wb[j],
                               infl);
  img = order_image(sb);
  return sb;
}

// The control words warp 0 hands the helper warps before barrier 1.
struct Control {
  int event, used, t, global;
};

// The per-cell constants of the walk.
struct Row {
  const float* w;
  bool gd_active, static_row;
  bool bounded;            // the byte replay's rows with w_cb > 0
  int budget, T, nw;
  long long byte_budget;   // the byte replay's budget
  unsigned long long* bounds;   // the byte replay's: the cell's group bounds
  unsigned big_img;
};

// A bounded row: the key at step t0 + j of the object that request j
// touches, with score part sb (staged whole where infl stays 0), which
// lowers its slot's group's bound.
__device__ __forceinline__ unsigned long long touch_key(const Row& row,
                                                       const Stage& st,
                                                       int j, int t0,
                                                       float sb) {
  return pack_key(
      row.gd_active
          ? order_image(score_of(sb, st.nu[j], __int2float_rn(st.bytes[j]),
                                 st.negcf[j], __int2float_rn(t0 + j), row.T,
                                 row.w[5]))
          : st.whole_img[j],
      t0 + j);
}

// Request j of the chunk (t = t0 + j) puts its object in slot s, which
// held a slot flagged `old_bad` (0 for a new one), and touches it.
template <bool kBytes>
__device__ __forceinline__ void place(Cell& c, const Stage& st, int* map,
                                      const Slots& t, int s, int j, int t0,
                                      unsigned old_bad, const Row& row) {
  const int i = st.id[j];
  map[i] = s;
  t.obj[s] = i;
  if constexpr (kBytes) {
    const int b = st.bytes[j];
    t.size[s] = __int2float_rn(b);
    t.bytes[s] = b;
  } else {
    t.size[s] = st.size[j];
  }
  t.negcf[s] = st.negcf[j];
  c.bad += int(st.nu[j] >> 31) - int(old_bad);
  unsigned img;
  const float sb = touch_sb(st, j, row.w, row.gd_active, c.infl, img);
  t.sb[s] = sb;
  t.nu[s] = st.nu[j];
  t.key[s] = pack_key(img, t0 + j);
  if constexpr (kBytes) {   // the byte replay only appends
    if (row.bounded) {
      const unsigned long long k = touch_key(row, st, j, t0, sb);
      if ((threadIdx.x & 31) == 0) atomicMin(row.bounds + s / kGroup, k);
    }
  }
}

// An evicting step at request j of the chunk: the minimum of (score, touch)
// over the cached objects (the requested one is not among them: a miss),
// scored by the row's warps. Returns whether the winner is evicted (its
// score below 3.4e38, or the NaN rule's object 0), with its slot in v and,
// where it counts (the NaN rule, GreedyDual rows), its score in vscore.
// The byte replay's bounded rows take the least key from their bounds
// while no cached slot holds kBad.
template <bool kBytes>
__device__ __forceinline__ bool evicting_step(Cell& c, int j, int t0,
                                              int* map, const Slots t,
                                              const Row& row, Control* ctl,
                                              Key* winners, int& v,
                                              float& vscore) {
  const int lane = threadIdx.x & 31;
  const float* w = row.w;
  const long long reached = clock64();
  ++c.scored_steps;
  c.scored_slots += c.used;
  Key win;
  float tf;
  if (kBytes && row.bounded && c.bad == 0) {
    tf = __int2float_rn(t0 + j);
    win = bounded_min(t, row.bounds, c.used, tf, row.T, w[5], c.rescanned);
  } else {
    if constexpr (kBytes) c.rescanned += c.used;
    const bool refresh = kBytes && row.bounded;
    const bool sb_alone = row.static_row && c.bad == 0;
    const int team = 32 * row.nw;
    if (row.nw > 1) {
      if (lane == 0) {
        ctl->event = sb_alone  ? kScore | kStatic
                     : refresh ? kScore | kRefresh
                               : kScore;
        ctl->used = c.used;
        ctl->t = t0 + j;
      }
      bar_arrive(kGoBarrier, team);   // the helpers wait; warp 0 need not
    }
    tf = __int2float_rn(t0 + j);
    win = refresh ? refresh_share(t, row.bounds, c.used, 0, row.nw, tf, row.T,
                                  w[5])
                  : score_share(t, c.used, lane, team, sb_alone, tf, row.T,
                                w[5]);
    if (row.nw > 1) {
      bar_sync(kDoneBarrier, team);
      win = warp_argmin_distinct(lane == 0 ? win
                                 : lane < row.nw ? winners[lane]
                                                 : empty_key());
    }
  }
  bool evict;
  vscore = 0.0f;
  if (key_image(win) == kNanImage) {   // a NaN: the plain version's victim 0
    v = map[0];
    vscore = v >= 0 ? slot_score(t, v, tf, row.T, w[5]) : kBig;
    evict = vscore < kBig;
  } else {
    v = win.slot;
    if (v >= 0 && row.gd_active) {
      vscore = slot_score(t, v, tf, row.T, w[5]);
      evict = vscore < kBig;
    } else {
      evict = key_image(win) < row.big_img;   // kEmpty when there is none
    }
  }
  c.evict_cycles += clock64() - reached;
  return evict;
}

// The byte replay drops the victim in slot v: the table's last slot takes
// its place, so the table stays dense (in a bounded row, its key at step tf
// lowers the bound of v's group). Every lane reads before any writes.
__device__ __forceinline__ void drop_slot(Cell& c, int* map, const Slots t,
                                          int v, const Row& row, float tf) {
  const int last = c.used - 1;
  const int gone = t.obj[v], moved = t.obj[last];
  const unsigned gone_nu = t.nu[v];
  const int gone_bytes = t.bytes[v];
  const unsigned long long key = t.key[last];
  const unsigned nu = t.nu[last];
  const float sb = t.sb[last], size = t.size[last], negcf = t.negcf[last];
  const int bytes = t.bytes[last];
  __syncwarp();
  map[gone] = -1;
  if (v != last) {
    map[moved] = v;
    t.key[v] = key;
    t.obj[v] = moved;
    t.nu[v] = nu;
    t.sb[v] = sb;
    t.size[v] = size;
    t.negcf[v] = negcf;
    t.bytes[v] = bytes;
    if (row.bounded) {
      const unsigned long long k = pack_key(
          order_image(score_of(sb, nu, size, negcf, tf, row.T, row.w[5])),
          unsigned(key));
      if ((threadIdx.x & 31) == 0) atomicMin(row.bounds + v / kGroup, k);
    }
  }
  c.bad -= int(gone_nu >> 31);
  c.held -= gone_bytes;
  c.used = last;
}

// Warp 0 replays the chunk from request j on, table t holding `capacity`
// slots, until the chunk's end (kChunkDone) or a full table (kSpill, with
// j on the request still to append). Runs of hits go a warp at a time: the
// 32 lanes look up the next 32 requests, and since a hit changes no map
// entry, every request before the first miss is a hit as of its own step.
// Each slot in the run takes the touch of its last request there
// (__match_any_sync); hits grow by the run's length, and dollars not at all
// (a hit adds 0.0f, and the dollar sum, begun at +0.0, is never -0.0, so
// that add never changes its bits). The first miss goes on alone, and if
// the table is full it is an evicting step, scored and decided here (in
// the byte replay: as many as it takes to fit, or a fetch-through).
// `track_bad`: some slot may hold kBad.
template <bool kBytes>
__device__ __forceinline__ int replay_chunk(Cell& c, int& j, int n, int t0,
                                            const Stage& st, int* map,
                                            const Slots t, int capacity,
                                            const Row& row, bool track_bad,
                                            Control* ctl, Key* winners) {
  const int lane = threadIdx.x & 31;
  const float* w = row.w;
  for (;;) {
    if (c.append) {   // a miss appends (past the budget, too)
      if (c.used == capacity) return kSpill;
      if constexpr (kBytes) c.held += st.bytes[j];
      place<kBytes>(c, st, map, t, c.used++, j, t0, 0u, row);
      c.peak = max(c.peak, c.used);
      c.append = false;
      ++j;
    }
    if (j >= n) return kChunkDone;
    const int r = j + lane;
    const bool valid = r < n;
    const int s_r = map[st.id[valid ? r : j]];
    const unsigned miss = __ballot_sync(0xffffffffu, valid & (s_r < 0));
    const int h = miss ? __ffs(miss) - 1 : min(32, n - j);   // leading hits
    if (h > 0) {
      const bool in_run = lane < h;
      bool last = in_run;   // the run's last request to its slot
      if (h > 1) {
        // each slot's touch word (the key's low half) takes the run's
        // latest request to it; touches only grow, so the slot's older
        // touch always loses
        unsigned* touch_word =
            reinterpret_cast<unsigned*>(t.key + (in_run ? s_r : 0));
        if (in_run) atomicMax(touch_word, unsigned(t0 + r));
        __syncwarp();
        last = in_run && *touch_word == unsigned(t0 + r);
      }
      if (track_bad)
        c.bad += __reduce_add_sync(
            0xffffffffu,
            last ? int(st.nu[r] >> 31) - int(t.nu[s_r] >> 31) : 0);
      if (last) {
        unsigned img;
        const float sb = touch_sb(st, r, w, row.gd_active, c.infl, img);
        t.sb[s_r] = sb;
        t.nu[s_r] = st.nu[r];
        t.key[s_r] = pack_key(img, t0 + r);
        if constexpr (kBytes)
          if (row.bounded)
            atomicMin(row.bounds + s_r / kGroup,
                      touch_key(row, st, r, t0, sb));
      }
      c.hits += h;
      j += h;
      if (!miss) continue;   // no miss among the next 32 (or to the end)
    }
    // request j misses
    c.dollars = __fadd_rn(c.dollars, st.cost[j]);
    int v;   // the victim's slot
    float vscore;
    if constexpr (kBytes) {
      // evict until it fits; an object larger than the budget, or one that
      // finds nothing to evict, is fetched through
      const int bytes = st.bytes[j];
      bool admit = bytes <= row.byte_budget;
      while (admit && c.held + bytes > row.byte_budget) {
        if (!evicting_step<true>(c, j, t0, map, t, row, ctl, winners, v,
                                 vscore)) {
          admit = false;
          break;
        }
        if (row.gd_active) c.infl = vscore;
        drop_slot(c, map, t, v, row, __int2float_rn(t0 + j));
        ++c.victims;
      }
      if (admit) {
        c.append = true;
      } else {
        ++c.fetch_through;
        ++j;
      }
    } else {
      if (c.used < row.budget) {
        c.append = true;
        continue;
      }
      if (!evicting_step<false>(c, j, t0, map, t, row, ctl, winners, v,
                                vscore)) {
        c.append = true;   // nothing is evicted
        continue;
      }
      if (row.gd_active) c.infl = vscore;
      map[t.obj[v]] = -1;
      place<false>(c, st, map, t, v, j, t0, t.nu[v] >> 31, row);
      ++j;
    }
  }
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// Row w's class in the launch order: 0 where w_cb != 0, 1 in GreedyDual
// rows, 2 where the score is fixed at the touch (Row's static_row and
// gd_active are the same tests).
__device__ __forceinline__ int row_class(const float* w) {
  if (!(w[5] == 0.0f)) return 0;
  return __fadd_rn(w[2], w[3]) > 0.0f ? 1 : 2;
}

// The cell block b replays: b in a grid of one wave, else the b-th in
// (class, q, p, k) order. Each row has P * K cells, so b's row is the
// (b / (P*K))-th in (class, q) order; every warp finds it alike, its lanes
// testing 32 rows at a time.
__device__ __forceinline__ int launch_cell(const Params& p) {
  if (gridDim.x <= p.sms) return blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int PK = p.P * p.K, Q = gridDim.x / PK;
  int left = blockIdx.x / PK;   // rows to pass over in (class, q) order
  for (int cls = 0; cls < 3; ++cls) {
    for (int q0 = 0; q0 < Q; q0 += 32) {
      const int q = q0 + lane;
      unsigned in =
          __ballot_sync(~0u, q < Q && row_class(p.weights + q * 6) == cls);
      if (left < __popc(in)) {
        for (; left > 0; --left) in &= in - 1;   // drop the rows passed over
        return (q0 + __ffs(in) - 1) * PK + blockIdx.x % PK;
      }
      left -= __popc(in);
    }
  }
  return blockIdx.x;   // not reached: the grid has Q * P * K blocks
}

// One cell's replay, for the page kernel (kBytes false) and the byte
// kernel.
template <bool kMapShared, bool kBytes>
__device__ __forceinline__ void replay_cell(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Key winners[kWarps];
  __shared__ Control ctl;
  const long long start = clock64();
  const long long start_ns = global_ns();

  const int cell = launch_cell(p);
  constexpr int kWords = kBytes ? kByteWorkWords : kWorkWords;
  if (threadIdx.x == 0) {   // the launch's columns, last in the row
    long long* out = p.work + (long long)kWords * cell;
    out[kWords - 3] = blockIdx.x;
    out[kWords - 2] = start_ns;
  }
  const int k = cell % p.K;
  const int pi = (cell / p.K) % p.P;
  const int q = cell / p.K / p.P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = p.T, N = p.N;

  int* st_id = reinterpret_cast<int*>(smem);
  unsigned* st_nu = reinterpret_cast<unsigned*>(st_id + kChunk);
  float* st_cost = reinterpret_cast<float*>(st_nu + kChunk);
  float* st_size = st_cost + kChunk;
  float* st_negcf = st_size + kChunk;
  float* st_cos = st_negcf + kChunk;
  float* st_fc = st_cos + kChunk;
  float* st_ab = st_fc + kChunk;
  float* st_wb = st_ab + kChunk;
  unsigned* st_img = reinterpret_cast<unsigned*>(st_fc);
  int* st_bytes = reinterpret_cast<int*>(st_size);
  unsigned* st_whole_img = reinterpret_cast<unsigned*>(st_wb);
  const Stage st{st_id, st_nu, st_cost, st_size, st_bytes, st_negcf,
                 st_cos, st_fc, st_ab, st_wb, st_img, st_whole_img};
  unsigned char* rest = smem + kStageBytes;
  int* map;
  int* shared_base;
  if constexpr (kMapShared) {
    map = reinterpret_cast<int*>(rest);
    shared_base = reinterpret_cast<int*>(rest + (((long long)N * 4 + 15) &
                                                 ~15ll));
  } else {
    map = p.map_global + (long long)cell * N;
    shared_base = reinterpret_cast<int*>(rest);
  }
  const Slots shared_table = slot_table<kBytes>(shared_base, p.slots_shared);
  // the cell's region of N slots (an even stride, for the keys' alignment)
  // in device memory, taken only once the table has moved there (so only
  // when the layout gave one)
  int* const slots_global = p.slots_global;
  const int gstride = (N + 1) & ~1;
  const long long region =
      (long long)cell * (kBytes ? kByteSlotWords : kSlotWords) * gstride;
  auto global_table = [=] {
    return slot_table<kBytes>(slots_global + region, gstride);
  };

  float w[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) w[j] = p.weights[q * 6 + j];
  Row row;
  row.w = w;
  row.gd_active = __fadd_rn(w[2], w[3]) > 0.0f;
  row.static_row = w[5] == 0.0f;
  row.bounded = kBytes && w[5] > 0.0f;
  if constexpr (kBytes) {
    row.byte_budget = p.byte_budgets[k];
    row.bounds = p.bounds + (long long)cell * ((N + kGroup - 1) / kGroup);
  } else {
    row.budget = p.budgets[k];
  }
  row.T = T;
  row.big_img = order_image(kBig);
  const int one_warp = row.static_row ? kStaticOne : kFullOne;
  const int per_warp = row.static_row ? kStaticPer : kFullPer;
  const long long prow = (long long)pi * N;
  const float* cost_row = p.costs + prow;
  const float* cos_row = p.c_over_s + prow;
  const float* negcf_row = p.neg_cost_floor + prow;

  for (int o = tid; o < N; o += kThreads) map[o] = -1;
  if constexpr (kBytes) {   // the least key: a bound of any slot
    if (row.bounded)
      for (int g = tid; g * kGroup < N; g += kThreads) row.bounds[g] = 0;
  }
  if (tid == 0) {
    ctl.used = 0;
    ctl.global = 0;
  }

  Cell c;
  bool in_global = false;   // warp 0: the table has moved to device memory

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();   // warp 0 is done with the last chunk
    const int chunk_used = ctl.used;
    int flagged = 0;
    for (int r = tid; r < n; r += kThreads) {
      const int i = p.ids[t0 + r];
      const int nu = p.nxt[t0 + r];
      const float tf = __int2float_rn(t0 + r);
      const float fi = __int2float_rn(p.rank[t0 + r]);
      float size;
      if constexpr (kBytes) {
        const int bytes = p.byte_sizes[i];
        size = __int2float_rn(bytes);
        st_bytes[r] = bytes;
      } else {
        size = p.sizes[i];
        st_size[r] = size;
      }
      const float negcf = negcf_row[i];
      const float cos = cos_row[i];
      unsigned nuw = unsigned(nu);
      float term = 0.0f;   // a bounded row's w_cb * cb at this step
      if (row.static_row) {
        nuw |= isfinite(cost_belady(nu, size, negcf, tf, T)) ? 0u : kBad;
      } else if (row.bounded) {
        term = __fmul_rn(w[5], cost_belady(nu, size, negcf, tf, T));
        nuw |= isfinite(term) ? 0u : kBad;
      }
      flagged |= nuw >> 31;
      const float ab = __fadd_rn(__fmul_rn(w[0], tf), __fmul_rn(w[1], fi));
      const float fc = __fmul_rn(fi, cos);
      const float wb =
          __fmul_rn(w[4], nu >= T ? -kBig : -__int2float_rn(nu));
      st_id[r] = i;
      st_nu[r] = nuw;
      st_cost[r] = cost_row[i];
      st_negcf[r] = negcf;
      st_cos[r] = cos;
      st_wb[r] = wb;
      if (row.gd_active) {
        st_fc[r] = fc;
        st_ab[r] = ab;
      } else {
        const float sb = touch_score(w, ab, cos, fc, wb, 0.0f);
        st_ab[r] = sb;
        st_img[r] = order_image(sb);
        if (row.bounded) st_whole_img[r] = order_image(__fadd_rn(sb, term));
      }
    }
    // a slot can hold kBad only if one did before or the chunk brings one
    const bool track_bad = __syncthreads_or(flagged) || c.bad > 0;
    // every warp counts the same scoring warps for this chunk: from the
    // table an evicting step will see, max(used, budget) of pages, or the
    // byte replay's table as the chunk starts
    row.nw = warps_for(kBytes ? chunk_used : max(chunk_used, row.budget),
                       one_warp, per_warp);
    const int team = 32 * row.nw;
    if (warp >= row.nw) continue;

    if (warp > 0) {   // a helper: score this warp's share of each step
      for (;;) {
        bar_sync(kGoBarrier, team);
        const int ev = ctl.event;
        if (ev == kChunkDone) break;
        const int u = ctl.used, first = 32 * warp + lane;
        const float tf = __int2float_rn(ctl.t);
        const bool sb_alone = ev & kStatic;
        Key win;
        if (kBytes && (ev & kRefresh))   // this warp's groups: warp + nw * i
          win = ctl.global ? refresh_share(global_table(), row.bounds, u, warp,
                                           row.nw, tf, T, w[5])
                           : refresh_share(shared_table, row.bounds, u, warp,
                                           row.nw, tf, T, w[5]);
        else
          win = ctl.global ? score_share(global_table(), u, first, team,
                                         sb_alone, tf, T, w[5])
                           : score_share(shared_table, u, first, team,
                                         sb_alone, tf, T, w[5]);
        if (lane == 0) winners[warp] = win;
        bar_arrive(kDoneBarrier, team);
      }
      continue;
    }

    int j = 0;   // the next request of the chunk
    while (kSpill == (in_global
                          ? replay_chunk<kBytes>(c, j, n, t0, st, map,
                                                 global_table(), N,
                                                 row, track_bad, &ctl,
                                                 winners)
                          : replay_chunk<kBytes>(c, j, n, t0, st, map,
                                                 shared_table, p.slots_shared,
                                                 row, track_bad, &ctl,
                                                 winners))) {
      // the table moves to this cell's region of N slots, once
      const Slots g = global_table();
      for (int s = lane; s < c.used; s += 32) {
        g.key[s] = shared_table.key[s];
        g.obj[s] = shared_table.obj[s];
        g.nu[s] = shared_table.nu[s];
        g.sb[s] = shared_table.sb[s];
        g.size[s] = shared_table.size[s];
        g.negcf[s] = shared_table.negcf[s];
        if constexpr (kBytes) g.bytes[s] = shared_table.bytes[s];
      }
      in_global = true;
      if (lane == 0) ctl.global = 1;
      __syncwarp();
    }
    if (row.nw > 1) {   // the helpers leave the chunk
      if (lane == 0) ctl.event = kChunkDone;
      bar_arrive(kGoBarrier, team);
    }
    if (lane == 0) ctl.used = c.used;   // read by every warp at the next chunk
  }

  if (tid == 0) {
    long long* out = p.work + (long long)kWords * cell;
    p.dollars[cell] = c.dollars;
    p.hits[cell] = c.hits;
    out[0] = c.scored_steps;
    out[1] = c.scored_slots;
    out[2] = c.peak;
    out[3] = clock64() - start;
    out[4] = c.evict_cycles;
    if constexpr (kBytes) {
      out[5] = c.victims;
      out[6] = c.fetch_through;
      out[7] = c.rescanned;
    }
    out[kWords - 1] = global_ns();
  }
}

template <bool kMapShared>
__global__ void __launch_bounds__(kThreads, 1)
    replay_scan_kernel(const Params p) {
  replay_cell<kMapShared, false>(p);
}

template <bool kMapShared>
__global__ void __launch_bounds__(kThreads, 1)
    replay_bytes_kernel(const Params p) {
  replay_cell<kMapShared, true>(p);
}

long long shared_bytes(int N, int map_shared, int slots_shared,
                       int slot_words) {
  return kStageBytes + (map_shared ? (((long long)N * 4 + 15) & ~15ll) : 0) +
         (long long)slot_words * 4 * slots_shared;
}

template <typename Kernel>
long long shared_limit(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return -1;
  return (long long)optin - (long long)attr.sharedSizeBytes;
}

// Checks the layout, sets the kernel's shared memory and the device's SM
// count, and launches C blocks.
int launch(void (*kernel)(const Params), Params p, long long cells,
           int slot_words, long long dynamic_bytes, long long limit,
           void* stream) {
  if (p.T < 0 || p.N < 1 || cells < 1 || cells > INT_MAX ||
      p.slots_shared < 1 || p.slots_shared > p.N ||
      (!p.map_shared && p.map_global == nullptr) ||
      (p.slots_shared < p.N && p.slots_global == nullptr) ||
      (p.byte_sizes != nullptr && p.bounds == nullptr) ||
      dynamic_bytes !=
          shared_bytes(p.N, p.map_shared, p.slots_shared, slot_words) ||
      dynamic_bytes > limit)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dynamic_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(int)cells, kThreads, (size_t)dynamic_bytes,
           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block of the kernel may take on the current
// device, or -1 on error.
extern "C" long long replay_scan_shared_limit() {
  return shared_limit(replay_scan_kernel<true>);
}

extern "C" long long replay_bytes_shared_limit() {
  return shared_limit(replay_bytes_kernel<true>);
}

// ids, nxt, rank: (T,) int32; weights (Q, 6), costs, c_over_s and
// neg_cost_floor (P, N), sizes (N,) float32; budgets (K,) int32; all on the
// device, contiguous. Writes dollars (C,) float32, hits (C,) int32 and work
// (C, 8) int64 for C = Q*P*K cells. map_global: (C, N) int32 unless
// map_shared; slots_global: (C, 7 * (N rounded up to even)) int32, 8-byte
// aligned, unless slots_shared == N.
// `dynamic_bytes` must be the layout's size as plan() computed it. One
// launch of C blocks on `stream`; returns its CUDA error, 0 on success.
extern "C" int replay_scan_launch(
    const void* ids, const void* nxt, const void* rank, const void* weights,
    const void* costs, const void* c_over_s, const void* neg_cost_floor,
    const void* sizes, const void* budgets, void* dollars, void* hits,
    void* work, void* map_global, void* slots_global, int T, int N, int Q,
    int P, int K, int map_shared, int slots_shared, long long dynamic_bytes,
    void* stream) {
  Params p{static_cast<const int*>(ids),
           static_cast<const int*>(nxt),
           static_cast<const int*>(rank),
           static_cast<const float*>(weights),
           static_cast<const float*>(costs),
           static_cast<const float*>(c_over_s),
           static_cast<const float*>(neg_cost_floor),
           static_cast<const float*>(sizes),
           static_cast<const int*>(budgets),
           nullptr,
           nullptr,
           static_cast<float*>(dollars),
           static_cast<int*>(hits),
           static_cast<long long*>(work),
           static_cast<int*>(map_global),
           static_cast<int*>(slots_global),
           T, N, P, K, map_shared, slots_shared,
           nullptr};
  return launch(map_shared ? replay_scan_kernel<true>
                           : replay_scan_kernel<false>,
                p, (long long)Q * P * K, kSlotWords, dynamic_bytes,
                replay_scan_shared_limit(), stream);
}

// The byte replay's launch: as replay_scan_launch, with byte_sizes (N,)
// int32 in place of sizes and byte_budgets (K,) int64 in place of budgets;
// work (C, 11) int64; slots_global (C, 8 * (N rounded up to even)) int32
// unless slots_shared == N; bounds (C, ceil(N / 32)) int64, 8-byte
// aligned, never read before the kernel writes it.
extern "C" int replay_bytes_launch(
    const void* ids, const void* nxt, const void* rank, const void* weights,
    const void* costs, const void* c_over_s, const void* neg_cost_floor,
    const void* byte_sizes, const void* byte_budgets, void* dollars,
    void* hits, void* work, void* map_global, void* slots_global,
    void* bounds, int T, int N, int Q, int P, int K, int map_shared,
    int slots_shared, long long dynamic_bytes, void* stream) {
  Params p{static_cast<const int*>(ids),
           static_cast<const int*>(nxt),
           static_cast<const int*>(rank),
           static_cast<const float*>(weights),
           static_cast<const float*>(costs),
           static_cast<const float*>(c_over_s),
           static_cast<const float*>(neg_cost_floor),
           nullptr,
           nullptr,
           static_cast<const int*>(byte_sizes),
           static_cast<const long long*>(byte_budgets),
           static_cast<float*>(dollars),
           static_cast<int*>(hits),
           static_cast<long long*>(work),
           static_cast<int*>(map_global),
           static_cast<int*>(slots_global),
           T, N, P, K, map_shared, slots_shared,
           static_cast<unsigned long long*>(bounds)};
  return launch(map_shared ? replay_bytes_kernel<true>
                           : replay_bytes_kernel<false>,
                p, (long long)Q * P * K, kByteSlotWords, dynamic_bytes,
                replay_bytes_shared_limit(), stream);
}
