// argmin_rule.cuh: the victim rule of every eviction argmin in the port.
//
// A candidate is (s, touch, index); the victim is the lexicographic minimum,
// with -0.0 and 0.0 tying as float == has them, and a NaN anywhere among the
// candidates making the plain version's min NaN (its answer is then index 0,
// whatever the rest holds: each caller handles that case from the flag).
// evict_argmin.cu and replay_scan.cu both reduce with these functions, so
// the rule lives here alone.
#pragma once

#include <climits>

namespace {

struct Best {
  float s;
  int t;
  int i;
};

// Sentinel: +inf with the largest touch and index loses to every real entry
// that is not NaN, including one whose score is +inf.
__device__ __forceinline__ Best sentinel() {
  return Best{__int_as_float(0x7f800000), INT_MAX, INT_MAX};
}

// a < b lexicographically in (s, touch, index); -0.0 and 0.0 tie. Bitwise
// & and | in place of && and ||, so that the compare compiles to predicate
// logic and selects rather than branches.
__device__ __forceinline__ bool less(const Best& a, const Best& b) {
  return (a.s < b.s) |
         ((a.s == b.s) & ((a.t < b.t) | ((a.t == b.t) & (a.i < b.i))));
}

__device__ __forceinline__ void take(Best& b, int& nan_seen, float s, int t,
                                     int i) {
  nan_seen |= (s != s);
  const Best c{s, t, i};
  if (less(c, b)) b = c;
}

__device__ __forceinline__ Best shfl_xor(const Best& b, int off) {
  return Best{__shfl_xor_sync(0xffffffffu, b.s, off),
              __shfl_xor_sync(0xffffffffu, b.t, off),
              __shfl_xor_sync(0xffffffffu, b.i, off)};
}

// The warp's minimum in every lane.
__device__ __forceinline__ Best warp_min(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o = shfl_xor(b, off);
    if (less(o, b)) b = o;
  }
  return b;
}

}  // namespace
