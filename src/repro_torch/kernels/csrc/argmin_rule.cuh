// argmin_rule.cuh: the victim rule of every eviction argmin in the port.
//
// A candidate is (s, touch, index); the victim is the lexicographic minimum,
// with -0.0 and 0.0 tying as float == has them, and a NaN anywhere among the
// candidates making the plain version's min NaN (its answer is then index 0,
// whatever the rest holds: each caller handles that case from the flag).
// evict_argmin.cu and replay_scan.cu both follow this rule, so it lives here
// alone: evict_argmin.cu reduces with `less` and `warp_min`, replay_scan.cu
// with `order_image` and `warp_argmin_distinct` (below).
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

// The replay's form of the rule. Among the objects a replay's cache holds,
// the touch is the step at which each was last requested, so no two share
// one: (score, touch) is already a total order and the index compare above
// is never reached. That lets a warp reduce with redux.sync, which takes
// 32-bit unsigned words, in place of five rounds of shuffles of a triple.
// evict_argmin.cu keeps `warp_min`: its callers' touches may tie.

constexpr unsigned kEmpty = 0xffffffffu;   // no candidate: above every image
constexpr unsigned kNanImage = 0u;         // below every image

// A 32-bit image of a float that keeps its order. v + 0.0f folds -0.0 onto
// 0.0 (the two tie, as float == has them) and leaves every other value;
// then negatives are inverted and positives get the top bit, so -inf maps
// to 0x007fffff and +inf to 0xff800000. A NaN has no place in the order:
// it maps to kNanImage, so that the least image of a set is kNanImage
// exactly when the set holds a NaN.
__device__ __forceinline__ unsigned order_image(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  const unsigned img = b ^ (unsigned(int(b) >> 31) | 0x80000000u);
  return v != v ? kNanImage : img;
}

// A candidate: (image << 32 | touch), and its slot (-1 for none).
struct Key {
  unsigned long long key;
  int slot;
};

__device__ __forceinline__ Key empty_key() { return Key{~0ull, -1}; }

__device__ __forceinline__ unsigned long long pack_key(unsigned img,
                                                      unsigned touch) {
  return (static_cast<unsigned long long>(img) << 32) | touch;
}

__device__ __forceinline__ Key min_key(const Key& a, const Key& b) {
  return b.key < a.key ? b : a;
}

__device__ __forceinline__ unsigned key_image(const Key& k) {
  return unsigned(k.key >> 32);
}

// The warp's minimum key in every lane, for distinct touches: the least
// image, then (when more than one lane holds it) the least touch among
// those lanes, then the slot of the one lane that holds both.
__device__ __forceinline__ Key warp_argmin_distinct(const Key& k) {
  const unsigned img = key_image(k), touch = unsigned(k.key);
  const unsigned m = __reduce_min_sync(0xffffffffu, img);
  unsigned who = __ballot_sync(0xffffffffu, img == m);
  if (__popc(who) > 1) {
    const unsigned t =
        __reduce_min_sync(0xffffffffu, img == m ? touch : kEmpty);
    who = __ballot_sync(0xffffffffu, (img == m) & (touch == t));
  }
  const int src = __ffs(who) - 1;
  return Key{__shfl_sync(0xffffffffu, k.key, src),
             __shfl_sync(0xffffffffu, k.slot, src)};
}

}  // namespace
