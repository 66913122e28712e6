// Exact building blocks shared by the auction kernels (auction_bid.cu,
// auction_fused.cu, auction_rounds.cu). Each uses only compares, max and
// bit moves, so a kernel built from them equals its plain version bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace auction {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = kNeg / 2;

// Merge of two running (best, second best, argmax) triples by the exact rule
//   b wins  iff  b.v1 > a.v1, or b.v1 == a.v1 and b.j1 < a.j1;
//   winner's v2 = max(winner.v2, loser.v1):
// first-index argmax, and the second best over the other columns.
__device__ __forceinline__ void merge(float& v1, float& v2, int& j1,
                                      float bv1, float bv2, int bj1) {
  if (bv1 > v1 || (bv1 == v1 && bj1 < j1)) {
    v2 = fmaxf(bv2, v1);
    v1 = bv1;
    j1 = bj1;
  } else {
    v2 = fmaxf(v2, bv1);
  }
}

// One more value v at index t into a lane's running top two. A lane sees its
// indices in increasing order, so the strict compare keeps the first index
// of a tie, and a tied value becomes the second best.
__device__ __forceinline__ void top2_step(float v, int t, float& v1, float& v2, int& j1) {
  if (v > v1) {
    v2 = v1;
    v1 = v;
    j1 = t;
  } else {
    v2 = fmaxf(v2, v);
  }
}

// The warp's top two of the lanes' (v1, v2, j1) by `merge`, on every lane.
__device__ __forceinline__ void warp_top2(float& v1, float& v2, int& j1) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j1, off);
    merge(v1, v2, j1, o1, o2, oj);
  }
}

// Monotone map float -> unsigned: a < b  iff  code(a) < code(b).
__device__ __forceinline__ unsigned order_code(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_decode(unsigned c) {
  return __uint_as_float((c & 0x80000000u) ? (c & 0x7fffffffu) : ~c);
}

// A bid as one 64-bit word: the larger word is the larger bid, then the
// lower bidder, so one atomicMax keeps a target's winning bid and its lowest
// bidder exactly. 0 is "no bid" (no real bid packs to 0).
__device__ __forceinline__ unsigned long long pack(float bid, int who) {
  return (static_cast<unsigned long long>(order_code(bid)) << 32) |
         (0xffffffffu - static_cast<unsigned>(who));
}

__device__ __forceinline__ float packed_bid(unsigned long long k) {
  return order_decode(static_cast<unsigned>(k >> 32));
}

__device__ __forceinline__ int packed_who(unsigned long long k) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(k & 0xffffffffull));
}

}  // namespace auction
