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

// Monotone map float -> unsigned: a < b  iff  code(a) < code(b).
__device__ __forceinline__ unsigned order_code(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_decode(unsigned c) {
  return __uint_as_float((c & 0x80000000u) ? (c & 0x7fffffffu) : ~c);
}

}  // namespace auction
