// Batched per-row top-2 of V = W - prices: the auction's bid reduction.
//
// Replaces the TPU kernel src/repro/kernels/auction_bid/kernel.py::_bid_kernel
// (launched by masked_row_top2_pallas). Plain version: repro_torch/kernels/
// auction_bid/ref.py::masked_row_top2_ref, which this kernel matches bit for bit.
//
// Bound on the H100: bytes. Every element of W is read once and takes two
// float operations (a subtraction and a compare), far below the ~20 flops per
// byte where the card stops being memory bound; at the main path's shapes
// (B = 8, n <= 128) W is at most 512 KB, so one launch is a few microseconds of
// memory traffic and the launch itself is the larger cost.
//
// Design: one warp per (instance, row). Lanes stride over the columns, so each
// load of W is one coalesced 128-byte line. Each lane keeps a running
// (v1, v2, j1); the warp then merges them with shuffles by the exact rule
//   b wins  iff  b.v1 > a.v1, or b.v1 == a.v1 and b.j1 < a.j1;
//   winner's v2 = max(winner.v2, loser.v1).
// The rule uses only subtraction, max and compare, so the result equals the
// plain version's (first-index argmax, second best over the other columns)
// exactly. For m == 1 the second best is NEG, as in the reference.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

#include "auction_common.cuh"

namespace {

using auction::kNeg;
using auction::merge;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
auction_bid_kernel(const float* __restrict__ W, const float* __restrict__ prices,
                   float* __restrict__ v1_out, float* __restrict__ v2_out,
                   int* __restrict__ j1_out, int B, int n, int m) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * n) return;  // uniform per warp
  const long long b = warp / n;
  const float* row = W + warp * m;
  const float* p = prices + b * m;

  float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
  int j1 = INT_MAX;
  for (int j = lane; j < m; j += 32) {
    const float v = row[j] - p[j];
    if (v > v1) {  // strict: the earlier column keeps a tie
      v2 = v1;
      v1 = v;
      j1 = j;
    } else {
      v2 = fmaxf(v2, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j1, off);
    merge(v1, v2, j1, o1, o2, oj);
  }
  if (lane == 0) {
    v1_out[warp] = v1;
    v2_out[warp] = fmaxf(v2, kNeg);  // the masked winner counts as NEG
    j1_out[warp] = j1;
  }
}

}  // namespace

extern "C" int auction_bid_launch(const void* W, const void* prices, void* v1,
                                  void* v2, void* j1, int B, int n, int m,
                                  void* stream) {
  const long long threads = static_cast<long long>(B) * n * 32;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  auction_bid_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(prices),
      static_cast<float*>(v1), static_cast<float*>(v2), static_cast<int*>(j1),
      B, n, m);
  return static_cast<int>(cudaGetLastError());
}
