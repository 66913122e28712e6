// Batched per-row top-2 of V = W - prices: the auction's bid reduction.
//
// Replaces the TPU kernel src/repro/kernels/auction_bid/kernel.py::_bid_kernel
// (launched by masked_row_top2_pallas). Plain version: repro_torch/kernels/
// auction_bid/ref.py::masked_row_top2_ref, which this kernel matches bit for bit.
//
// Bound on the H100: bytes. Every element of W is read once and takes two
// float operations (a subtraction and a compare), far below the ~20 flops per
// byte where the card stops being memory bound. At (4, 512, 512) W is 4 MB,
// 1.25 us at 3.35 TB/s: about what the card can have in flight at once, so
// the design issues every load of W as early as it can. Measured on an
// H100 in a CUDA graph (tools/kernel_variants.py bid; PERF.md), a launch
// takes ~2.0 us at (8, 100) (0.3 MB) and ~2.6 us at (4, 512) (4 MB): a fixed
// cost (the launch, a round trip for the prices, then one for W, the
// warp's merge) holds it near 48% of its bound there. 128 or 512 threads a
// block, issuing a row's loads before the prices are staged, and reading
// the prices through L1 were each slower at (4, 512).
//
// Design: a block of 8 warps takes 8 consecutive rows of one instance, one
// row a warp, and first stages that instance's prices in shared memory
// (read once a block, not once a row). Where m % 4 == 0 and W is 16-byte
// aligned, a lane reads four adjacent columns a load (kVec = 4): a 2 KB row
// is four 16-byte loads a lane, issued together, not sixteen dependent
// 128-byte lines a warp. Each lane keeps a running (v1, v2, j1); the warp
// then merges them with shuffles by the exact rule
//   b wins  iff  b.v1 > a.v1, or b.v1 == a.v1 and b.j1 < a.j1;
//   winner's v2 = max(winner.v2, loser.v1).
// The rule uses only subtraction, max and compare, so the result equals the
// plain version's (first-index argmax, second best over the other columns)
// exactly, however the columns are dealt to the lanes. For m == 1 the
// second best is NEG, as in the reference.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

#include "auction_common.cuh"

namespace {

using auction::kNeg;
using auction::top2_step;
using auction::warp_top2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kVec>
__global__ void __launch_bounds__(kThreads)
auction_bid_kernel(const float* __restrict__ W, const float* __restrict__ prices,
                   float* __restrict__ v1_out, float* __restrict__ v2_out,
                   int* __restrict__ j1_out, int n, int m, int blocks_per_instance) {
  extern __shared__ __align__(16) float ps[];  // [m] the instance's prices
  const int b = blockIdx.x / blocks_per_instance;
  const int lane = threadIdx.x & 31;
  const int row = (blockIdx.x - b * blocks_per_instance) * kWarps + (threadIdx.x >> 5);
  const float* pb = prices + static_cast<long long>(b) * m;
  if constexpr (kVec == 4) {
    for (int q = threadIdx.x; q < m / 4; q += kThreads)
      reinterpret_cast<float4*>(ps)[q] = reinterpret_cast<const float4*>(pb)[q];
  } else {
    for (int j = threadIdx.x; j < m; j += kThreads) ps[j] = pb[j];
  }
  __syncthreads();
  if (row >= n) return;  // uniform per warp

  const long long out = static_cast<long long>(b) * n + row;
  const float* wr = W + out * m;
  float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
  int j1 = INT_MAX;
  if constexpr (kVec == 4) {
#pragma unroll 4
    for (int q = lane; q < m / 4; q += 32) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wr) + q);
      const float4 c = reinterpret_cast<const float4*>(ps)[q];
      top2_step(w.x - c.x, 4 * q, v1, v2, j1);
      top2_step(w.y - c.y, 4 * q + 1, v1, v2, j1);
      top2_step(w.z - c.z, 4 * q + 2, v1, v2, j1);
      top2_step(w.w - c.w, 4 * q + 3, v1, v2, j1);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < m; j += 32) top2_step(__ldg(wr + j) - ps[j], j, v1, v2, j1);
  }
  warp_top2(v1, v2, j1);
  if (lane == 0) {
    v1_out[out] = v1;
    v2_out[out] = fmaxf(v2, kNeg);  // the masked winner counts as NEG
    j1_out[out] = j1;
  }
}

template <int kVec>
int launch(const void* W, const void* prices, void* v1, void* v2, void* j1, int B, int n, int m,
           cudaStream_t stream) {
  const int per = (n + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(m) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(auction_bid_kernel<kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_bid_kernel<kVec><<<static_cast<unsigned>(static_cast<long long>(B) * per), kThreads, smem, stream>>>(
      static_cast<const float*>(W), static_cast<const float*>(prices), static_cast<float*>(v1),
      static_cast<float*>(v2), static_cast<int*>(j1), n, m, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int auction_bid_launch(const void* W, const void* prices, void* v1,
                                  void* v2, void* j1, int B, int n, int m,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = m % 4 == 0 && ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(prices)) & 15) == 0;
  return vec ? launch<4>(W, prices, v1, v2, j1, B, n, m, s) : launch<1>(W, prices, v1, v2, j1, B, n, m, s);
}
