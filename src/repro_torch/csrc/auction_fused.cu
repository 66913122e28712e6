// The whole forward epsilon-scaling auction in one launch, one block per instance.
//
// Replaces the TPU kernel src/repro/kernels/auction_fused/kernel.py::
// _fused_auction_kernel (launched by fused_auction_pallas). Plain version:
// repro_torch/kernels/auction_fused/ref.py::fused_auction_ref, which this
// kernel matches bit for bit in r2c, c2r, prices, rounds and bids.
//
// Semantics (as the reference): phases run in order and prices persist across
// them. Each phase restarts the assignment and repeats rounds until every row is
// assigned or max_iters rounds have run. One round:
//   1. every unassigned row i finds the top two of W[i, :] - prices (first
//      column on ties) and bids inc = v1 - v2 + eps on its best column j1;
//   2. each column takes the largest inc; among the rows that bid that much,
//      the lowest row wins;
//   3. the column's price rises by its winning inc, its previous owner is
//      kicked out and the winner takes it.
//
// Bound on the H100: the bytes of W, read again every round. One instance
// lives in one block, and at n = 1024 its W is 4 MB, which does not fit in an
// SM's 227 KB of shared memory: every round streams the rows of the rows still
// bidding from L2 (the 50 MB L2 holds every instance of a batch) through one
// SM. A round is at most 4 MB through one SM, so a 1024-wide instance is bound
// by one SM's share of L2 bandwidth, not by the card's. A later design can
// spread one instance over a thread block cluster.
//
// Design: the TPU kernel's sequential phase grid becomes a loop inside the
// block, and so does the round loop. prices, r2c, c2r, the bids (inc, j1) and
// the per-column scratch live in shared memory (28 bytes a column, 28 KB at
// n = 1024). Step 1 gives each warp one bidding row at a time (lanes stride over
// the columns, coalesced) and skips assigned rows, which the reference computes
// and then discards. Step 2's maximum is a shared-memory atomicMax on an
// order-preserving integer code of the float, which is exact, and the lowest
// bidding row is an atomicMin. Nothing is padded: loops stop at n.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

#include "auction_common.cuh"

namespace {

using auction::kNeg;
using auction::kNegHalf;
using auction::merge;
using auction::order_code;
using auction::order_decode;

constexpr int kThreads = 1024;
constexpr int kSmemPerColumn = 7 * 4;

__global__ void __launch_bounds__(kThreads)
auction_fused_kernel(const float* __restrict__ W, const float* __restrict__ prices0,
                     const float* __restrict__ eps, int* __restrict__ r2c_out,
                     int* __restrict__ c2r_out, float* __restrict__ prices_out,
                     int* __restrict__ rounds_out,
                     unsigned long long* __restrict__ bids_out, int n, int P,
                     int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* prices = reinterpret_cast<float*>(smem);
  float* inc = prices + n;
  int* bid_col = reinterpret_cast<int*>(inc + n);
  int* r2c = bid_col + n;
  int* c2r = r2c + n;
  unsigned* best = reinterpret_cast<unsigned*>(c2r + n);
  int* win = reinterpret_cast<int*>(best + n);
  __shared__ int unassigned;
  __shared__ unsigned long long bid_total;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const long long b = blockIdx.x;
  const float* Wb = W + b * n * n;
  const unsigned neg_code = order_code(kNeg);

  for (int j = tid; j < n; j += nth) {
    prices[j] = prices0[b * n + j];
    best[j] = neg_code;
    win[j] = n;
  }
  if (tid == 0) bid_total = 0;
  int total_rounds = 0;
  unsigned long long my_bids = 0;

  for (int p = 0; p < P; ++p) {
    const float e = eps[b * P + p];
    for (int j = tid; j < n; j += nth) {
      r2c[j] = -1;
      c2r[j] = -1;
    }
    if (tid == 0) unassigned = n;
    __syncthreads();
    int it = 0;
    while (it < max_iters && unassigned > 0) {
      // 1. Bids of the unassigned rows, one warp per row.
      for (int i = warp; i < n; i += nwarps) {
        if (r2c[i] >= 0) continue;  // same value across the warp
        const float* row = Wb + static_cast<long long>(i) * n;
        float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
        int j1 = INT_MAX;
        for (int j = lane; j < n; j += 32) {
          const float v = row[j] - prices[j];
          if (v > v1) {
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
          const float d = v1 - fmaxf(v2, kNeg) + e;
          inc[i] = d;
          bid_col[i] = j1;
          atomicMax(&best[j1], order_code(d));
          ++my_bids;
        }
      }
      __syncthreads();
      // 2. Lowest row among those that bid the column's best increment.
      for (int i = tid; i < n; i += nth) {
        if (r2c[i] < 0) {
          const float d = inc[i];
          const int j = bid_col[i];
          if (d > kNegHalf && d >= order_decode(best[j])) atomicMin(&win[j], i);
        }
      }
      __syncthreads();
      // 3. Prices and maps. A winner was unassigned and a kicked owner did not
      //    bid, so each row is written by at most one column.
      for (int j = tid; j < n; j += nth) {
        const int w = win[j];
        if (w < n) {
          const int old = c2r[j];
          if (old >= 0) {
            r2c[old] = -1;
          } else {
            atomicSub(&unassigned, 1);
          }
          c2r[j] = w;
          r2c[w] = j;
          prices[j] = prices[j] + order_decode(best[j]);
          win[j] = n;
        }
        best[j] = neg_code;
      }
      __syncthreads();
      ++it;
    }
    total_rounds += it;
    __syncthreads();  // all threads have read `unassigned` before it is reset
  }

  if (my_bids) atomicAdd(&bid_total, my_bids);
  for (int j = tid; j < n; j += nth) {
    r2c_out[b * n + j] = r2c[j];
    c2r_out[b * n + j] = c2r[j];
    prices_out[b * n + j] = prices[j];
  }
  __syncthreads();
  if (tid == 0) {
    rounds_out[b] = total_rounds;
    bids_out[b] = bid_total;
  }
}

}  // namespace

extern "C" int auction_fused_launch(const void* W, const void* prices0,
                                    const void* eps, void* r2c, void* c2r,
                                    void* prices, void* rounds, void* bids,
                                    int B, int n, int P, int max_iters,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(n) * kSmemPerColumn;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_fused_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(prices0),
      static_cast<const float*>(eps), static_cast<int*>(r2c),
      static_cast<int*>(c2r), static_cast<float*>(prices),
      static_cast<int*>(rounds), static_cast<unsigned long long*>(bids), n, P,
      max_iters);
  return static_cast<int>(cudaGetLastError());
}
