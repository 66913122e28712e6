// Every epsilon-phase and bidding round of the forward or forward-reverse
// auction, for each lane, in one launch: one block per lane.
//
// Replaces the round-by-round use of the TPU kernel
// src/repro/kernels/auction_bid/kernel.py::_bid_kernel (launched by
// masked_row_top2_pallas), which the reference calls once per bidding round
// inside the lax.while_loop nests of repro.core.jaxopt.matching's
// match_auction and match_auction_fr. Plain version: repro_torch/kernels/
// auction_bid/ref.py::auction_rounds_ref, which this kernel matches bit for
// bit in row2col, col2row, prices, rounds and bids, ties included.
//
// Semantics (as the reference): prices start at prices0 (a warm start, the
// online controller's carry; 0 when the pointer is null) and persist across
// phases; the row profits of the forward-reverse auction start at 0 and
// persist too. Each phase restarts
// the assignment on the row side and repeats rounds until every row is
// assigned or max_iters rounds have run. One forward round:
//   1. every unassigned row i finds the top two of W[i, :] - prices (first
//      column on ties; the second best floored at NEG) and bids
//      bid = (W[i, j1] - v2) + eps on its best column j1;
//   2. each column takes the largest bid; among the rows that bid that much,
//      the lowest row wins; a bid at or below NEG/2 is no bid;
//   3. the column's price becomes its winning bid, its previous owner is
//      kicked out and the winner takes it; with reverse rounds on, the
//      winner's profit becomes v2 - eps.
// A reverse round is the same with rows and columns swapped (columns bid on
// W^T - profits, rows take bids into their profits, prices[winner] = v2 -
// eps). With reverse rounds on, a lane flips sides whenever a round grows
// its assignment.
//
// Bound on the H100: one SM's issue rate and its barriers, not the card's
// memory or flops. W is read from device memory once (at most 64 KB a lane)
// and then lives in shared memory; each round is about 2n flops a bidding
// row. The round-by-round design launched one kernel a round inside ~45
// small PyTorch ops and one host read; here a round is two block barriers.
//
// Design: W sits in shared memory for the whole call with an odd row stride
// (n | 1), so both a row walk (forward) and a column walk (reverse) are free
// of bank conflicts. prices, profits, row2col, col2row, each bidder's v2 and
// each target's best bid live there too. In step 1 each warp takes bidding
// rows (or columns), lanes stride over the targets and merge a running
// top-2 with shuffles (auction_common.cuh). Step 2 is one shared 64-bit
// atomicMax on (order code of the bid, ~bidder): the largest bid, then the
// lowest bidder, both exact. Step 3 runs one thread per target. The phase,
// the round, the side flag and the count of unassigned rows are loops and
// shared scalars in the block; nothing goes back to the host.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

#include "auction_common.cuh"

namespace {

using auction::kNeg;
using auction::kNegHalf;
using auction::merge;
using auction::pack;
using auction::packed_bid;
using auction::packed_who;

constexpr int kThreads = 512;
constexpr int kMaxN = 128;

size_t smem_bytes(int n) {
  const int s = n | 1;
  return static_cast<size_t>(n) * 8 + (static_cast<size_t>(n) * s + 5 * static_cast<size_t>(n)) * 4;
}

__global__ void __launch_bounds__(kThreads)
auction_rounds_kernel(const float* __restrict__ W, const float* __restrict__ eps,
                      const float* __restrict__ prices0, int* __restrict__ r2c_out, int* __restrict__ c2r_out,
                      float* __restrict__ prices_out, int* __restrict__ rounds_out,
                      unsigned long long* __restrict__ bids_out, int n, int P, int max_iters,
                      int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = n | 1;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);  // [n] best bid on each target
  float* Ws = reinterpret_cast<float*>(key + n);  // [n][s]
  float* prices = Ws + n * s;
  float* profits = prices + n;
  float* v2s = profits + n;  // each bidder's floored second best
  int* r2c = reinterpret_cast<int*>(v2s + n);
  int* c2r = r2c + n;
  __shared__ int unassigned;  // rows without a column
  __shared__ unsigned long long bid_total;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const long long b = blockIdx.x;
  const float* Wb = W + b * n * n;

  for (int t = tid; t < n * n; t += nth) {
    const int i = t / n;
    Ws[i * s + (t - i * n)] = Wb[t];
  }
  for (int j = tid; j < n; j += nth) {
    prices[j] = prices0 ? prices0[b * n + j] : 0.f;
    profits[j] = 0.f;
    key[j] = 0ull;
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
    bool fwd = true;
    int it = 0;
    // `unassigned` changes only between the two barriers of a round, so
    // every thread reads the same value here and takes the same branch.
    while (it < max_iters && unassigned > 0) {
      const int before = unassigned;
      // Forward: bidders are rows, targets columns; reverse: the other way.
      int* bidder_map = fwd ? r2c : c2r;    // bidder -> target
      int* target_map = fwd ? c2r : r2c;    // target -> bidder
      float* cost = fwd ? prices : profits;  // what a target costs
      float* gain = fwd ? profits : prices;  // the bidders' side values
      const int sa = fwd ? s : 1;            // W[bidder a, target t] = Ws[a * sa + t * st]
      const int st = fwd ? 1 : s;

      // 1. Bids, one warp per unassigned bidder.
      for (int a = warp; a < n; a += nwarps) {
        if (bidder_map[a] >= 0) continue;  // same value across the warp
        const float* line = Ws + a * sa;
        float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
        int j1 = INT_MAX;
        for (int t = lane; t < n; t += 32) {
          const float v = line[t * st] - cost[t];
          if (v > v1) {  // strict: the earlier target keeps a tie
            v2 = v1;
            v1 = v;
            j1 = t;
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
          const float v2m = fmaxf(v2, kNeg);  // the masked winner counts as NEG
          const float bid = (line[j1 * st] - v2m) + e;
          v2s[a] = v2m;
          atomicMax(&key[j1], pack(bid, a));
          ++my_bids;
        }
      }
      __syncthreads();
      // 2-3. Each target takes its best bid. A winner was unassigned and a
      //      kicked owner did not bid, so each bidder is written once.
      for (int t = tid; t < n; t += nth) {
        const unsigned long long k = key[t];
        if (k == 0ull) continue;
        key[t] = 0ull;
        const float best = packed_bid(k);
        if (!(best > kNegHalf)) continue;
        const int w = packed_who(k);
        const int old = target_map[t];
        if (old >= 0) {
          bidder_map[old] = -1;
        } else {
          atomicSub(&unassigned, 1);
        }
        target_map[t] = w;
        bidder_map[w] = t;
        cost[t] = best;
        if (reverse) gain[w] = v2s[w] - e;
      }
      __syncthreads();
      if (reverse && unassigned < before) fwd = !fwd;  // the round grew the assignment
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

extern "C" int auction_rounds_launch(const void* W, const void* eps, const void* prices0,
                                     void* r2c, void* c2r,
                                     void* prices, void* rounds, void* bids, int B, int n, int P,
                                     int max_iters, int reverse, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || P < 1 || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_rounds_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(eps),
      static_cast<const float*>(prices0), static_cast<int*>(r2c),
      static_cast<int*>(c2r), static_cast<float*>(prices), static_cast<int*>(rounds),
      static_cast<unsigned long long*>(bids), n, P, max_iters, reverse);
  return static_cast<int>(cudaGetLastError());
}
