// A design variant of src/repro_torch/csrc/auction_rounds.cu, not part of the
// package: tools/kernel_variants.py's `auction` target builds it in place of
// that file ("one launch above 128") to time a matcher call above n = 128 in
// one launch against the round loop the matchers run there and against the
// auction_fused dispatch that bench/matching's speed gate compares with. It
// does not ship: with it, auction_fused no longer beats auction by the
// gate's 1.5x at n = 256 (PERF.md, section 6). Its launcher takes W^T after
// W (null where no reverse round reads it above 128).
//
// Every epsilon-phase and bidding round of the forward or forward-reverse
// auction, for each lane, in one launch: one block per lane, at every n up
// to kMaxN.
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
// memory or flops: each round is about 2n flops a bidding row, and the
// rounds form one dependent chain. The round-by-round design launched one
// kernel a round inside ~30 small PyTorch ops and one host read (0.57 ms a
// round at n = 256); here a round is two block barriers.
//
// One definition of a round, two places for W (the template's kSmemW):
//
// n <= kMaxSmemN (128): W sits in shared memory for the whole call with an
// odd row stride (n | 1), so both a row walk (forward) and a column walk
// (reverse) are free of bank conflicts. 512 threads.
//
// kMaxSmemN < n <= kMaxN: W stays in device memory and is read through L2
// (n^2 floats a lane; 1 MB at n = 512, so a few lanes fit the 50 MB L2 after
// the first round). A reverse round walks rows of W^T, which the caller
// passes in (made once a call). A bidder's row is read with 16-byte loads
// where n % 4 == 0 (kVec = 4), else 4-byte ones. 1024 threads. Only the
// per-column state lives in shared memory: prices, profits, row2col,
// col2row, each bidder's v2 and each target's best bid, 28 bytes a column
// (229 KB at n = kMaxN). The winner's weight W[a, j1] rides along the
// warp's merge, so a bid reads its row once.
//
// Both: in step 1 each warp takes unassigned bidders by index, its lanes
// stride over the targets and merge a running top-2 with shuffles
// (auction_common.cuh). Step 2 is one shared
// 64-bit atomicMax on (order code of the bid, ~bidder): the largest bid,
// then the lowest bidder, both exact. Step 3 runs one thread per target.
// The phase, the round, the side flag and the count of unassigned rows are
// loops and shared scalars in the block; nothing goes back to the host.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

#include "auction_common.cuh"

namespace {

using auction::kNeg;
using auction::kNegHalf;
using auction::merge;
using auction::pack;
using auction::packed_bid;
using auction::packed_who;
using auction::top2_step;
using auction::warp_top2;

constexpr int kSmemThreads = 512;
constexpr int kGlobalThreads = 1024;
constexpr int kMaxSmemN = 128;
constexpr int kMaxN = 8192;  // 28 bytes a column of shared state: 229,376 bytes

size_t smem_bytes(int n, bool smem_w) {
  const size_t s = smem_w ? (static_cast<size_t>(n) | 1) : 0;
  return static_cast<size_t>(n) * 8 + (static_cast<size_t>(n) * s + 5 * static_cast<size_t>(n)) * 4;
}

// A row of W in device memory: the warp's top two of line[t] - cost[t] and
// w1 = line[j1] on every lane (16-byte loads where kVec = 4). w1 rides
// along the merge, so no lane reads the row again.
__device__ __forceinline__ void step(float w, float c, int t, float& v1, float& v2, int& j1, float& w1) {
  const float v = w - c;
  if (v > v1) {
    v2 = v1;
    v1 = v;
    j1 = t;
    w1 = w;
  } else {
    v2 = fmaxf(v2, v);
  }
}

template <int kVec>
__device__ __forceinline__ void row_top2(const float* __restrict__ line, const float* cost, int n, int lane,
                                         float& v1, float& v2, int& j1, float& w1) {
  v1 = v2 = w1 = -CUDART_INF_F;
  j1 = INT_MAX;
  if constexpr (kVec == 4) {
    const float4* l4 = reinterpret_cast<const float4*>(line);
    const float4* c4 = reinterpret_cast<const float4*>(cost);
#pragma unroll 4
    for (int q = lane; q < (n >> 2); q += 32) {
      const float4 w = __ldg(l4 + q);
      const float4 c = c4[q];
      step(w.x, c.x, 4 * q, v1, v2, j1, w1);
      step(w.y, c.y, 4 * q + 1, v1, v2, j1, w1);
      step(w.z, c.z, 4 * q + 2, v1, v2, j1, w1);
      step(w.w, c.w, 4 * q + 3, v1, v2, j1, w1);
    }
  } else {
#pragma unroll 4
    for (int t = lane; t < n; t += 32) step(__ldg(line + t), cost[t], t, v1, v2, j1, w1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j1, off);
    const float ow = __shfl_xor_sync(0xffffffffu, w1, off);
    const bool other = o1 > v1 || (o1 == v1 && oj < j1);  // merge's rule
    merge(v1, v2, j1, o1, o2, oj);
    if (other) w1 = ow;
  }
}

template <bool kSmemW, int kVec>
__global__ void __launch_bounds__(kSmemW ? kSmemThreads : kGlobalThreads)
auction_rounds_kernel(const float* __restrict__ W, const float* __restrict__ Wt, const float* __restrict__ eps,
                      const float* __restrict__ prices0, int* __restrict__ r2c_out, int* __restrict__ c2r_out,
                      float* __restrict__ prices_out, int* __restrict__ rounds_out,
                      unsigned long long* __restrict__ bids_out, int n, int P, int max_iters,
                      int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = kSmemW ? (n | 1) : 0;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);  // [n] best bid on each target
  float* Ws = reinterpret_cast<float*>(key + n);  // [n][s] (shared W only)
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
  const float* Wtb = Wt ? Wt + b * n * n : nullptr;

  if constexpr (kSmemW) {
    for (int t = tid; t < n * n; t += nth) {
      const int i = t / n;
      Ws[i * s + (t - i * n)] = Wb[t];
    }
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

      // 1. Bids, one warp per unassigned bidder: the top two of the
      //    bidder's line of W (or W^T) less the targets' costs.
      const int sa = kSmemW ? (fwd ? s : 1) : n;  // W[bidder a, target t] = line_a[t * st]
      const int st = kSmemW && !fwd ? s : 1;
      const float* lines = kSmemW ? Ws : (fwd ? Wb : Wtb);
      for (int a = warp; a < n; a += nwarps) {
        if (bidder_map[a] >= 0) continue;  // same value across the warp
        const float* line = lines + static_cast<long long>(a) * sa;
        float v1, v2, w1;
        int j1;
        if constexpr (kSmemW) {
          v1 = v2 = -CUDART_INF_F;
          j1 = INT_MAX;
          for (int t = lane; t < n; t += 32) top2_step(line[t * st] - cost[t], t, v1, v2, j1);
          warp_top2(v1, v2, j1);
          w1 = line[j1 * st];
        } else {
          row_top2<kVec>(line, cost, n, lane, v1, v2, j1, w1);
        }
        if (lane == 0) {
          const float v2m = fmaxf(v2, kNeg);  // the masked winner counts as NEG
          v2s[a] = v2m;
          atomicMax(&key[j1], pack((w1 - v2m) + e, a));
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

template <bool kSmemW, int kVec>
int launch(const void* W, const void* Wt, const void* eps, const void* prices0, void* r2c, void* c2r,
           void* prices, void* rounds, void* bids, int B, int n, int P, int max_iters, int reverse,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(n, kSmemW);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(auction_rounds_kernel<kSmemW, kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_rounds_kernel<kSmemW, kVec><<<B, kSmemW ? kSmemThreads : kGlobalThreads, smem, stream>>>(
      static_cast<const float*>(W), static_cast<const float*>(Wt), static_cast<const float*>(eps),
      static_cast<const float*>(prices0), static_cast<int*>(r2c), static_cast<int*>(c2r),
      static_cast<float*>(prices), static_cast<int*>(rounds), static_cast<unsigned long long*>(bids), n, P,
      max_iters, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Wt is W transposed per lane, (B, n, n); it is read only by reverse rounds
// above kMaxSmemN and may be null otherwise.
extern "C" int auction_rounds_launch(const void* W, const void* Wt, const void* eps, const void* prices0,
                                     void* r2c, void* c2r, void* prices, void* rounds, void* bids, int B,
                                     int n, int P, int max_iters, int reverse, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || P < 1 || max_iters < 0 || (reverse && n > kMaxSmemN && !Wt))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kMaxSmemN)
    return launch<true, 1>(W, Wt, eps, prices0, r2c, c2r, prices, rounds, bids, B, n, P, max_iters, reverse, s);
  const bool aligned = ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(Wt)) & 15) == 0;
  if (n % 4 == 0 && aligned)
    return launch<false, 4>(W, Wt, eps, prices0, r2c, c2r, prices, rounds, bids, B, n, P, max_iters, reverse, s);
  return launch<false, 1>(W, Wt, eps, prices0, r2c, c2r, prices, rounds, bids, B, n, P, max_iters, reverse, s);
}
