// Every epsilon-phase and bidding round of the forward or forward-reverse
// auction, for each lane, in one launch: one block per lane. A second
// instance of the same kernel runs a whole DECOMPOSE round loop (Alg. 1) in
// one launch.
//
// auction_rounds_kernel<false> replaces the round-by-round use of the TPU
// kernel src/repro/kernels/auction_bid/kernel.py::_bid_kernel (launched by
// masked_row_top2_pallas), which the reference calls once per bidding round
// inside the lax.while_loop nests of repro.core.jaxopt.matching's
// match_auction and match_auction_fr. Plain version: repro_torch/kernels/
// auction_bid/ref.py::auction_rounds_ref, which this kernel matches bit for
// bit in row2col, col2row, prices, rounds and bids, ties included.
//
// auction_rounds_kernel<true> replaces the reference's decompose_jax round
// loop (repro.core.jaxopt.decompose_jax), a lax.while_loop of matcher calls
// around _bid_kernel, which the port ran as a host loop of auction_rounds
// launches with ~35 small PyTorch ops and three host round trips a round.
// Each block keeps its lane's residual D_rem, its support S_rem and the
// auction's state in shared memory and runs every round of the lane there:
// the critical rows and columns, the M-bonus weights, the epsilon phases, the
// greedy completion, alpha and the residual update. Plain version:
// ref.py::decompose_rounds_ref, matched bit for bit in perms, alphas, k,
// converged, rounds and prices. One block a lane, as for the matcher: a
// lane's rounds depend on one another, a round's work is a few thousand
// entries, and a lane never waits for another lane's matcher call.
//
// The epsilon schedule of a matcher call on W is (wmax/2) * T[p], with
// wmax = max(|W|, 1e-12) and T = ratio ** arange(P) a float32 table fixed by
// P alone: for n >= 5 the final epsilon is wmax * 2^-22 (the 1e-6 / n term is
// smaller), an exact power-of-two scaling of wmax, so the ratio of the
// schedule is the same for every wmax. The host forms T once with the CPU's
// pow; the device needs one float32 multiply a phase.
//
// Semantics of a matcher call (as the reference): prices start at prices0 (a
// warm start, the online controller's carry; 0 when the pointer is null) and
// persist across phases; the row profits of the forward-reverse auction
// start at 0 and persist too. Each phase restarts
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
// DECOMPOSE adds three barriers and one warp's pass over the rows a matcher
// call, and reads D once.
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
// shared scalars in the block; nothing goes back to the host. Every float
// operation of DECOMPOSE's glue is the plain version's, in its order, with
// explicit rounding (no fused multiply-add); the row maxima are summed in
// float64 and rounded once, as the plain version sums them.

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

// A lane's auction state in shared memory.
struct Lane {
  unsigned long long* key;  // [n] best bid on each target
  float* Ws;                // [n][n | 1]
  float* prices;
  float* profits;
  float* v2s;  // each bidder's floored second best
  int* r2c;
  int* c2r;
};

size_t lane_bytes(int n) {
  const int s = n | 1;
  return static_cast<size_t>(n) * 8 + (static_cast<size_t>(n) * s + 5 * static_cast<size_t>(n)) * 4;
}

// DECOMPOSE adds D_rem (n*n float), the row maxima, the degrees, the
// permutation and the free columns (n each), and S_rem (n*n bytes).
size_t decompose_bytes(int n) {
  return lane_bytes(n) + (static_cast<size_t>(n) * n + 5 * static_cast<size_t>(n)) * 4 +
         static_cast<size_t>(n) * n;
}

__device__ __forceinline__ Lane carve(unsigned char* smem, int n) {
  Lane L;
  L.key = reinterpret_cast<unsigned long long*>(smem);
  L.Ws = reinterpret_cast<float*>(L.key + n);
  L.prices = L.Ws + n * (n | 1);
  L.profits = L.prices + n;
  L.v2s = L.profits + n;
  L.r2c = reinterpret_cast<int*>(L.v2s + n);
  L.c2r = L.r2c + n;
  return L;
}

// Every phase and bidding round of one lane's auction on the weights and
// prices in shared memory; phase p bids with eps = scale * eps[p]. Returns
// the lane's bidding rounds (the same on every thread) and adds this
// thread's bids to my_bids. Ends on a block barrier.
__device__ __forceinline__ int auction_phases(const Lane& L, int n, const float* eps, float scale, int P,
                                              int max_iters, int reverse, unsigned long long& my_bids) {
  __shared__ int unassigned;  // rows without a column
  const int s = n | 1;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  int total_rounds = 0;

  for (int p = 0; p < P; ++p) {
    const float e = __fmul_rn(scale, eps[p]);
    for (int j = tid; j < n; j += nth) {
      L.r2c[j] = -1;
      L.c2r[j] = -1;
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
      int* bidder_map = fwd ? L.r2c : L.c2r;    // bidder -> target
      int* target_map = fwd ? L.c2r : L.r2c;    // target -> bidder
      float* cost = fwd ? L.prices : L.profits;  // what a target costs
      float* gain = fwd ? L.profits : L.prices;  // the bidders' side values
      const int sa = fwd ? s : 1;                // W[bidder a, target t] = Ws[a * sa + t * st]
      const int st = fwd ? 1 : s;

      // 1. Bids, one warp per unassigned bidder.
      for (int a = warp; a < n; a += nwarps) {
        if (bidder_map[a] >= 0) continue;  // same value across the warp
        const float* line = L.Ws + a * sa;
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
          L.v2s[a] = v2m;
          atomicMax(&L.key[j1], pack(bid, a));
          ++my_bids;
        }
      }
      __syncthreads();
      // 2-3. Each target takes its best bid. A winner was unassigned and a
      //      kicked owner did not bid, so each bidder is written once.
      for (int t = tid; t < n; t += nth) {
        const unsigned long long k = L.key[t];
        if (k == 0ull) continue;
        L.key[t] = 0ull;
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
        if (reverse) gain[w] = L.v2s[w] - e;
      }
      __syncthreads();
      if (reverse && unassigned < before) fwd = !fwd;  // the round grew the assignment
      ++it;
    }
    total_rounds += it;
    __syncthreads();  // all threads have read `unassigned` before it is reset
  }
  return total_rounds;
}

template <bool kDecompose>
struct Args;

// One matcher call a lane: W (B, n, n), eps (B, P), prices0 (B, n) or null.
template <>
struct Args<false> {
  const float* W;
  const float* eps;
  const float* prices0;
  int* r2c;
  int* c2r;
  float* prices;
  int* rounds;
  unsigned long long* bids;
  int n, P, max_iters, reverse;
};

// One DECOMPOSE a lane: D (B, n, n), the table T (P), prices0 (B, n) or null.
// Outputs perms (B, n, n) int64, alphas (B, n), k, converged, rounds (B,) and,
// with carry, the final prices (B, n).
template <>
struct Args<true> {
  const float* D;
  const float* T;
  const float* prices0;
  long long* perms;
  float* alphas;
  long long* k;
  bool* converged;
  long long* rounds;
  float* prices;
  int n, P, max_iters, reverse, carry;
};

__device__ void match_lane(const Args<false>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bid_total;
  const int n = a.n;
  const int s = n | 1;
  const Lane L = carve(smem, n);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const long long b = blockIdx.x;
  const float* Wb = a.W + b * n * n;

  for (int t = tid; t < n * n; t += nth) {
    const int i = t / n;
    L.Ws[i * s + (t - i * n)] = Wb[t];
  }
  for (int j = tid; j < n; j += nth) {
    L.prices[j] = a.prices0 ? a.prices0[b * n + j] : 0.f;
    L.profits[j] = 0.f;
    L.key[j] = 0ull;
  }
  if (tid == 0) bid_total = 0;
  unsigned long long my_bids = 0;
  const int total_rounds = auction_phases(L, n, a.eps + b * a.P, 1.f, a.P, a.max_iters, a.reverse, my_bids);

  if (my_bids) atomicAdd(&bid_total, my_bids);
  for (int j = tid; j < n; j += nth) {
    a.r2c[b * n + j] = L.r2c[j];
    a.c2r[b * n + j] = L.c2r[j];
    a.prices[b * n + j] = L.prices[j];
  }
  __syncthreads();
  if (tid == 0) {
    a.rounds[b] = total_rounds;
    a.bids[b] = bid_total;
  }
}

__device__ void decompose_lane(const Args<true>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int kdeg_s;             // the round's largest degree of S_rem
  __shared__ unsigned wmax_bits;     // the round's max |W| (W >= +0, so its bits order it)
  __shared__ int converged_s;
  const int n = a.n;
  const int nn = n * n;
  const int s = n | 1;
  const Lane L = carve(smem, n);
  float* Dres = reinterpret_cast<float*>(L.c2r + n);  // [n][n] D_rem
  float* rowmax = Dres + nn;
  int* row_deg = reinterpret_cast<int*>(rowmax + n);
  int* col_deg = row_deg + n;
  int* perm = col_deg + n;
  int* freec = perm + n;
  unsigned char* S = reinterpret_cast<unsigned char*>(freec + n);  // [n][n] S_rem
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const long long b = blockIdx.x;
  const float* Db = a.D + b * nn;
  const unsigned below = (1u << lane) - 1u;
  // Dominance constant's relative margin, 1 + n 2^-19: exact in float32.
  const float margin = 1.f + static_cast<float>(n) * 0x1p-19f;

  for (int t = tid; t < nn; t += nth) {
    const float d = Db[t];
    Dres[t] = d;
    S[t] = d > 0.f;
  }
  for (int j = tid; j < n; j += nth) {
    L.prices[j] = a.carry && a.prices0 ? a.prices0[b * n + j] : 0.f;
    L.key[j] = 0ull;
  }
  if (tid == 0) {
    kdeg_s = 0;
    wmax_bits = 0u;
    converged_s = 1;
  }
  __syncthreads();
  for (int j = tid; j < n; j += nth) {
    int r = 0, c = 0;
    for (int i = 0; i < n; ++i) {
      r += S[j * n + i];
      c += S[i * n + j];
    }
    row_deg[j] = r;
    col_deg[j] = c;
  }
  __syncthreads();

  int k = 0;
  long long total_rounds = 0;
  unsigned long long my_bids = 0;  // not reported
  while (k < n) {
    // 1. The largest degree, and the row maxima of max(D_rem, 0).
    for (int j = tid; j < n; j += nth) atomicMax(&kdeg_s, max(row_deg[j], col_deg[j]));
    for (int i = warp; i < n; i += nwarps) {
      float m = 0.f;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, Dres[i * n + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) rowmax[i] = m;
    }
    __syncthreads();
    const int kdeg = kdeg_s;
    if (kdeg == 0) break;  // no residual support left
    // 2. M = (sum of row maxima + 1) * margin. Every warp sums in float64 in
    //    the same order (a butterfly: both partners add the same two values),
    //    so all threads hold the same M without a barrier.
    double acc = 0.0;
    for (int i = lane; i < n; i += 32) acc += static_cast<double>(rowmax[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float M = __fmul_rn(__fadd_rn(__double2float_rn(acc), 1.f), margin);
    // 3. W = max(D_rem, 0) + (S_rem ? M * (crit_r + crit_c) : 0), and max |W|.
    float wm = 0.f;
    for (int t = tid; t < nn; t += nth) {
      const int i = t / n;
      const int j = t - i * n;
      const float d = Dres[t];
      float w = d > 0.f ? d : 0.f;
      if (S[t]) {
        const float c = static_cast<float>((row_deg[i] == kdeg) + (col_deg[j] == kdeg));
        w = __fadd_rn(w, __fmul_rn(M, c));
      }
      L.Ws[i * s + j] = w;
      wm = fmaxf(wm, w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
    if (lane == 0) atomicMax(&wmax_bits, __float_as_uint(wm));
    for (int j = tid; j < n; j += nth) {
      L.profits[j] = 0.f;
      if (!a.carry) L.prices[j] = 0.f;  // each matcher call starts from zero prices
    }
    __syncthreads();
    // 4. The matcher call: eps_p = (wmax / 2) * T[p].
    const float half = __fmul_rn(fmaxf(__uint_as_float(wmax_bits), 1e-12f), 0.5f);
    total_rounds += auction_phases(L, n, a.T, half, a.P, a.max_iters, a.reverse, my_bids);
    // 5. One warp: greedy completion (the open rows in index order take the
    //    free columns in index order), alpha = min of D_rem over the newly
    //    covered entries, the residual update and the round's outputs.
    if (warp == 0) {
      int nfree = 0;
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const bool free_col = j < n && L.c2r[j] < 0;
        const unsigned m = __ballot_sync(0xffffffffu, free_col);
        if (free_col) freec[nfree + __popc(m & below)] = j;
        nfree += __popc(m);
      }
      __syncwarp();
      int nopen = 0;
      bool newly_any = false;
      float amin = CUDART_INF_F;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const bool open = i < n && L.r2c[i] < 0;
        const unsigned m = __ballot_sync(0xffffffffu, open);
        if (i < n) {
          const int p = open ? freec[nopen + __popc(m & below)] : L.r2c[i];
          perm[i] = p;
          if (S[i * n + p]) {
            newly_any = true;
            amin = fminf(amin, Dres[i * n + p]);
          }
        }
        nopen += __popc(m);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) amin = fminf(amin, __shfl_xor_sync(0xffffffffu, amin, off));
      const float alpha = __any_sync(0xffffffffu, newly_any) ? amin : 0.f;
      long long* out = a.perms + (b * n + k) * n;
      for (int i = lane; i < n; i += 32) {
        const int p = perm[i];
        const float v = __fsub_rn(Dres[i * n + p], alpha);
        Dres[i * n + p] = v > 0.f ? v : 0.f;
        if (S[i * n + p]) {  // each row and each column once: no two lanes meet
          S[i * n + p] = 0;
          --row_deg[i];
          --col_deg[p];
        }
        out[i] = p;
      }
      if (lane == 0) {
        a.alphas[b * n + k] = alpha;
        if (nopen) converged_s = 0;
        kdeg_s = 0;  // every thread read both after the barrier before the matcher
        wmax_bits = 0u;
      }
    }
    __syncthreads();
    ++k;
  }

  // Rounds k..n-1: identity permutations with alpha 0.
  for (int t = tid; t < (n - k) * n; t += nth) {
    const int r = k + t / n;
    a.perms[(b * n + r) * n + (t % n)] = t % n;
  }
  for (int r = k + tid; r < n; r += nth) a.alphas[b * n + r] = 0.f;
  if (a.carry) {
    for (int j = tid; j < n; j += nth) a.prices[b * n + j] = L.prices[j];
  }
  if (tid == 0) {
    a.k[b] = k;
    a.converged[b] = converged_s != 0;
    a.rounds[b] = total_rounds;
  }
}

template <bool kDecompose>
__global__ void __launch_bounds__(kThreads) auction_rounds_kernel(const Args<kDecompose> a) {
  if constexpr (kDecompose) {
    decompose_lane(a);
  } else {
    match_lane(a);
  }
}

template <bool kDecompose>
int launch(const Args<kDecompose>& a, int B, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_rounds_kernel<kDecompose>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_rounds_kernel<kDecompose><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int auction_rounds_launch(const void* W, const void* eps, const void* prices0,
                                     void* r2c, void* c2r,
                                     void* prices, void* rounds, void* bids, int B, int n, int P,
                                     int max_iters, int reverse, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || P < 1 || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<false> a{static_cast<const float*>(W), static_cast<const float*>(eps),
                      static_cast<const float*>(prices0), static_cast<int*>(r2c),
                      static_cast<int*>(c2r), static_cast<float*>(prices), static_cast<int*>(rounds),
                      static_cast<unsigned long long*>(bids), n, P, max_iters, reverse};
  return launch(a, B, lane_bytes(n), stream);
}

extern "C" int decompose_rounds_launch(const void* D, const void* T, const void* prices0, void* perms,
                                       void* alphas, void* k, void* converged, void* rounds,
                                       void* prices, int B, int n, int P, int max_iters, int reverse,
                                       int carry, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || P < 1 || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<true> a{static_cast<const float*>(D), static_cast<const float*>(T),
                     static_cast<const float*>(prices0), static_cast<long long*>(perms),
                     static_cast<float*>(alphas), static_cast<long long*>(k),
                     static_cast<bool*>(converged), static_cast<long long*>(rounds),
                     static_cast<float*>(prices), n, P, max_iters, reverse, carry};
  return launch(a, B, decompose_bytes(n), stream);
}
