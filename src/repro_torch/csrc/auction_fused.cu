// The whole forward epsilon-scaling auction in one launch: one thread block
// cluster per instance where the instance's W fits in the cluster's shared
// memory, or one block per instance (the wrapper picks, kernels/
// auction_fused/ops.py::pick_kernel). A third kernel, auction_polish_kernel,
// is the fused matcher's tail: greedy completion and the 2-swap polish.
//
// Replaces the TPU kernel src/repro/kernels/auction_fused/kernel.py::
// _fused_auction_kernel (launched by fused_auction_pallas). Plain version:
// repro_torch/kernels/auction_fused/ref.py::fused_auction_ref, which both
// kernels match bit for bit in r2c, c2r, prices, rounds and bids.
//
// Semantics (as the reference): phases run in order and prices persist across
// them. Each phase restarts the assignment and repeats rounds until every row is
// assigned or max_iters rounds have run. One round:
//   1. every unassigned row i finds the top two of W[i, :] - prices (first
//      column on ties) and bids inc = v1 - v2 + eps on its best column j1;
//   2. each column takes the largest inc; among the rows that bid that much,
//      the lowest row wins; an inc at or below NEG/2 is no bid;
//   3. the column's price rises by its winning inc, its previous owner is
//      kicked out and the winner takes it.
//
// Bound on the H100: the chain of rounds. A call runs thousands of rounds one
// after another (~2,300-3,600 a lane at n = 512, P = 16), each a few
// dependent steps with barriers between them, and does ~2n flops a bidding
// row (10-15 bidders a round on average at n = 256-1024 on bench/matching's
// weights): the floor is rounds x a round's latency, far above the bytes or
// flops bound. On an NVIDIA H100 80GB HBM3
// (tools/kernel_variants.py fused) a round of one lane at n = 512 takes
// ~1.55 us on 16 CTAs, ~1.65 on one block, ~1.73 on 8 CTAs; a bid, most of
// a round, is ~1,300-1,800 cycles of one warp's dependent loads, top twos
// and reductions (tools/fused_round_profile.py).
//
// Cluster kernel (n up to cluster_max_n): C CTAs (8, or 16 where the card
// allows a non-portable cluster) on neighbouring SMs share one instance. CTA
// r owns rows [r R, (r + 1) R), R = ceil(n / C): it reads its rows of W from
// device memory once and keeps them in shared memory (128 KB at n = 512,
// C = 8). Every CTA keeps a replica of the instance's state (prices, r2c,
// c2r) and of its unassigned count. A round:
//   1. each warp bids for the CTA's unassigned rows from shared memory; the
//      bid (inc, column) goes into row i's slot of every CTA's inbox over
//      distributed shared memory (lane q stores to CTA q);
//   2. one cluster barrier;
//   3. every CTA scans its inbox, takes each column's best bid with a local
//      64-bit atomicMax on the packed word (auction_common.cuh::pack: the
//      largest inc, then the lowest row), and resolves every column that got
//      a bid in its own replica. The replicas run the same float operations
//      on the same bids, so they stay equal, bit for bit.
// The inbox has two buffers, used in alternate rounds: a CTA may post round
// k + 1's bids while another still reads round k's, but not round k + 2's
// before everyone has passed round k + 1's barrier.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: cooperative groups'
// cluster.sync() costs ~1,380 cycles at 512 threads, the barrier here (block
// barrier, one thread's cluster-scope fence, then a relaxed cluster arrive)
// ~940. A design that resolved each column in its owner CTA (two cluster
// barriers a round, the owner gathering the bids over distributed shared
// memory) took 2.86 us a round; one that posted bids with a 64-bit atomicMax
// into another CTA's shared memory lost bids, so every 64-bit atomic here is
// local.
//
// One-block kernel (any n): one block of 1024 threads per instance, W read
// from L2, prices and maps in shared memory, the same packed word in a shared
// atomicMax, two block barriers a round. The unassigned rows are kept in a
// list (two buffers, used in alternate rounds: a bidder lists itself for the
// next round, a kicked owner is listed by its column's resolve), and warp w
// takes entries w, w + 32, ...: a round's ~10 bids land on ~10 warps, where
// rows owned by warp (rows tested one by one) put two on one warp in most
// rounds. A lane issues its 16-byte loads of the row, four at a time, before
// it uses them, and keeps four running top twos. 28 bytes a column.
//
// Both kernels take a warp's top two with redux.sync reductions on the order
// codes (auction_common.cuh) rather than five rounds of shuffles: the best,
// then its first column and the best of the other columns side by side.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

#include "auction_common.cuh"

namespace cg = cooperative_groups;

namespace {

using auction::kNeg;
using auction::kNegHalf;
using auction::merge;
using auction::order_code;
using auction::order_decode;
using auction::pack;
using auction::packed_bid;
using auction::packed_who;
using auction::top2_step;

constexpr int kBlockThreads = 1024;   // the one-block kernel
constexpr int kClusterThreads = 512;  // one CTA of the cluster kernel
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most one block may use
constexpr size_t kHead = 16;           // bid total (8 bytes) and unassigned count
constexpr size_t kBlockHead = 32;      // the same and the one-block kernel's two list counts

// A warp's bid for one row: each lane keeps the top two of row[c] -
// prices[c] over its columns; then the warp's best value, its first column,
// and the best value of every other column, by redux.sync on order codes.
// The top two with first-column ties do not depend on how the columns are
// dealt to the lanes. Returns inc and sets j1 on every lane.
__device__ __forceinline__ float warp_inc(float v1, float v2, int j, float e, int& j1) {
  const unsigned code = order_code(v1);
  const unsigned best = __reduce_max_sync(0xffffffffu, code);
  const bool top = code == best;
  // The next three need only `best`, so they run side by side. The second
  // best is the best of the other columns: `best` again where two lanes
  // share it, else the best of the top lane's second and the others' best.
  j1 = static_cast<int>(__reduce_min_sync(0xffffffffu, top ? static_cast<unsigned>(j) : UINT_MAX));
  const unsigned rest = __reduce_max_sync(0xffffffffu, order_code(top ? v2 : v1));
  const bool tied = __popc(__ballot_sync(0xffffffffu, top)) > 1;
  return order_decode(best) - fmaxf(order_decode(tied ? best : rest), kNeg) + e;
}

// The lanes' top twos: 16-byte loads where kVec = 4 (rows and prices 16-byte
// aligned), else 4-byte ones, the row from device memory through the
// read-only path (kGlobal) or from shared memory. A lane loads a chunk of its
// columns' values and prices (kChunk 16-byte loads, or 2 kChunk 4-byte ones)
// before it uses any of them, so a bid waits about one load latency a chunk
// (n <= 512 is one chunk); a slot past the row's end loads the chunk's first
// column and counts as -inf, which changes no top two, so no load or step is
// behind a branch.
// Each lane keeps four running top twos (column c in the (c % 4)-th), each
// over increasing columns, so their dependent chains run side by side;
// `merge` joins them exactly.
constexpr int kChunk = 4;

template <int kVec, bool kGlobal>
__device__ __forceinline__ float warp_bid(const float* __restrict__ row, const float* prices, int n, int lane,
                                          float e, int& j1) {
  float v1[4], v2[4];
  int j[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    v1[a] = v2[a] = -CUDART_INF_F;
    j[a] = INT_MAX;
  }
  if constexpr (kVec == 4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(prices);
    const int m = n >> 2;  // 16-byte loads a row
    for (int base = lane; base < m; base += 32 * kChunk) {
      float4 w[kChunk], p[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int q = base + 32 * u < m ? base + 32 * u : base;
        w[u] = kGlobal ? __ldg(r4 + q) : r4[q];
        p[u] = p4[q];
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int q = base + 32 * u;
        const bool in = q < m;
        top2_step(in ? w[u].x - p[u].x : -CUDART_INF_F, 4 * q, v1[0], v2[0], j[0]);
        top2_step(in ? w[u].y - p[u].y : -CUDART_INF_F, 4 * q + 1, v1[1], v2[1], j[1]);
        top2_step(in ? w[u].z - p[u].z : -CUDART_INF_F, 4 * q + 2, v1[2], v2[2], j[2]);
        top2_step(in ? w[u].w - p[u].w : -CUDART_INF_F, 4 * q + 3, v1[3], v2[3], j[3]);
      }
    }
  } else {
    constexpr int kLoads = 2 * kChunk;  // 4-byte loads a lane keeps in flight
    for (int base = lane; base < n; base += 32 * kLoads) {
      float w[kLoads], p[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = base + 32 * u < n ? base + 32 * u : base;
        w[u] = kGlobal ? __ldg(row + c) : row[c];
        p[u] = prices[c];
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = base + 32 * u;
        top2_step(c < n ? w[u] - p[u] : -CUDART_INF_F, c, v1[u & 3], v2[u & 3], j[u & 3]);
      }
    }
  }
  merge(v1[0], v2[0], j[0], v1[1], v2[1], j[1]);
  merge(v1[2], v2[2], j[2], v1[3], v2[3], j[3]);
  merge(v1[0], v2[0], j[0], v1[2], v2[2], j[2]);
  return warp_inc(v1[0], v2[0], j[0], e, j1);
}

size_t block_smem_bytes(int n) { return kBlockHead + static_cast<size_t>(n) * 28; }

size_t cluster_smem_bytes(int n, int C) {
  const size_t R = (static_cast<size_t>(n) + C - 1) / C;
  return kHead + 36 * static_cast<size_t>(n) + 4 * R * n;
}

// Barrier of the whole cluster. The block barrier orders every thread's
// writes (remote ones too) before thread 0's cluster-scope fence, which
// releases them; each thread's arrive can then be relaxed, and the wait
// acquires.
__device__ __forceinline__ void cluster_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int kVec>
__global__ void __launch_bounds__(kBlockThreads)
auction_fused_kernel(const float* __restrict__ W, const float* __restrict__ prices0,
                     const float* __restrict__ eps, int* __restrict__ r2c_out,
                     int* __restrict__ c2r_out, float* __restrict__ prices_out,
                     int* __restrict__ rounds_out,
                     unsigned long long* __restrict__ bids_out, int n, int P,
                     int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bid_total = reinterpret_cast<unsigned long long*>(smem);
  int* unassigned = reinterpret_cast<int*>(smem + 8);
  int* count = unassigned + 1;  // [2] entries of each bidder list
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + kBlockHead);  // [n]
  float* prices = reinterpret_cast<float*>(key + n);
  int* r2c = reinterpret_cast<int*>(prices + n);
  int* c2r = r2c + n;
  int* lists = c2r + n;  // [2][n] bidder lists, used in alternate rounds

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const long long b = blockIdx.x;
  const float* Wb = W + b * n * n;

  for (int j = tid; j < n; j += nth) {
    prices[j] = prices0[b * n + j];
    key[j] = 0ull;
  }
  if (tid == 0) *bid_total = 0;
  int total_rounds = 0;
  unsigned long long my_bids = 0;

  for (int p = 0; p < P; ++p) {
    const float e = eps[b * P + p];
    for (int j = tid; j < n; j += nth) {
      r2c[j] = -1;
      c2r[j] = -1;
      lists[j] = j;
    }
    if (tid == 0) {
      *unassigned = n;
      count[0] = n;
      count[1] = 0;
    }
    __syncthreads();
    int it = 0;
    // `unassigned` changes only between the two barriers of a round.
    while (it < max_iters && *unassigned > 0) {
      const int cur = it & 1, nxt = cur ^ 1;
      const int* list = lists + cur * n;
      int* next = lists + nxt * n;
      // 1. Bids: warp w takes entries w, w + 32, ... of this round's list.
      //    The list holds every unassigned row once (and rows that won a
      //    column since they were listed, which are skipped), so the bids
      //    spread evenly over the warps. A bidder lists itself for the next
      //    round; if it wins a column now, it is skipped there.
      const int m = count[cur];
      for (int t = warp; t < m; t += nwarps) {
        const int i = list[t];
        if (r2c[i] >= 0) continue;  // same value across the warp
        int at = 0;  // this bidder's entry in the next list (lane 0), stored after the bid
        if (lane == 0) at = atomicAdd(&count[nxt], 1);
        int j1;
        const float d = warp_bid<kVec, true>(Wb + static_cast<long long>(i) * n, prices, n, lane, e, j1);
        if (lane == 0) {
          atomicMax(&key[j1], pack(d, i));
          next[at] = i;
          ++my_bids;
        }
      }
      __syncthreads();
      // 2-3. Each column takes its best bid. A kicked owner is listed for
      //      the next round. A winner was unassigned and a kicked owner did
      //      not bid, so no row is listed twice.
      if (tid == 0) count[cur] = 0;  // this list is the one after next
      for (int j = tid; j < n; j += nth) {
        const unsigned long long k = key[j];
        if (k == 0ull) continue;
        key[j] = 0ull;
        const float best = packed_bid(k);
        if (!(best > kNegHalf)) continue;
        const int w = packed_who(k);
        const int old = c2r[j];
        if (old >= 0) {
          r2c[old] = -1;
          next[atomicAdd(&count[nxt], 1)] = old;
        } else {
          atomicSub(unassigned, 1);
        }
        c2r[j] = w;
        r2c[w] = j;
        prices[j] = prices[j] + best;
      }
      __syncthreads();
      ++it;
    }
    total_rounds += it;
    __syncthreads();  // all threads have read `unassigned` before it is reset
  }

  if (my_bids) atomicAdd(bid_total, my_bids);
  for (int j = tid; j < n; j += nth) {
    r2c_out[b * n + j] = r2c[j];
    c2r_out[b * n + j] = c2r[j];
    prices_out[b * n + j] = prices[j];
  }
  __syncthreads();
  if (tid == 0) {
    rounds_out[b] = total_rounds;
    bids_out[b] = *bid_total;
  }
}

__global__ void __launch_bounds__(kClusterThreads)
auction_fused_cluster_kernel(const float* __restrict__ W, const float* __restrict__ prices0,
                             const float* __restrict__ eps, int* __restrict__ r2c_out,
                             int* __restrict__ c2r_out, float* __restrict__ prices_out,
                             int* __restrict__ rounds_out,
                             unsigned long long* __restrict__ bids_out, int n, int P,
                             int max_iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / C;
  const int R = (n + C - 1) / C;
  const int lo = rank * R;                 // first row of this CTA
  const int cnt = max(0, min(R, n - lo));  // rows it owns

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bid_total = reinterpret_cast<unsigned long long*>(smem);  // this CTA's bids
  volatile int* unassigned = reinterpret_cast<int*>(smem + 8);  // rows without a column
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + kHead);  // [n] best bid a column
  uint2* inbox = reinterpret_cast<uint2*>(key + n);  // [2][n] (inc bits, column + 1) a bidding row
  float* prices = reinterpret_cast<float*>(inbox + 2 * n);  // [n]
  int* r2c = reinterpret_cast<int*>(prices + n);            // [n]
  int* c2r = r2c + n;                                       // [n]
  float* Ws = reinterpret_cast<float*>(c2r + n);            // [R][n] own rows of W

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;

  // 16-byte loads of the rows and prices where both are 16-byte aligned.
  const bool vec4 =
      (n & 3) == 0 && ((reinterpret_cast<uintptr_t>(Ws) | reinterpret_cast<uintptr_t>(prices)) & 15) == 0;
  const float* Wrows = W + (b * n + lo) * n;
  for (int t = tid; t < cnt * n; t += nth) Ws[t] = Wrows[t];
  for (int j = tid; j < n; j += nth) {
    prices[j] = prices0[b * n + j];
    key[j] = 0ull;
    inbox[j] = inbox[n + j] = make_uint2(0u, 0u);
  }
  if (tid == 0) *bid_total = 0;
  cluster.sync();  // every CTA has started, and its inbox is clear
  int total_rounds = 0, parity = 0;
  unsigned long long my_bids = 0;

  for (int p = 0; p < P; ++p) {
    const float e = eps[b * P + p];
    for (int j = tid; j < n; j += nth) {
      r2c[j] = -1;
      c2r[j] = -1;
    }
    if (tid == 0) *unassigned = n;
    __syncthreads();
    int it = 0;
    // Every CTA's replica, and so its count, is the same after a round.
    while (it < max_iters && *unassigned > 0) {
      uint2* box = inbox + parity * n;
      // 1. Bids of this CTA's unassigned rows, one warp per row, into row
      //    i's slot of every CTA's inbox.
      for (int i = warp; i < cnt; i += nwarps) {
        if (r2c[lo + i] >= 0) continue;  // same value across the warp
        int j1;
        const float* line = Ws + static_cast<long long>(i) * n;
        const float d = vec4 ? warp_bid<4, false>(line, prices, n, lane, e, j1)
                             : warp_bid<1, false>(line, prices, n, lane, e, j1);
        for (int q = lane; q < C; q += 32)
          cluster.map_shared_rank(box, q)[lo + i] = make_uint2(__float_as_uint(d), static_cast<unsigned>(j1) + 1u);
        if (lane == 0) ++my_bids;
      }
      cluster_barrier();
      // 2. Each column's best bid.
      for (int i = tid; i < n; i += nth) {
        const uint2 m = box[i];
        if (m.y == 0u) continue;
        box[i] = make_uint2(0u, 0u);
        atomicMax(&key[m.y - 1u], pack(__uint_as_float(m.x), i));
      }
      __syncthreads();
      // 3. Prices and maps, in this CTA's replica. A winner was unassigned
      //    and a kicked owner did not bid, so each row is written once.
      for (int j = tid; j < n; j += nth) {
        const unsigned long long k = key[j];
        if (k == 0ull) continue;
        key[j] = 0ull;
        const float best = packed_bid(k);
        if (!(best > kNegHalf)) continue;
        const int w = packed_who(k);
        const int old = c2r[j];
        if (old >= 0) {
          r2c[old] = -1;
        } else {
          atomicSub(const_cast<int*>(unassigned), 1);
        }
        c2r[j] = w;
        r2c[w] = j;
        prices[j] = prices[j] + best;
      }
      __syncthreads();
      parity ^= 1;
      ++it;
    }
    total_rounds += it;
    __syncthreads();  // every thread has read the count before it is reset
  }

  if (my_bids) atomicAdd(bid_total, my_bids);
  for (int t = tid; t < cnt; t += nth) {
    r2c_out[b * n + lo + t] = r2c[lo + t];
    c2r_out[b * n + lo + t] = c2r[lo + t];
    prices_out[b * n + lo + t] = prices[lo + t];
  }
  cluster.sync();  // every CTA's bid count is complete
  if (rank == 0 && tid == 0) {
    unsigned long long total = 0;
    for (int q = 0; q < C; ++q) total += *cluster.map_shared_rank(bid_total, q);
    rounds_out[b] = total_rounds;
    bids_out[b] = total;
  }
  cluster.sync();  // no CTA exits while CTA 0 may still read its memory
}

// The matcher's tail, one block per instance: greedy completion of the
// auction's maps, then the greedy best-pair 2-swap polish. Plain version:
// repro_torch/kernels/auction_fused/ref.py::polish_2swap_ref, which this
// kernel matches bit for bit.
//   Completion: the k-th unassigned row (in row order) takes the k-th column
//   of the order "unassigned columns, then assigned ones", each by index.
//   Polish: with cur[i] = W[i, perm[i]] and gain[i, i'] =
//   ((W[i, perm[i']] + W[i', perm[i]]) - cur[i]) - cur[i'], the first pair
//   (in row-major order) of the largest gain swaps its columns while that
//   gain is > 0, at most max_swaps times. A NaN gain counts as the largest,
//   as in torch.argmax, and never swaps.
constexpr int kPolishThreads = 1024;

// b beats a: the larger gain (NaN above every number), then the lower index.
__device__ __forceinline__ bool gain_beats(float bg, int bf, float ag, int af) {
  const bool bn = bg != bg, an = ag != ag;
  if (bn != an) return bn;
  if (!bn && bg != ag) return bg > ag;
  return bf < af;
}

__global__ void __launch_bounds__(kPolishThreads)
auction_polish_kernel(const float* __restrict__ W, const float* __restrict__ Wt, const int* __restrict__ r2c,
                      const int* __restrict__ c2r, long long* __restrict__ perm_out, bool* __restrict__ converged_out,
                      int n, int max_swaps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* perm = reinterpret_cast<int*>(smem);         // [n]
  float* cur = reinterpret_cast<float*>(perm + n);  // [n]
  __shared__ float red_g[32];
  __shared__ int red_f[32];
  __shared__ int open_rows;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const long long b = blockIdx.x;
  const float* Wb = W + b * n * n;
  const float* Wtb = Wt + b * n * n;

  if (tid == 0) open_rows = 0;
  __syncthreads();
  for (int i = tid; i < n; i += nth) {
    const int j = r2c[b * n + i];
    perm[i] = j;
    if (j < 0) open_rows = 1;
  }
  __syncthreads();
  if (open_rows && tid == 0) {
    int cu = 0, ca = 0;  // next unassigned and next assigned column
    for (int i = 0; i < n; ++i) {
      if (perm[i] >= 0) continue;
      while (cu < n && c2r[b * n + cu] >= 0) ++cu;
      if (cu < n) {
        perm[i] = cu++;
      } else {
        while (c2r[b * n + ca] < 0) ++ca;
        perm[i] = ca++;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nth) cur[i] = Wb[static_cast<long long>(i) * n + perm[i]];
  __syncthreads();

  for (int it = 0; it < max_swaps; ++it) {
    // Each thread visits its pairs in increasing flat index, so a strict
    // compare keeps the first of a tie.
    float g = -CUDART_INF_F;
    int f = INT_MAX;
    for (int i = warp; i < n; i += nwarps) {
      const float* Wi = Wb + static_cast<long long>(i) * n;    // W[i, :], read at perm[k]
      const float* Wc = Wtb + static_cast<long long>(perm[i]) * n;  // W[:, perm[i]], read at k
      const float ci = cur[i];
#pragma unroll 4
      for (int k = lane; k < n; k += 32) {
        const float x = ((__ldg(Wi + perm[k]) + __ldg(Wc + k)) - ci) - cur[k];
        if (gain_beats(x, i * n + k, g, f)) {
          g = x;
          f = i * n + k;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float og = __shfl_xor_sync(0xffffffffu, g, off);
      const int of = __shfl_xor_sync(0xffffffffu, f, off);
      if (gain_beats(og, of, g, f)) {
        g = og;
        f = of;
      }
    }
    if (lane == 0) {
      red_g[warp] = g;
      red_f[warp] = f;
    }
    __syncthreads();
    if (warp == 0) {
      g = lane < nwarps ? red_g[lane] : -CUDART_INF_F;
      f = lane < nwarps ? red_f[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float og = __shfl_xor_sync(0xffffffffu, g, off);
        const int of = __shfl_xor_sync(0xffffffffu, f, off);
        if (gain_beats(og, of, g, f)) {
          g = og;
          f = of;
        }
      }
      if (lane == 0) {
        red_g[0] = g;
        red_f[0] = f;
      }
    }
    __syncthreads();
    const float best = red_g[0];
    const int at = red_f[0];
    __syncthreads();  // every thread has read the winner before it is overwritten
    if (!(best > 0.f)) break;
    if (tid == 0) {
      const int i = at / n, k = at % n;
      const int pi = perm[i];
      perm[i] = perm[k];
      perm[k] = pi;
      cur[i] = Wb[static_cast<long long>(i) * n + perm[i]];
      cur[k] = Wb[static_cast<long long>(k) * n + perm[k]];
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += nth) perm_out[b * n + i] = perm[i];
  if (tid == 0) converged_out[b] = !open_rows;
}

template <int kVec>
int launch_block(const float* w, const float* p0, const float* ep, int* r, int* c, float* pr, int* ro,
                 unsigned long long* bi, int B, int n, int P, int max_iters, cudaStream_t s) {
  const size_t smem = block_smem_bytes(n);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(auction_fused_kernel<kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_fused_kernel<kVec><<<B, kBlockThreads, smem, s>>>(w, p0, ep, r, c, pr, ro, bi, n, P, max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cluster: 0 runs the one-block kernel; a power of two C in 1..16 the cluster
// kernel with C CTAs an instance (C > 8 needs a non-portable cluster size).
extern "C" int auction_fused_launch(const void* W, const void* prices0,
                                    const void* eps, void* r2c, void* c2r,
                                    void* prices, void* rounds, void* bids,
                                    int B, int n, int P, int max_iters, int cluster,
                                    void* stream) {
  if (B < 1 || n < 1 || P < 1 || max_iters < 0 || cluster < 0 || cluster > 16 ||
      (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const float* p0 = static_cast<const float*>(prices0);
  const float* ep = static_cast<const float*>(eps);
  int* r = static_cast<int*>(r2c);
  int* c = static_cast<int*>(c2r);
  float* pr = static_cast<float*>(prices);
  int* ro = static_cast<int*>(rounds);
  unsigned long long* bi = static_cast<unsigned long long*>(bids);
  if (cluster == 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    return n % 4 == 0 && aligned ? launch_block<4>(w, p0, ep, r, c, pr, ro, bi, B, n, P, max_iters, s)
                                 : launch_block<1>(w, p0, ep, r, c, pr, ro, bi, B, n, P, max_iters, s);
  }
  cudaError_t err;
  const size_t smem = cluster_smem_bytes(n, cluster);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(auction_fused_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(auction_fused_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster that cannot be placed would not run: say so before launching.
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, auction_fused_cluster_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, auction_fused_cluster_kernel, w, p0, ep, r, c, pr, ro, bi, n, P,
                           max_iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Completion and 2-swap polish of each lane's maps (B, n) int32 into perm
// (B, n) int64 and converged (B,) bool (every row assigned by the auction).
// Wt is W transposed per lane, so that a row's partner terms W[k, perm[i]]
// are read along a row of Wt.
extern "C" int auction_polish_launch(const void* W, const void* Wt, const void* r2c, const void* c2r, void* perm,
                                     void* converged, int B, int n, int max_swaps, void* stream) {
  if (B < 1 || n < 1 || n > 8192 || max_swaps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(auction_polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auction_polish_kernel<<<B, kPolishThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(Wt), static_cast<const int*>(r2c),
      static_cast<const int*>(c2r),
      static_cast<long long*>(perm), static_cast<bool*>(converged), n, max_swaps);
  return static_cast<int>(cudaGetLastError());
}
