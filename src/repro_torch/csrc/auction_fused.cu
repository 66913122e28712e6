// The whole forward epsilon-scaling auction in one launch: one thread block
// cluster per instance where the instance's W fits in the cluster's shared
// memory, else one block per instance.
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
// row (2 bidders in the median round): the floor is rounds x a round's
// latency, far above the bytes or flops bound. One block on one SM per
// instance, streaming the bidding rows of W from L2 every round, takes
// ~2.9 us a round at n = 512; a cluster that holds W takes ~1.8.
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
// One-block kernel (larger n): one block of 1024 threads per instance, W
// streamed from L2, prices and maps in shared memory (20 bytes a column), the
// same packed word in a shared atomicMax, two block barriers a round.
//
// Both kernels take a warp's top two with three redux.sync reductions on the
// order codes (auction_common.cuh) rather than five rounds of shuffles.

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
using auction::order_code;
using auction::order_decode;
using auction::pack;
using auction::packed_bid;
using auction::packed_who;

constexpr int kBlockThreads = 1024;   // the one-block kernel
constexpr int kClusterThreads = 512;  // one CTA of the cluster kernel
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most one block may use
constexpr size_t kHead = 16;           // bid total (8 bytes) and unassigned count

// One more column c of value v into a lane's running top two (first column
// on ties: the lane sees its columns in increasing order).
__device__ __forceinline__ void top2_step(float v, int c, float& v1, float& v2, int& j) {
  if (v > v1) {
    v2 = v1;
    v1 = v;
    j = c;
  } else {
    v2 = fmaxf(v2, v);
  }
}

// A row's bid: each lane keeps the top two of row[c] - prices[c] over its
// columns (four adjacent columns a load where rows and prices are 16-byte
// aligned); then the warp's best value, its first column, and the best
// value of every other column, each one redux.sync on order codes. The top
// two with first-column ties do not depend on how the columns are dealt to
// the lanes. Returns inc and sets j1 on every lane.
__device__ __forceinline__ float warp_bid(const float* row, const float* prices, int n, int lane,
                                          float e, int& j1) {
  float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
  int j = INT_MAX;
  if ((n & 3) == 0 && ((reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(prices)) & 15) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(prices);
    for (int q = lane; q < n / 4; q += 32) {
      const float4 w = r4[q], p = p4[q];
      top2_step(w.x - p.x, 4 * q, v1, v2, j);
      top2_step(w.y - p.y, 4 * q + 1, v1, v2, j);
      top2_step(w.z - p.z, 4 * q + 2, v1, v2, j);
      top2_step(w.w - p.w, 4 * q + 3, v1, v2, j);
    }
  } else {
    for (int c = lane; c < n; c += 32) top2_step(row[c] - prices[c], c, v1, v2, j);
  }
  const unsigned best = __reduce_max_sync(0xffffffffu, order_code(v1));
  j1 = static_cast<int>(__reduce_min_sync(0xffffffffu, order_code(v1) == best ? static_cast<unsigned>(j) : UINT_MAX));
  // Column j1's lane offers its second best, every other lane its best.
  const unsigned second = __reduce_max_sync(0xffffffffu, order_code(j == j1 ? v2 : v1));
  return order_decode(best) - fmaxf(order_decode(second), kNeg) + e;
}

size_t block_smem_bytes(int n) { return kHead + static_cast<size_t>(n) * 20; }

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
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + kHead);  // [n]
  float* prices = reinterpret_cast<float*>(key + n);
  int* r2c = reinterpret_cast<int*>(prices + n);
  int* c2r = r2c + n;

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
    }
    if (tid == 0) *unassigned = n;
    __syncthreads();
    int it = 0;
    // `unassigned` changes only between the two barriers of a round.
    while (it < max_iters && *unassigned > 0) {
      // 1. Bids of the unassigned rows, one warp per row.
      for (int i = warp; i < n; i += nwarps) {
        if (r2c[i] >= 0) continue;  // same value across the warp
        int j1;
        const float d = warp_bid(Wb + static_cast<long long>(i) * n, prices, n, lane, e, j1);
        if (lane == 0) {
          atomicMax(&key[j1], pack(d, i));
          ++my_bids;
        }
      }
      __syncthreads();
      // 2-3. Each column takes its best bid.
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
        const float d = warp_bid(Ws + static_cast<long long>(i) * n, prices, n, lane, e, j1);
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
  cudaError_t err;
  if (cluster == 0) {
    const size_t smem = block_smem_bytes(n);
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(auction_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    auction_fused_kernel<<<B, kBlockThreads, smem, s>>>(w, p0, ep, r, c, pr, ro, bi, n, P, max_iters);
    return static_cast<int>(cudaGetLastError());
  }
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
