// Latency of the steps a round of the cluster auction kernel
// (src/repro_torch/csrc/auction_fused.cu) is made of, on one H100, in SM
// cycles (clock64, read by thread 0 of CTA 0):
//
//   - a cluster barrier four ways, each also checked: every thread stores to
//     the next CTA's shared memory before the barrier and reads its own
//     after it (an error count other than 0 means the barrier does not order
//     the stores);
//   - a dependent load from another CTA's shared memory and from its own;
//   - one warp's bid (the top two of row - prices over n columns): five
//     rounds of shuffles, three redux.sync, and redux.sync with float4 loads,
//     each without and with the 8 stores of the bid to 8 CTAs.
//
// Build and run on the machine with the card:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//         -o build/cluster_latency tools/cluster_latency.cu && build/cluster_latency

#include <cooperative_groups.h>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 0: cooperative groups' cluster.sync(); 1: aligned arrive and wait;
// 2: block barrier, one thread's cluster-scope fence, relaxed arrive (the
// kernel's); 3: block barrier, then thread q < C arrives (release) on CTA q's
// mbarrier, thread 0 waits (acquire) on its own, block barrier.
template <int Mode>
__device__ __forceinline__ void barrier(uint64_t* bar, uint32_t& parity, int C) {
  if (Mode == 0) cg::this_cluster().sync();
  if (Mode == 1) asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
  if (Mode == 2) {
    __syncthreads();
    if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
  }
  if (Mode == 3) {
    __syncthreads();
    if (threadIdx.x < static_cast<unsigned>(C)) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(saddr(bar)), "r"(threadIdx.x));
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
    }
    if (threadIdx.x == 0) {
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(saddr(bar)), "r"(parity)
            : "memory");
      }
    }
    parity ^= 1;
    __syncthreads();
  }
}

template <int Mode>
__global__ void barrier_kernel(long long* out, int iters) {
  __shared__ uint64_t bar;
  __shared__ int slot[1024];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(&bar)), "r"(C));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();
  uint32_t parity = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) barrier<Mode>(&bar, parity, C);
  const long long t1 = clock64();
  long long bad = 0;
  for (int i = 0; i < iters; ++i) {
    cluster.map_shared_rank(slot, (rank + 1) % C)[threadIdx.x] = i * 1024 + static_cast<int>(threadIdx.x);
    barrier<Mode>(&bar, parity, C);
    bad += slot[threadIdx.x] != i * 1024 + static_cast<int>(threadIdx.x);
    barrier<Mode>(&bar, parity, C);
  }
  if (bad) atomicAdd(reinterpret_cast<unsigned long long*>(out) + 1, static_cast<unsigned long long>(bad));
  if (threadIdx.x == 0 && rank == 0) out[0] = (t1 - t0) / iters;
  cluster.sync();
}

__global__ void chase_kernel(long long* out, int iters) {
  __shared__ int next[1024];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) next[i] = (i * 7 + 1) & 1023;
  cluster.sync();
  if (threadIdx.x == 0 && cluster.block_rank() == 0) {
    volatile int* remote = cluster.map_shared_rank(next, 1);
    volatile int* local = next;
    int j = 0, k = 0;
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) j = remote[j];
    const long long t1 = clock64();
    for (int i = 0; i < iters; ++i) k = local[k];
    const long long t2 = clock64();
    out[0] = (t1 - t0) / iters;
    out[1] = (t2 - t1) / iters;
    out[2] = j + k;
  }
  cluster.sync();
}

__device__ __forceinline__ unsigned order_code(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_decode(unsigned c) {
  return __uint_as_float((c & 0x80000000u) ? (c & 0x7fffffffu) : ~c);
}

__device__ __forceinline__ void top2_step(float v, int c, float& v1, float& v2, int& j) {
  if (v > v1) {
    v2 = v1;
    v1 = v;
    j = c;
  } else {
    v2 = fmaxf(v2, v);
  }
}

// 0: scalar loads, shuffle merge; 1: scalar loads, redux.sync; 2: float4 loads, redux.sync.
template <int Mode>
__device__ __forceinline__ float warp_bid(const float* row, const float* prices, int n, int lane, int& j1) {
  float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
  int j = INT_MAX;
  if (Mode < 2) {
    for (int c = lane; c < n; c += 32) top2_step(row[c] - prices[c], c, v1, v2, j);
  } else {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(prices);
    for (int q = lane; q < n / 4; q += 32) {
      const float4 w = r4[q], p = p4[q];
      top2_step(w.x - p.x, 4 * q, v1, v2, j);
      top2_step(w.y - p.y, 4 * q + 1, v1, v2, j);
      top2_step(w.z - p.z, 4 * q + 2, v1, v2, j);
      top2_step(w.w - p.w, 4 * q + 3, v1, v2, j);
    }
  }
  if (Mode == 0) {
    for (int off = 16; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
      const int oj = __shfl_xor_sync(0xffffffffu, j, off);
      if (o1 > v1 || (o1 == v1 && oj < j)) {
        v2 = fmaxf(o2, v1);
        v1 = o1;
        j = oj;
      } else {
        v2 = fmaxf(v2, o1);
      }
    }
    j1 = j;
    return v1 - fmaxf(v2, -1e30f);
  }
  const unsigned best = __reduce_max_sync(0xffffffffu, order_code(v1));
  j1 = static_cast<int>(__reduce_min_sync(0xffffffffu, order_code(v1) == best ? static_cast<unsigned>(j) : UINT_MAX));
  const unsigned second = __reduce_max_sync(0xffffffffu, order_code(j == j1 ? v2 : v1));
  return order_decode(best) - fmaxf(order_decode(second), -1e30f);
}

template <int Mode, bool Post>
__global__ void bid_kernel(long long* out, int iters, int n) {
  __shared__ __align__(16) float row[1024];
  __shared__ __align__(16) float prices[1024];
  __shared__ uint2 box[1024];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    row[i] = (i * 37 % 101) * 0.5f;
    prices[i] = 0.f;
  }
  cluster.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
      int j1;
      const float d = warp_bid<Mode>(row, prices, n, lane, j1);
      if (Post && lane < 8) cluster.map_shared_rank(box, lane)[it & 1023] = make_uint2(__float_as_uint(d), j1 + 1);
      if (lane == 0) prices[j1] += d + 1e-3f;  // the next bid depends on this one
      __syncwarp();
    }
    const long long t1 = clock64();
    if (lane == 0 && cluster.block_rank() == 0) out[0] = (t1 - t0) / iters;
  }
  cluster.sync();
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, int C, int threads, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (C > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    std::printf("CUDA error %d\n", static_cast<int>(err));
    std::exit(1);
  }
}

}  // namespace

int main() {
  long long* dev;
  cudaMalloc(&dev, 64);
  long long host[3];
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  std::printf("%s, clock %d kHz\n", prop.name, prop.clockRate);
  const char* names[] = {"cluster.sync()", "aligned arrive + wait", "block barrier + fence + relaxed arrive",
                         "mbarrier, one remote arrive a CTA"};
  void (*barriers[])(long long*, int) = {barrier_kernel<0>, barrier_kernel<1>, barrier_kernel<2>, barrier_kernel<3>};
  for (int m = 0; m < 4; ++m) {
    for (int C : {8, 16}) {
      for (int threads : {512, 1024}) {
        cudaMemset(dev, 0, 64);
        launch(barriers[m], C, threads, dev, 4000);
        cudaMemcpy(host, dev, 16, cudaMemcpyDeviceToHost);
        std::printf("barrier [%s] C=%d threads=%d: %lld cycles, exchange errors %lld\n", names[m], C, threads,
                    host[0], host[1]);
      }
    }
  }
  launch(chase_kernel, 2, 128, dev, 2000);
  cudaMemcpy(host, dev, 24, cudaMemcpyDeviceToHost);
  std::printf("dependent load: another CTA's shared memory %lld cycles, own %lld cycles\n", host[0], host[1]);
  void (*bids[])(long long*, int, int) = {bid_kernel<0, false>, bid_kernel<1, false>, bid_kernel<2, false>,
                                          bid_kernel<0, true>,  bid_kernel<1, true>,  bid_kernel<2, true>};
  const char* bid_names[] = {"shuffles", "redux", "float4 + redux"};
  for (int n : {128, 512, 1024}) {
    for (int k = 0; k < 6; ++k) {
      launch(bids[k], 8, 512, dev, 2000, n);
      cudaMemcpy(host, dev, 8, cudaMemcpyDeviceToHost);
      std::printf("one warp's bid n=%d [%s%s]: %lld cycles\n", n, bid_names[k % 3],
                  k >= 3 ? ", then 8 remote stores" : "", host[0]);
    }
  }
  return 0;
}
