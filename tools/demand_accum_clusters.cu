// Demand-matrix accumulation: D[src[t], dst[t]] += w[t] over T traffic events,
// into an (n, n) float32 matrix; events whose src or dst lies outside [0, n)
// add nothing.
//
// Replaces the TPU kernel src/repro/kernels/demand_accum/kernel.py::_accum_kernel
// (launched by demand_accum_pallas). Plain version: repro_torch/kernels/
// demand_accum/ref.py::demand_accum_ref.
//
// The TPU kernel recasts the scatter as one-hot matmuls on the MXU,
// D += onehot(src)^T @ (onehot(dst) * w) per block of 512 events, because a
// scatter is hostile to the TPU. On Hopper the scatter is the natural form,
// and the one-hot product would spend n^2 multiply-adds per event.
//
// Bound on the H100: bytes. Each event reads 12 bytes (two int32 indices and
// a float32 weight; 20 with int64 indices) and the kernel writes n^2 * 4
// bytes: 2^23 events are ~0.1 GB, ~30 us at 3.35 TB/s. What holds a scatter
// back is its atomics: many adds on one address serialise, and an add into
// L2 costs far more than one into shared memory.
//
// A design that does not ship: src/repro_torch/csrc/demand_accum.cu with
// three more choices as constexpr knobs, for tools/kernel_variants.py accum
// (which builds it in place of that file). With the knobs as here it is the
// second round's design: 1024 threads, two copies a CTA, no clusters. The
// choices, each measured slower than the shipped one (PERF.md):
//   * kCopyCluster > 1: the private copies of a thread block cluster summed
//     over distributed shared memory before one flush a cluster;
//   * kMaxRowCluster > 0: where n x n does not fit a CTA (n up to 960), a
//     cluster of up to 16 CTAs splits the matrix's rows (rows a multiple of
//     four), each CTA reads its share of the events and adds each into the
//     owner's rows, remote over distributed shared memory (a generic
//     atomicAdd, or red.shared::cluster on a mapa address with kRemoteRed),
//     then adds its rows to the output;
//   * kAggregate: the lanes of a warp that add to one cell find each other
//     with __match_any_sync and add their sum once.
// Float atomics make the order of the sum vary from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;          // 16-byte groups of four events a thread loads before adding them
constexpr int kCopies = 2;          // private copies a CTA where they fit (warp w adds into copy w % copies)
constexpr int kCopyCluster = 1;     // private-copy path: CTAs whose copies are summed before one flush
constexpr int kMaxRowCluster = 0;   // row-split path: the largest cluster (16 is non-portable); 0 turns it off
constexpr bool kVectorLoads = true;
constexpr bool kAggregate = false;  // lanes of a warp that add to one cell add their sum once
constexpr bool kRemoteRed = false;  // row-split path: remote adds as red.shared::cluster on a mapa address

template <typename Idx>
__device__ __forceinline__ void load4(const Idx* p, long long e, Idx (&o)[4]);

template <>
__device__ __forceinline__ void load4<int>(const int* p, long long e, int (&o)[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p + e));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<long long>(const long long* p, long long e, long long (&o)[4]) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p + e));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p + e) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

template <typename Idx, typename Add>
__device__ __forceinline__ void add_event(Idx s, Idx d, float v, int n, Add& add) {
  using U = std::make_unsigned_t<Idx>;
  if (static_cast<U>(s) < static_cast<U>(n) && static_cast<U>(d) < static_cast<U>(n))
    add(static_cast<int>(s), static_cast<int>(d), v);
}

// Every event of [0, T) once over the grid's threads: events [head, head +
// 4 * groups) in 16-byte loads (neighbouring threads on neighbouring groups),
// the rest (the head before the arrays' 16-byte boundary, the tail) one by
// one. groups = 0 runs every event one by one.
template <typename Idx, typename Add>
__device__ __forceinline__ void for_each_event(const Idx* __restrict__ src, const Idx* __restrict__ dst,
                                               const float* __restrict__ w, long long T, int n, long long head,
                                               long long groups, Add add) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nth = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = tid; g < groups; g += kUnroll * nth) {
    Idx s[kUnroll][4], d[kUnroll][4];
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long gu = g + u * nth;
      if (gu < groups) {
        const long long e = head + 4 * gu;
        load4(src, e, s[u]);
        load4(dst, e, d[u]);
        v[u] = __ldcs(reinterpret_cast<const float4*>(w + e));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[u][j] = d[u][j] = -1;  // adds nothing
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_event(s[u][0], d[u][0], v[u].x, n, add);
      add_event(s[u][1], d[u][1], v[u].y, n, add);
      add_event(s[u][2], d[u][2], v[u].z, n, add);
      add_event(s[u][3], d[u][3], v[u].w, n, add);
    }
  }
  for (long long e = tid; e < head; e += nth) add_event(src[e], dst[e], w[e], n, add);
  for (long long e = head + 4 * groups + tid; e < T; e += nth) add_event(src[e], dst[e], w[e], n, add);
}

// out[4i .. 4i + 3] += v (cells from `count` on are not the output's), one
// 16-byte atomic where all four are; cells that add 0 are skipped.
__device__ __forceinline__ void add_quad(float* __restrict__ out, int i, float4 v, int count) {
  if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) return;
  if (4 * i + 3 < count) {
    atomicAdd(reinterpret_cast<float4*>(out) + i, v);
    return;
  }
  const float c[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < 4 && 4 * i + j < count; ++j)
    if (c[j] != 0.0f) atomicAdd(out + 4 * i + j, c[j]);
}

// acc[c] += v in shared memory; with kAggregate the lanes of the warp that add
// to the same cell add their sum once, from the lowest of them.
__device__ __forceinline__ void shared_add(float* acc, int c, float v) {
  if (!kAggregate) {
    atomicAdd(acc + c, v);
    return;
  }
  const unsigned peers = __match_any_sync(__activemask(), c);
  float sum = 0.0f;
  for (unsigned m = peers; m; m &= m - 1) sum += __shfl_sync(peers, v, __ffs(m) - 1);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(acc + c, sum);
}

// The cluster's private copies (`copies` a CTA, `quads` quads each) summed, over
// distributed shared memory where the cluster has more than one CTA, and added
// to `out`: CTA r of k takes quads r, r + k, ... of every copy.
__device__ __forceinline__ void flush_copies(float4* smem, int quads, int copies, float* __restrict__ out,
                                             int cells) {
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every copy complete
  for (int i = r + k * static_cast<int>(threadIdx.x); i < quads; i += k * blockDim.x) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < k; ++q) {
      const float4* copy = k > 1 ? cluster.map_shared_rank(smem, q) : smem;
      for (int c = 0; c < copies; ++c) {
        const float4 x = copy[c * quads + i];
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
    }
    add_quad(out, i, sum, cells);
  }
  cluster.sync();  // no CTA leaves while another reads its copy
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads, 1)
demand_accum_private(const Idx* __restrict__ src, const Idx* __restrict__ dst, const float* __restrict__ w,
                     float* __restrict__ out, long long T, int n, int copies, long long head, long long groups) {
  extern __shared__ float4 smem[];
  const int cells = n * n;
  const int quads = (cells + 3) / 4;
  for (int i = threadIdx.x; i < copies * quads; i += blockDim.x) smem[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  float* acc = reinterpret_cast<float*>(smem + (threadIdx.x / 32) % copies * quads);
  for_each_event(src, dst, w, T, n, head, groups, [&](int s, int d, float v) { shared_add(acc, s * n + d, v); });
  flush_copies(smem, quads, copies, out, cells);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads, 1)
demand_accum_rows(const Idx* __restrict__ src, const Idx* __restrict__ dst, const float* __restrict__ w,
                  float* __restrict__ out, long long T, int n, int rows, long long head, long long groups) {
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const int quads = (rows * n + 3) / 4;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) smem[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  cluster.sync();  // every CTA's rows zeroed before any add lands in them
  for_each_event(src, dst, w, T, n, head, groups, [&](int s, int d, float v) {
    const int owner = s / rows;
    float* p = acc + (s - owner * rows) * n + d;
    if (owner == me) {
      atomicAdd(p, v);
    } else if (kRemoteRed) {
      uint32_t a;
      asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
          "r"(owner));
      asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
    } else {
      atomicAdd(cluster.map_shared_rank(p, owner), v);
    }
  });
  cluster.sync();  // every add landed
  const int r0 = me * rows, r1 = min(n, r0 + rows);
  const int count = max(0, r1 - r0) * n;  // r0 * n is a multiple of 4: rows is
  float* mine = out + static_cast<long long>(r0) * n;
  for (int i = threadIdx.x; 4 * i < count; i += blockDim.x) add_quad(mine, i, smem[i], count);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
demand_accum_global(const Idx* __restrict__ src, const Idx* __restrict__ dst, const float* __restrict__ w,
                    float* __restrict__ out, long long T, int n, long long head, long long groups) {
  for_each_event(src, dst, w, T, n, head, groups, [&](int s, int d, float v) { atomicAdd(&out[s * n + d], v); });
}

// Launches `kernel` in clusters of k CTAs, as many clusters as can run at once
// (at most enough for one 16-byte group a thread), with `smem` bytes of
// dynamic shared memory a CTA.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int k, size_t smem, long long wanted_ctas,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && k > 8) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;  // a cluster that cannot be placed would not run
  const long long clusters = std::max(1LL, std::min<long long>(active, (wanted_ctas + k - 1) / k));
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * k));
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The rows a CTA of a k-CTA cluster owns (a multiple of four, so every CTA's
// first cell is 16-byte aligned in the output), and its shared-memory bytes.
int cluster_rows(int n, int k) { return ((n + k - 1) / k + 3) / 4 * 4; }
long long quad_bytes(long long cells) { return 16 * ((cells + 3) / 4); }

template <typename Idx>
int launch(const Idx* src, const Idx* dst, const float* w, float* out, long long T, int n, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte groups: from the first event at which w is 16-byte aligned, where
  // src and dst are aligned there too.
  long long head = 0, groups = 0;
  if (kVectorLoads) {
    const long long h = std::min<long long>(T, ((16 - reinterpret_cast<uintptr_t>(w) % 16) % 16) / 4);
    if (reinterpret_cast<uintptr_t>(src + h) % 16 == 0 && reinterpret_cast<uintptr_t>(dst + h) % 16 == 0) {
      head = h;
      groups = (T - h) / 4;
    }
  }
  const long long wanted = std::max(1LL, (T + 4LL * kThreads - 1) / (4LL * kThreads));
  const long long private_bytes = quad_bytes(static_cast<long long>(n) * n);
  if (private_bytes <= optin) {
    const int copies = static_cast<int>(std::min<long long>(kCopies, optin / private_bytes));
    // Past half the SM's shared memory: one CTA an SM, on every SM (contended
    // events then spread over as many copies as the card holds).
    const size_t smem = static_cast<size_t>(std::max<long long>(copies * private_bytes, optin / 2 + 1024));
    err = launch_clusters(demand_accum_private<Idx>, kCopyCluster, smem, 1LL << 40, stream, src, dst, w, out, T, n,
                          copies, head, groups);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  for (int k = 2; k <= kMaxRowCluster; k *= 2) {
    const int rows = cluster_rows(n, k);
    const long long bytes = quad_bytes(static_cast<long long>(rows) * n);
    if (bytes > optin) continue;
    const size_t smem = static_cast<size_t>(std::max<long long>(bytes, optin / 2 + 1024));
    err = launch_clusters(demand_accum_rows<Idx>, k, smem, 1LL << 40, stream, src, dst, w, out, T, n, rows,
                          head, groups);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const unsigned blocks = static_cast<unsigned>(std::max(1LL, std::min(wanted, (2048LL / kThreads) * sms)));
  demand_accum_global<Idx><<<blocks, kThreads, 0, stream>>>(src, dst, w, out, T, n, head, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src/dst: T indices, int32 (idx64 = 0) or int64 (idx64 = 1); w: T float32;
// out: (n, n) float32, zeroed by the caller, 16-byte aligned. T >= 1, n >= 1.
extern "C" int demand_accum_launch(const void* src, const void* dst, const void* w, void* out,
                                   long long T, int n, int idx64, void* stream) {
  if (T < 1 || n < 1 || n > 46340 || reinterpret_cast<uintptr_t>(out) % 16)  // n * n fits an int
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (idx64 == 0) return launch(static_cast<const int*>(src), static_cast<const int*>(dst), wf, o, T, n, s);
  if (idx64 == 1)
    return launch(static_cast<const long long*>(src), static_cast<const long long*>(dst), wf, o, T, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
