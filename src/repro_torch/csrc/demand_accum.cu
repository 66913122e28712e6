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
// bytes: 2^23 events are ~0.1 GB, ~30 us at 3.35 TB/s.
//
// Design (a redesign of the first port, which ran up to four CTAs of 256
// threads an SM, each with a private copy, loading one event a thread a step;
// PERF.md has the split that chose it):
//   * Events: what held the first port back was its loads in flight, not
//     its flush. Each thread loads four events an array with one 16-byte load
//     (where the three arrays share their 16-byte phase; a scalar head and
//     tail round them off), two such groups before it adds any, and a CTA
//     runs 1024 threads.
//   * n x n fits a CTA's shared memory (n <= 241 on the H100): one CTA an SM
//     (its shared memory is sized past half the SM's), on every SM, keeping
//     as many private copies of the matrix as fit, up to kCopies; warp w adds
//     its events into copy w % copies with shared-memory atomics, so adds to
//     one hot cell spread over the copies (contended adds to one shared
//     address serialise). At the end the CTA sums its copies and adds them
//     to the output, one 16-byte atomic per four cells: SMs x n^2 / 4 global
//     atomics in all, where the first port issued up to 528 x n^2.
//   * Above that, every event is an atomicAdd into global memory (L2), which
//     holds this path: the loads alone take 0.042 ms at T = 2^23. Rows split
//     over a thread block cluster, remote adds over distributed shared
//     memory, took twice as long as L2's atomics (tools/demand_accum_clusters.cu).
// Float atomics make the order of the sum vary from run to run, so the result
// equals a float64 sum to rounding, not bit for bit.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;  // 16-byte groups of four events a thread loads before adding them
constexpr int kCopies = 8;  // private copies a CTA where they fit (warp w adds into copy w % copies)

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
    add(static_cast<int>(s) * n + static_cast<int>(d), v);
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
  for_each_event(src, dst, w, T, n, head, groups, [&](int c, float v) { atomicAdd(acc + c, v); });
  __syncthreads();
  // The copies' sum, added to out[4i .. 4i + 3] by one 16-byte atomic (the
  // output is 16-byte aligned); a sum of 0 adds nothing.
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < copies; ++c) {
      const float4 x = smem[c * quads + i];
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    if (sum.x == 0.0f && sum.y == 0.0f && sum.z == 0.0f && sum.w == 0.0f) continue;
    if (4 * i + 3 < cells) {
      atomicAdd(reinterpret_cast<float4*>(out) + i, sum);
    } else {  // the matrix's last cells, where n * n is not a multiple of 4
      const float part[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int j = 0; 4 * i + j < cells; ++j) atomicAdd(out + 4 * i + j, part[j]);
    }
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
demand_accum_global(const Idx* __restrict__ src, const Idx* __restrict__ dst, const float* __restrict__ w,
                    float* __restrict__ out, long long T, int n, long long head, long long groups) {
  for_each_event(src, dst, w, T, n, head, groups, [&](int c, float v) { atomicAdd(out + c, v); });
}

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
  const long long h = std::min<long long>(T, ((16 - reinterpret_cast<uintptr_t>(w) % 16) % 16) / 4);
  if (reinterpret_cast<uintptr_t>(src + h) % 16 == 0 && reinterpret_cast<uintptr_t>(dst + h) % 16 == 0) {
    head = h;
    groups = (T - h) / 4;
  }
  const long long copy_bytes = 16 * ((static_cast<long long>(n) * n + 3) / 4);
  if (copy_bytes <= optin) {
    const int copies = static_cast<int>(std::min<long long>(kCopies, optin / copy_bytes));
    // Past half the SM's shared memory: one CTA an SM.
    const int smem = static_cast<int>(std::max<long long>(copies * copy_bytes, optin / 2 + 1024));
    err = cudaFuncSetAttribute(demand_accum_private<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    demand_accum_private<Idx><<<sms, kThreads, smem, stream>>>(src, dst, w, out, T, n, copies, head, groups);
  } else {
    const long long wanted = (T + 4LL * kThreads - 1) / (4LL * kThreads);
    const unsigned blocks = static_cast<unsigned>(std::max(1LL, std::min(wanted, (2048LL / kThreads) * sms)));
    demand_accum_global<Idx><<<blocks, kThreads, 0, stream>>>(src, dst, w, out, T, n, head, groups);
  }
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
