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
// bytes: 2^23 events are ~0.1 GB, ~30 us at 3.35 TB/s. What can hold it back
// is contention on the atomics: many events on one cell serialise.
//
// Design: blocks of 256 threads stride over the events (neighbouring threads
// on neighbouring events, so the loads coalesce). When the n x n float32
// matrix fits the opt-in shared memory (n <= 241 on the H100), each block
// keeps a private copy there, adds its events to it with shared-memory
// atomicAdd, and at the end adds each nonzero cell of its copy to global
// memory once: global atomics then number (blocks x touched cells), not T.
// Above that size every event is an atomicAdd straight into global memory
// (L2). Float atomics make the order of the sum vary from run to run, so the
// result equals a float64 sum to rounding, not bit for bit.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__device__ __forceinline__ bool cell(const Idx* src, const Idx* dst, long long t, int n, int* out) {
  const Idx s = src[t], d = dst[t];
  if (s < 0 || s >= n || d < 0 || d >= n) return false;
  *out = static_cast<int>(s) * n + static_cast<int>(d);
  return true;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
demand_accum_shared(const Idx* __restrict__ src, const Idx* __restrict__ dst,
                    const float* __restrict__ w, float* __restrict__ out, long long T, int n) {
  extern __shared__ float acc[];
  const int cells = n * n;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < T; t += stride) {
    int c;
    if (cell(src, dst, t, n, &c)) atomicAdd(&acc[c], w[t]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
demand_accum_global(const Idx* __restrict__ src, const Idx* __restrict__ dst,
                    const float* __restrict__ w, float* __restrict__ out, long long T, int n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < T; t += stride) {
    int c;
    if (cell(src, dst, t, n, &c)) atomicAdd(&out[c], w[t]);
  }
}

template <typename Idx>
int launch(const void* src, const void* dst, const void* w, void* out, long long T, int n,
           cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = 4LL * n * n;
  const long long needed = (T + kThreads - 1) / kThreads;
  const Idx* s = static_cast<const Idx*>(src);
  const Idx* d = static_cast<const Idx*>(dst);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (smem <= optin) {
    // As many private copies per SM as fit, at most 4: each block's flush
    // costs up to n^2 global atomics, so fewer, longer blocks are cheaper.
    const long long per_sm = smem > 0 ? std::max(1LL, std::min(4LL, (228LL * 1024) / smem)) : 4LL;
    const unsigned blocks = static_cast<unsigned>(std::max(1LL, std::min(needed, per_sm * sms)));
    err = cudaFuncSetAttribute(demand_accum_shared<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    demand_accum_shared<Idx><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(s, d, wf, o, T, n);
  } else {
    const unsigned blocks = static_cast<unsigned>(std::max(1LL, std::min(needed, 8LL * sms)));
    demand_accum_global<Idx><<<blocks, kThreads, 0, stream>>>(s, d, wf, o, T, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src/dst: T indices, int32 (idx64 = 0) or int64 (idx64 = 1); w: T float32;
// out: (n, n) float32, zeroed by the caller. T >= 1, n >= 1.
extern "C" int demand_accum_launch(const void* src, const void* dst, const void* w, void* out,
                                   long long T, int n, int idx64, void* stream) {
  if (T < 1 || n < 1 || n > 46340) return static_cast<int>(cudaErrorInvalidValue);  // n * n fits an int
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64 == 0) return launch<int>(src, dst, w, out, T, n, s);
  if (idx64 == 1) return launch<long long>(src, dst, w, out, T, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
