// Forward GQA flash attention: online softmax over key/value tiles, causal
// and/or sliding-window masks, queries aligned to the end of the KV stream.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (launched by flash_attention_pallas). Plain version: repro_torch/kernels/
// flash_attention/ref.py::mha_ref.
//
// Layout: q (B*Hq, Sq, D), k/v (B*Hkv, Sk, D), o like q; float32 or bfloat16 in
// and out, float32 inside (scores, softmax statistics, accumulator). Query
// head row bh reads KV row bh / group (group = Hq / Hkv): GQA by indexing, the
// repeated KV is never formed. D is 32, 64 or 128 (no padding to 128, which the
// TPU wrapper needs for its lanes).
//
// Bound on the H100: operations. At zamba2-1.2b's prefill (B = 2, 32 heads,
// S = 4096, D = 64, causal) the two products take ~1.4e11 flops against
// ~134 MB of q, k, v and o: ~0.14 ms at the bf16 tensor-core peak, against
// ~0.04 ms of memory traffic. This first kernel computes on the CUDA cores in
// float32 (FMAs, no tensor cores), so it sits far above that bound; the
// tensor-core version (mma.sync or wgmma on bf16 tiles) is later work.
//
// Design: one block of 256 threads per (bh, 64-query tile). The query tile
// stays in shared memory; the loop walks 64-key tiles of K and V through
// shared memory. Each thread holds a 4x4 block of the score tile (rows
// ty + 16i, columns tx + 16j), so a row's 64 scores sit in the 16 lanes of
// one half-warp and its max and sum reduce with four shuffles. P goes through
// shared memory into the P.V product, where each thread owns 4 rows and D/16
// columns of the output accumulator in registers. Key tiles wholly outside
// the causal frontier or the window are skipped (the reference computes them
// and masks them out): the same function with less work. The latest query
// tiles, which have the most keys under a causal mask, are scheduled first.
//
// Masked scores are -inf and give p = 0. A row that no key may attend keeps
// l = 0 and comes out 0, as in the reference kernel (kernel.py, the guards on
// m_new and l); with Sq <= Sk and a causal mask, or a window >= 1, every
// query row keeps at least its own position, so such a row cannot occur.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_bytes() {
  return (2 * kBQ * (D + 4) + kBK * D + kBQ * (kBK + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int Sq, int Sk, float scale, int causal, int window) {
  constexpr int LD = D + 4;  // float4-aligned rows, conflict-free float4 reads
  constexpr int LP = kBK + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;     // [kBK][LD]
  float* Vs = Ks + kBK * LD;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][LP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long bh = blockIdx.x;
  const int nqb = gridDim.y;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int off = Sk - Sq;  // query row r sits at absolute position r + off
  const T* qp = q + bh * Sq * D;
  const T* kp = k + (bh / group) * Sk * D;
  const T* vp = v + (bh / group) * Sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = (q0 + r < Sq) ? to_f(qp[static_cast<long long>(q0 + r) * D + c]) : 0.f;
  }

  // Keys any row of this tile may attend: [k_begin, k_end).
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ps
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = kt + r < Sk;
      const long long g = static_cast<long long>(kt + r) * D + c;
      Ks[r * LD + c] = in ? to_f(kp[g]) : 0.f;
      Vs[r * D + c] = in ? to_f(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + off;
      const bool row_in = q0 + r < Sq;
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + tx + 16 * j;
        bool keep = row_in && kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
      const float m_new = fmaxf(m[i], tmax);
      // Nothing kept yet in this row: the accumulator and l are still 0.
      const float corr = (m_new == -CUDART_INF_F) ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -CUDART_INF_F) ? 0.f : expf(s[i][j] - m_new);
        Ps[r * LP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int kn = min(kBK, k_end - kt);  // columns past k_end hold p = 0
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
    T* orow = o + (bh * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int group,
           int Sq, int Sk, float scale, int causal, int window, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), group, Sq, Sk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH, int group,
             int Sq, int Sk, int D, float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, BH, group, Sq, Sk, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, group, Sq, Sk, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, group, Sq, Sk, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window < 1 means no window. dtype: 0 float32, 1 bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int group, int Sq, int Sk, int D, float scale,
                                      int causal, int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, BH, group, Sq, Sk, D, scale, causal, window, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, BH, group, Sq, Sk, D, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
