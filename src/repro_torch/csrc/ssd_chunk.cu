// Mamba-2 SSD intra-chunk pass: for each (batch*head bh, chunk c) of length L,
//
//   la      = cumsum(loga) within the chunk (inclusive)
//   y       = ((C B^T) * causal exp(la_t - la_u)) . xd          (L, P)
//   state   = (B * exp(la_L - la))^T . xd                        (N, P)
//   gate    = exp(la_L)
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::_ssd_chunk_kernel
// (launched by ssd_chunk_pallas). Plain version: repro_torch/kernels/ssd_scan/
// ref.py::ssd_chunk_ref. The cross-chunk recurrence and the inter-chunk
// correction stay in the torch wrapper (kernels/ssd_scan/ops.py), as they stay
// in the reference's jnp wrapper.
//
// Layout: xd (BH, S, P), loga (BH, S) float32, B/C (BH, S, N); xd, B and C are
// float32 or bfloat16. Outputs, all float32: y (BH, S, P); states
// (BH*nc, N, P), row bh*nc + c, as the reference's out BlockSpec lays it;
// gates (BH, nc). L, N, P <= 128.
//
// Bound on the H100: bytes. At zamba2-1.2b's prefill (BH = 2*64, S = 4096,
// L = 128, N = P = 64, bf16 inputs) the pass reads ~0.2 GB and writes
// ~0.2 GB (y and the states in float32) for ~21 GFLOP: ~0.12 ms of memory
// traffic against ~0.02 ms at the bf16 tensor-core peak. This first kernel
// computes in float32 on the CUDA cores, so its products, not its traffic,
// set its time; tensor-core tiles are later work. B and C arrive repeated
// over the heads of a group (the reference's layout); reading them once per
// group is a later optimisation too.
//
// Design: one block of 256 threads per (bh, chunk). B, C and xd of the chunk
// go to shared memory as float32 (rows padded to an odd stride, so the 16
// lanes reading 16 rows hit 16 banks); thread 0 forms la as a sequential
// prefix sum, in the order of the plain version's cumsum. The L x L score
// matrix never exists whole: 64 rows at a time go to shared memory (each
// thread computes a 4 x 8 register tile of C B^T times the decay, zero above
// the diagonal), and the same threads then form those 64 rows of y, summing
// only over the columns below the tile's last row (the rest are 0). Then B is
// scaled in place by exp(la_L - la) and each thread accumulates an up-to
// 8 x 8 tile of the state. Every exp is of a number <= 0, as in the
// reference: the decay clamps la_t - la_u at 0, and la decreases.
// Shared memory: 4 (2 L (N+1) + L (P+1) + L + 64 (L+1)) bytes, 130 KB at the
// zamba2 shapes, set with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // score rows held at a time
constexpr int kMax = 128;  // bound on L, N and P

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

int smem_bytes(int L, int N, int P) {
  return static_cast<int>(sizeof(float)) * (2 * L * (N + 1) + L * (P + 1) + L + kRows * (L + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ xd, const float* __restrict__ loga,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ gates, int S, int L, int N, int P) {
  extern __shared__ float smem[];
  const int LN = N + 1, LPx = P + 1, LL = L + 1;
  float* Bs = smem;            // [L][LN]
  float* Cs = Bs + L * LN;     // [L][LN]
  float* Xs = Cs + L * LN;     // [L][LPx]
  float* la = Xs + L * LPx;    // [L]
  float* Ss = la + L;          // [kRows][LL]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long blk = blockIdx.x;  // = bh * nc + c
  const int nc = S / L;
  const long long bh = blk / nc;
  const int c = static_cast<int>(blk % nc);
  const long long row0 = bh * S + static_cast<long long>(c) * L;  // first step of the chunk

  for (int i = tid; i < L * N; i += kThreads) {
    const int r = i / N, n = i % N;
    Bs[r * LN + n] = to_f(Bm[row0 * N + i]);
    Cs[r * LN + n] = to_f(Cm[row0 * N + i]);
  }
  for (int i = tid; i < L * P; i += kThreads) {
    const int r = i / P, p = i % P;
    Xs[r * LPx + p] = to_f(xd[row0 * P + i]);
  }
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      acc += loga[row0 + t];
      la[t] = acc;
    }
  }
  __syncthreads();
  const float la_end = la[L - 1];

  for (int t0 = 0; t0 < L; t0 += kRows) {
    // Scores of rows t0 + ty + 16i, columns tx + 16j; columns above the
    // tile's last row are 0 and not needed.
    const int u_end = min(L, t0 + kRows);
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = min(t0 + ty + 16 * i, L - 1);
        cv[i] = Cs[t * LN + n];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = min(tx + 16 * j, L - 1);
        bv[j] = Bs[u * LN + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = tx + 16 * j;
        if (u >= u_end) continue;
        Ss[(ty + 16 * i) * LL + u] = (u <= t) ? sc[i][j] * expf(fminf(la[t] - la[u], 0.f)) : 0.f;
      }
    }
    __syncthreads();

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int u = 0; u < u_end; ++u) {
      float sv[4], xv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * LL + u];
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = Xs[u * LPx + min(tx + 16 * j, P - 1)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = tx + 16 * j;
        if (p < P) y[(row0 + t) * P + p] = acc[i][j];
      }
    }
    __syncthreads();  // before the next tile overwrites Ss
  }

  // State: B scaled by the decay to the chunk's end, then (L, N)^T . (L, P).
  for (int i = tid; i < L * N; i += kThreads) {
    const int r = i / N, n = i % N;
    Bs[r * LN + n] *= expf(la_end - la[r]);
  }
  __syncthreads();
  float st[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) st[i][j] = 0.f;
  for (int u = 0; u < L; ++u) {
    float bv[8], xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) bv[i] = Bs[u * LN + min(ty + 16 * i, N - 1)];
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = Xs[u * LPx + min(tx + 16 * j, P - 1)];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] = fmaf(bv[i], xv[j], st[i][j]);
  }
  float* out = states + blk * N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = tx + 16 * j;
      if (p < P) out[n * P + p] = st[i][j];
    }
  }
  if (tid == 0) gates[blk] = expf(la_end);
}

template <typename T>
int launch(const void* xd, const void* loga, const void* B, const void* C, void* y,
           void* states, void* gates, int BH, int S, int L, int N, int P, cudaStream_t stream) {
  const int smem = smem_bytes(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(BH) * (S / L);
  ssd_chunk_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(xd), static_cast<const float*>(loga), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(gates), S, L, N, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of xd, B and C): 0 float32, 1 bfloat16. L must divide S.
extern "C" int ssd_chunk_launch(const void* xd, const void* loga, const void* B, const void* C,
                                void* y, void* states, void* gates, int BH, int S, int L, int N,
                                int P, int dtype, void* stream) {
  if (L < 1 || L > kMax || N < 1 || N > kMax || P < 1 || P > kMax || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, s);
  if (dtype == 1) return launch<__nv_bfloat16>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
