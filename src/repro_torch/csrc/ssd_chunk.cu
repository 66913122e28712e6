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
// L = 128, N = P = 64, bf16 inputs) the pass reads 0.20 GB (xd, B, C in bf16,
// loga) and writes 0.20 GB (y and the states in float32), 0.405 GB in all, for
// 13.0 GFLOP of causal products: 0.121 ms of memory traffic against 0.013 ms
// at the bf16 tensor-core peak. B and C arrive repeated over the heads of a
// group (the reference's layout); reading them once per group is later work.
//
// bf16 inputs: one block of 4 warps per (bh, chunk), on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 accumulators). B, C and xd stay
// bf16 in shared memory (cp.async, 16 bytes a thread; rows padded by 16
// bytes, so ldmatrix is free of bank conflicts): ~55 KB at the zamba2 shapes,
// four blocks an SM. Warp 0 forms la as a shuffle scan. Each warp owns two
// 16-row bands of queries (t and 7 - t, so the causal work is balanced) and
// walks only the 16-key tiles at or below its diagonal: S = C B^T by mma,
// the decay exp(min(la_t - la_u, 0)) and the causal mask applied to the
// accumulators, then y += S xd with S taken straight from the accumulators
// as the A operand. To keep float32 accuracy, each decayed score is split
// into a bf16 high part and a bf16 low part (s = hi + lo + O(2^-17 |s|)) and
// both are multiplied, in two mma: bf16 products are exact in the float32
// accumulator. The states multiply (B * exp(la_L - la))^T by xd the same way
// (B through ldmatrix.trans, scaled and split in registers). Why not wgmma:
// the products take ~0.03 ms at mma.sync rates, below the bytes bound, so the
// bytes in flight and the occupancy set the time, not the product instruction.
// Measured (NVIDIA H100 80GB HBM3, 700 W, tools/kernel_variants.py): 0.169 ms at
// the zamba2 shape; without the split 0.161 ms but 5.4e-3 off (the gate is
// 1e-4); kChunks = 2 (two chunks a block, both loaded before the first
// chunk's products) 0.244 ms, since it halves the blocks an SM.
//
// float32 inputs: one block of 256 threads per (bh, chunk) on the CUDA
// cores. B, C and xd of the chunk go to shared memory as float32 (rows padded
// to an odd stride, so the 16 lanes reading 16 rows hit 16 banks); thread 0
// forms la as a sequential prefix sum, in the order of the plain version's
// cumsum. The L x L score matrix never exists whole: 64 rows at a time go to
// shared memory (each thread computes a 4 x 8 register tile of C B^T times
// the decay, zero above the diagonal), and the same threads then form those
// 64 rows of y, summing only over the columns below the tile's last row (the
// rest are 0). Then B is scaled in place by exp(la_L - la) and each thread
// accumulates an up-to 8 x 8 tile of the state. Shared memory: 4 (2 L (N+1)
// + L (P+1) + L + 64 (L+1)) bytes, 130 KB at the zamba2 shapes.
//
// Every exp is of a number <= 0, as in the reference: the decay clamps
// la_t - la_u at 0, and la decreases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---- bf16 inputs: tensor cores ----------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr bool kSplit = true;  // hi + lo parts of each float32 operand (false: hi only)
constexpr int kChunks = 1;     // consecutive chunks a block, all loads issued first (1 or 2)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8) += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 out.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values (x the lower column) as bf16 pairs: hi = bf16(x),
// lo = bf16(x - hi), so x = hi + lo to about 2^-17 of |x|.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// D: N and P padded up to one of 16, 32, 64, 128. Rows are D + 8 elements
// apart (16 bytes of padding: the 8 rows of an ldmatrix hit 8 bank groups).
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// One chunk's shared memory: C, B and xd in bf16, la and exp(la_L - la).
template <int D>
__host__ __device__ int chunk_smem_bytes(int L) {
  const int Lp = (L + 15) & ~15;
  return 3 * Lp * row_stride<D>() * 2 + 2 * Lp * 4;
}

// Rows [0, L) of a chunk's (L, W) bf16 block into dst (row stride LD), the
// columns [W, D) and rows [L, Lp) as zeros.
template <int D>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* src, int L, int Lp, int W, bool vec) {
  constexpr int LD = row_stride<D>();
  const bf16 zero = __float2bfloat16(0.f);
  if (vec) {  // W % 8 == 0 and src 16-byte aligned
    const int cpr = W / 8;
    for (int i = threadIdx.x; i < L * cpr; i += kThreads) {
      const int r = i / cpr, k = i - r * cpr;
      cp_async16(dst + r * LD + k * 8, src + static_cast<long long>(r) * W + k * 8);
    }
    for (int i = threadIdx.x; i < L * (D - W); i += kThreads) {
      const int r = i / (D - W), k = i - r * (D - W);
      dst[r * LD + W + k] = zero;
    }
  } else {
    for (int i = threadIdx.x; i < L * D; i += kThreads) {
      const int r = i / D, k = i - r * D;
      dst[r * LD + k] = k < W ? src[static_cast<long long>(r) * W + k] : zero;
    }
  }
  for (int i = threadIdx.x; i < (Lp - L) * D; i += kThreads) {
    const int r = L + i / D, k = i % D;
    dst[r * LD + k] = zero;
  }
}

// Inclusive scan of one chunk's loga by one warp: each lane sums up to 4
// consecutive steps, then a shuffle scan over the lanes' totals.
__device__ __forceinline__ void scan_loga(float* la, const float* loga, int L, int lane) {
  const int K = (L + 31) / 32;
  float part[4];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = lane * K + i;
    if (i < K && t < L) run += loga[t];
    part[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = lane * K + i;
    if (i < K && t < L) la[t] = excl + part[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 / kChunks : 2 / kChunks)
ssd_chunk_tc_kernel(const bf16* __restrict__ xd, const float* __restrict__ loga,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    float* __restrict__ y, float* __restrict__ states,
                    float* __restrict__ gates, int S, int L, int N, int P, long long total, int vec) {
  constexpr int LD = row_stride<D>();
  constexpr int KC = D / 16;  // 16-wide steps over N (and pairs of 8-wide P tiles)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int Lp = (L + 15) & ~15;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int c = lane & 3;   // accumulator columns 2c, 2c + 1
  const int nc = S / L;
  const long long first = static_cast<long long>(blockIdx.x) * kChunks;  // = bh * nc + chunk

  // Every chunk's loads go out first, one cp.async group a chunk.
  for (int k = 0; k < kChunks; ++k) {
    const long long blk = first + k;
    if (blk < total) {
      bf16* Cs = reinterpret_cast<bf16*>(tc_smem + k * chunk_smem_bytes<D>(L));
      const long long row0 = (blk / nc) * S + static_cast<long long>(blk % nc) * L;
      load_block<D>(Cs, Cm + row0 * N, L, Lp, N, vec);
      load_block<D>(Cs + Lp * LD, Bm + row0 * N, L, Lp, N, vec);
      load_block<D>(Cs + 2 * Lp * LD, xd + row0 * P, L, Lp, P, vec);
      if (warp == k % kWarps) scan_loga(reinterpret_cast<float*>(Cs + 3 * Lp * LD), loga + row0, L, lane);
    }
    cp_async_commit();
  }

  for (int k = 0; k < kChunks; ++k) {
    if (k + 1 < kChunks) {
      cp_async_wait<(kChunks > 1 ? 1 : 0)>();  // chunk k's group; the next may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long blk = first + k;
    if (blk >= total) break;  // the same for the whole block
    const long long row0 = (blk / nc) * S + static_cast<long long>(blk % nc) * L;
    bf16* Cs = reinterpret_cast<bf16*>(tc_smem + k * chunk_smem_bytes<D>(L));  // [Lp][LD]
    bf16* Bs = Cs + Lp * LD;                                                  // [Lp][LD]
    bf16* Xs = Bs + Lp * LD;                                                  // [Lp][LD]
    float* la = reinterpret_cast<float*>(Xs + Lp * LD);                       // [Lp]
    float* to_end = la + Lp;                                                  // [Lp] exp(la_L - la)
    const float la_end = la[L - 1];
    for (int t = tid; t < Lp; t += kThreads) {
      to_end[t] = t < L ? expf(la_end - la[t]) : 0.f;
      if (t >= L) la[t] = la_end;
    }
    __syncthreads();

    // y: warp w owns the 16-row bands w and 7 - w.
    const int T = Lp / 16;
    for (int pass = 0; pass < 2; ++pass) {
      const int mt = pass == 0 ? warp : 2 * kWarps - 1 - warp;
      if (mt >= T) continue;
      const int t0 = mt * 16;
      uint32_t cf[KC][4];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ldsm_x4(cf[kc], Cs + (t0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
      float acc[2 * KC][4];
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const int ta = t0 + g, tb = ta + 8;
      const float la_a = la[ta], la_b = la[tb];
      for (int kb = 0; kb <= mt; ++kb) {
        const int u0 = kb * 16;
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t bf[4];
          ldsm_x4(bf, Bs + (u0 + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 + ((lane >> 3) & 1) * 8);
          mma(sc[0], cf[kc], bf[0], bf[1]);
          mma(sc[1], cf[kc], bf[2], bf[3]);
        }
        // Decay and causal mask on the accumulators: element e of tile h is
        // row (e < 2 ? ta : tb), key u0 + 8h + 2c + (e & 1).
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? ta : tb;
            const int u = u0 + 8 * h + 2 * c + (e & 1);
            const float lt = e < 2 ? la_a : la_b;
            sc[h][e] = u <= t ? sc[h][e] * expf(fminf(lt - la[u], 0.f)) : 0.f;
          }
        }
        uint32_t ah[4], al[4];
        split2(sc[0][0], sc[0][1], ah[0], al[0]);
        split2(sc[0][2], sc[0][3], ah[1], al[1]);
        split2(sc[1][0], sc[1][1], ah[2], al[2]);
        split2(sc[1][2], sc[1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < KC; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xs + (u0 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
          mma(acc[2 * np], ah, xf[0], xf[1]);
          mma(acc[2 * np + 1], ah, xf[2], xf[3]);
          if (kSplit) {
            mma(acc[2 * np], al, xf[0], xf[1]);
            mma(acc[2 * np + 1], al, xf[2], xf[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) {
        const int p = 8 * j + 2 * c;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = half ? tb : ta;
          if (t >= L) continue;
          float* out = y + (row0 + t) * P + p;
          const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
          if (p + 1 < P && !(P & 1)) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            if (p < P) out[0] = v0;
            if (p + 1 < P) out[1] = v1;
          }
        }
      }
    }

    // states = (B * to_end)^T xd: warp w owns the 16-row bands w, w + 4, ... of N.
    for (int mt = warp; mt < KC; mt += kWarps) {
      const int n0 = mt * 16;
      float acc[2 * KC][4];
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kb = 0; kb < T; ++kb) {
        const int u0 = kb * 16;
        uint32_t bf[4];
        ldsm_x4_t(bf, Bs + (u0 + (lane & 7) + ((lane >> 4) << 3)) * LD + n0 + ((lane >> 3) & 1) * 8);
        // A element (state row, step u): registers 0 and 1 hold steps
        // u0 + 2c, u0 + 2c + 1; registers 2 and 3 the same 8 steps later.
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = u0 + 2 * c + (r >= 2 ? 8 : 0);
          const float2 v = unpack2(bf[r]);
          split2(v.x * to_end[u], v.y * to_end[u + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < KC; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xs + (u0 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
          mma(acc[2 * np], ah, xf[0], xf[1]);
          mma(acc[2 * np + 1], ah, xf[2], xf[3]);
          if (kSplit) {
            mma(acc[2 * np], al, xf[0], xf[1]);
            mma(acc[2 * np + 1], al, xf[2], xf[3]);
          }
        }
      }
      float* out = states + blk * N * P;
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) {
        const int p = 8 * j + 2 * c;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nn = n0 + g + 8 * half;
          if (nn >= N) continue;
          const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
          if (p + 1 < P && !(P & 1)) {
            *reinterpret_cast<float2*>(out + nn * P + p) = make_float2(v0, v1);
          } else {
            if (p < P) out[nn * P + p] = v0;
            if (p + 1 < P) out[nn * P + p + 1] = v1;
          }
        }
      }
    }
    if (tid == 0) gates[blk] = expf(la_end);
  }
}

template <int D>
int launch(const void* xd, const void* loga, const void* B, const void* C, void* y, void* states,
           void* gates, int BH, int S, int L, int N, int P, cudaStream_t stream) {
  const int smem = kChunks * chunk_smem_bytes<D>(L);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = N % 8 == 0 && P % 8 == 0 && aligned(xd) && aligned(B) && aligned(C);
  const long long total = static_cast<long long>(BH) * (S / L);
  const long long blocks = (total + kChunks - 1) / kChunks;
  ssd_chunk_tc_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(xd), static_cast<const float*>(loga), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(gates), S, L, N, P, total, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* xd, const void* loga, const void* B, const void* C, void* y, void* states,
                void* gates, int BH, int S, int L, int N, int P, cudaStream_t stream) {
  const int d = N > P ? N : P;
  if (d <= 16) return launch<16>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, stream);
  if (d <= 32) return launch<32>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, stream);
  if (d <= 64) return launch<64>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, stream);
  return launch<128>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, stream);
}

}  // namespace tc

}  // namespace

// dtype (of xd, B and C): 0 float32, 1 bfloat16. L must divide S.
extern "C" int ssd_chunk_launch(const void* xd, const void* loga, const void* B, const void* C,
                                void* y, void* states, void* gates, int BH, int S, int L, int N,
                                int P, int dtype, void* stream) {
  if (L < 1 || L > kMax || N < 1 || N > kMax || P < 1 || P > kMax || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xd, loga, B, C, y, states, gates, BH, S, L, N, P, s);
  if (dtype == 1) return tc::launch_bf16(xd, loga, B, C, y, states, gates, BH, S, L, N, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
