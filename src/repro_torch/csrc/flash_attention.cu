// Forward GQA flash attention: online softmax over key/value tiles, causal
// and/or sliding-window masks, queries aligned to the end of the KV stream.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (launched by flash_attention_pallas). Plain version: repro_torch/kernels/
// flash_attention/ref.py::mha_ref.
//
// Layout: q (B*Hq, Sq, D), k/v (B*Hkv, Sk, D), o like q. Query head row bh
// reads KV row bh / group (group = Hq / Hkv): GQA by indexing, the repeated KV
// is never formed. D is 32, 64 or 128 (no padding to 128, which the TPU
// wrapper needs for its lanes). Softmax statistics and the accumulator are
// float32 in both paths below.
//
// Bound on the H100: operations. At zamba2-1.2b's prefill (B = 2, 32 heads,
// S = 4096, D = 64, causal) the two products take ~1.37e11 flops on the
// attended pairs against ~134 MB of q, k, v and o: ~0.14 ms at the bf16
// tensor-core peak (989 TFLOP/s), against ~0.04 ms of memory traffic. Only
// the tensor cores can approach it, so bfloat16 has its own kernel:
//
// bfloat16: flash_attention_bf16_kernel, on Hopper's tensor cores (wgmma) fed
// by the Tensor Memory Accelerator (TMA). One block per (bh, 192-query tile),
// four warpgroups: three consumers own 64 query rows each, and one thread of
// the producer warpgroup issues TMA loads (the Q tile once, then K and V
// tiles of BK keys into a 2-stage ring in shared memory, each arrival on an
// mbarrier; a K stage is handed back when all twelve consumer warps have its
// S = Q.K^T, a V stage when they have its P.V product). setmaxnreg gives the
// producer's registers to the consumers (160 each). Tiles are 128- or
// 64-byte swizzled by the TMA, as the wgmma descriptors expect (hopper.cuh).
// Per key tile a consumer warpgroup runs
//   S = Q.K^T     wgmma m64nBKk16, Q and K from shared memory, float32 out;
//   softmax       in registers: a row's scores live in one quad of threads, so
//                 its max takes two shuffles; exp2 with scale * log2(e)
//                 folded in; the row sum stays per thread until the end;
//   O += P.V      P cast to bf16 in registers is wgmma's A operand (the
//                 accumulator layout of S is the register layout of A), V
//                 is the MN-major B operand from shared memory.
// Two overlaps keep the tensor cores busy while the threads do softmax: in a
// warpgroup, tile i + 1's S and tile i's P.V are issued together and tile
// i + 1's softmax runs while P.V does; across warpgroups, a ring of named
// barriers makes them take turns at issuing, so one's products run during
// the others' softmax. Key tiles wholly past the causal frontier or outside
// the window are never loaded; only the diagonal and edge tiles are masked.
// Query tiles are cut from the end of the sequence, so the ragged one is the
// lightest. Rows before 0 and keys past Sk arrive as zeros (a 3-D tensor map
// per operand, so a tile never reads the next head) and are masked or not
// stored. The latest query tiles, which have the most keys under a causal
// mask, go first.
//
// float32: flash_attention_kernel, on the CUDA cores (float32 FMAs): the
// first kernel of the port, kept for float32, where TF32 tensor cores would
// change the numbers. One block of 256 threads per (bh, 64-query tile); the
// query tile stays in shared memory; the loop walks 64-key tiles of K and V
// through shared memory. Each thread holds a 4x4 block of the score tile
// (rows ty + 16i, columns tx + 16j), so a row's 64 scores sit in the 16
// lanes of one half-warp and its max and sum reduce with four shuffles. P
// goes through shared memory into the P.V product, where each thread owns 4
// rows and D/16 columns of the output accumulator in registers. Key tiles
// wholly outside the causal frontier or the window are skipped.
//
// Masked scores are -inf and give p = 0. A row that no key may attend keeps
// l = 0 and comes out 0, as in the reference kernel (kernel.py, the guards on
// m_new and l); with Sq <= Sk and a causal mask, or a window >= 1, every
// query row keeps at least its own position, so such a row cannot occur.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---- bfloat16: wgmma + TMA ---------------------------------------------------


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Column panel width (elements) and swizzle span (bytes) of a D-wide tile.
template <int D> struct Panels {
  static constexpr int PC = D >= 64 ? 64 : 32;
  static constexpr int SPAN = PC * 2;
  static constexpr int NP = D / PC;
};

// kWG consumer warpgroups of 64 query rows each, and one producer
// warpgroup (one thread of which issues the loads). setmaxnreg moves the
// producer's registers to the consumers.
constexpr int kWG = 3;
constexpr int kBQ2 = 64 * kWG;  // query rows per block
constexpr int kBf16Threads = 128 * (kWG + 1);
constexpr int kConsumerWarps = 4 * kWG;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = ((65536 / 128 - kProducerRegs) / kWG) / 8 * 8;

constexpr int kStages = 2;  // K and V tiles in flight

template <int D, int BK>
constexpr int bf16_smem_bytes() {
  return 1024 + (kBQ2 + 2 * kStages * BK) * D * 2;  // Q, then the K and V ring; 1 KB for alignment
}

template <int D, int BK>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int group,
                            int Sq, int Sk, float scale_log2, int causal, int window) {
  using P = Panels<D>;
  constexpr int QPANEL = kBQ2 * P::SPAN;
  constexpr int KPANEL = BK * P::SPAN;
  constexpr int QBYTES = P::NP * QPANEL;
  constexpr int KBYTES = P::NP * KPANEL;  // one stage of K (and of V)
  constexpr int SR = BK / 2;              // score registers a thread
  constexpr int OR = D / 2;               // output registers a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
  unsigned char* Qs = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + QBYTES;            // [kStages][KBYTES]
  unsigned char* Vs = Ks + kStages * KBYTES;  // [kStages][KBYTES]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // Query tiles are cut from the end, so a ragged tile is the first (under
  // a causal mask the lightest); its rows below 0 arrive as zeros and are
  // not stored. The latest tiles, the heaviest, are scheduled first.
  const int q0 = Sq - (static_cast<int>(blockIdx.y) + 1) * kBQ2;
  const int off = Sk - Sq;  // query row r sits at absolute position r + off
  // Keys any row of this tile may attend: tiles of [kt0, k_end).
  const int q_last = q0 + kBQ2 - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  const int kt0 = (k_begin / BK) * BK;
  const int ntiles = k_end > kt0 ? (k_end - kt0 + BK - 1) / BK : 0;

  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], kConsumerWarps);
      hopper::mbar_init(&v_empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kWG) {  // the producer warpgroup; one thread issues every load
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kWG) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::mbar_expect_tx(&q_full, QBYTES);
      for (int p = 0; p < P::NP; ++p) hopper::tma_load_3d(Qs + p * QPANEL, &tq, &q_full, p * P::PC, q0, bh);
      const int kvh = bh / group;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        const uint32_t last_use = (i / kStages - 1) & 1;  // the phase of the stage's previous use
        const int kt = kt0 + i * BK;
        if (i >= kStages) hopper::mbar_wait(&k_empty[s], last_use);
        hopper::mbar_expect_tx(&k_full[s], KBYTES);
        for (int p = 0; p < P::NP; ++p)
          hopper::tma_load_3d(Ks + s * KBYTES + p * KPANEL, &tk, &k_full[s], p * P::PC, kt, kvh);
        if (i >= kStages) hopper::mbar_wait(&v_empty[s], last_use);
        hopper::mbar_expect_tx(&v_full[s], KBYTES);
        for (int p = 0; p < P::NP; ++p)
          hopper::tma_load_3d(Vs + s * KBYTES + p * KPANEL, &tv, &v_full[s], p * P::PC, kt, kvh);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows. Thread (warp w, lane l) holds rows
  // 16w + l/4 (h = 0) and that + 8 (h = 1) at columns 8j + 2(l%4) + c of
  // each accumulator, at register 4j + 2h + c.
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r_lo = 64 * wg + 16 * warp + (lane >> 2);  // row within the tile, h = 0
  const int cq = 2 * (lane & 3);
  const int wq_first = q0 + 64 * wg + off;
  const int wq_last = wq_first + 63;
  const unsigned char* Qw = Qs + 64 * wg * P::SPAN;

  float acc[OR], sc[SR], corr[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < OR; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SR; ++i) sc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  // S = Q.K^T for tile i, issued and committed, not waited for.
  auto issue_s = [&](int i) {
    hopper::mbar_wait(&k_full[i % kStages], (i / kStages) & 1);
    __syncwarp();
    const unsigned char* Kt = Ks + (i % kStages) * KBYTES;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = (kk * 16) / P::PC;
      const int b = ((kk * 16) % P::PC) * 2;  // bytes into the swizzle span
      const uint64_t da = hopper::make_desc(Qw + p * QPANEL + b, 16, 8 * P::SPAN, P::SPAN);
      const uint64_t db = hopper::make_desc(Kt + p * KPANEL + b, 16, 8 * P::SPAN, P::SPAN);
      hopper::Wgmma<BK>::ss(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };

  // Online softmax of tile i in place: sc becomes p, m and l move on, corr
  // is the factor the accumulator still has to take.
  auto softmax = [&](int i) {
    const int kt = kt0 + i * BK;
    // Masks, only on tiles that cross the frontier, the window or Sk.
    const bool edge = kt + BK > Sk || (causal && kt + BK - 1 > wq_first) || (window > 0 && kt <= wq_last - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = kt + 8 * j + cq + c;
            const int qpos = q0 + r_lo + 8 * h + off;
            bool keep = kpos < Sk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) sc[4 * j + 2 * h + c] = -CUDART_INF_F;
          }
    }
    // Four partial maxima and sums a row: short dependency chains.
    float mx4[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx4[h][u] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx4[h][j % 4] = fmaxf(mx4[h][j % 4], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    float mx[2], mneg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(fmaxf(mx4[h][0], mx4[h][1]), fmaxf(mx4[h][2], mx4[h][3]));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      const float m_use = (m_new == -CUDART_INF_F) ? 0.f : m_new;  // nothing kept yet: p = 0, corr = 0
      corr[h] = ex2((m[h] - m_use) * scale_log2);
      mneg[h] = -m_use * scale_log2;
      m[h] = m_new;
    }
    float rs4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ex2(fmaf(sc[4 * j + 2 * h], scale_log2, mneg[h]));
        const float p1 = ex2(fmaf(sc[4 * j + 2 * h + 1], scale_log2, mneg[h]));
        sc[4 * j + 2 * h] = p0;
        sc[4 * j + 2 * h + 1] = p1;
        rs4[h][j % 4] += p0 + p1;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ((rs4[h][0] + rs4[h][1]) + (rs4[h][2] + rs4[h][3]));
  };

  // The accumulator's rescale, and p in bf16 as wgmma's A fragments (the
  // accumulator layout of S is the register layout of A, 16 keys a step).
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] *= corr[h];
        acc[4 * j + 2 * h + 1] *= corr[h];
      }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) pa[j / 2][(j % 2) * 2 + h] = pack_bf16(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
  };

  // O += P.V for tile i, issued and committed, not waited for.
  auto issue_pv = [&](int i) {
    hopper::mbar_wait(&v_full[i % kStages], (i / kStages) & 1);
    __syncwarp();
    const unsigned char* Vt = Vs + (i % kStages) * KBYTES;
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = hopper::make_desc(Vt + kk * 16 * P::SPAN, KPANEL, 8 * P::SPAN, P::SPAN);
      hopper::Wgmma<D>::rs(acc, pa[kk], db);
    }
    hopper::wgmma_commit();
  };

  // The warpgroups take turns at the tensor cores, in a ring of named
  // barriers 1..kWG: one issues its products while the others do their
  // softmax. Warpgroup 0 goes first; the last one lets it, and hands the turn
  // on after every issue but its last.
  const int turns = ntiles + 1;
  int turn = 0;
  auto my_turn = [&]() { hopper::named_sync(1 + wg, 256); };
  auto pass_turn = [&]() {
    if (wg < kWG - 1 || ++turn < turns) hopper::named_arrive(1 + (wg + 1) % kWG, 256);
  };
  if (wg == kWG - 1 && ntiles > 0) hopper::named_arrive(1, 256);

  // Software pipeline in the warpgroup: tile i + 1's S = Q.K^T and tile i's
  // O += P.V run on the tensor cores while the threads do tile i + 1's
  // softmax.
  hopper::mbar_wait(&q_full, 0);
  if (ntiles > 0) {
    my_turn();
    issue_s(0);
    pass_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
    softmax(0);
    rescale_and_pack();
  }
  // The last tile is peeled off, so every S issued in the loop is waited
  // for unconditionally (the compiler then keeps the two products in flight).
  for (int i = 0; i + 1 < ntiles; ++i) {
    my_turn();
    issue_s(i + 1);
    issue_pv(i);
    pass_turn();
    hopper::wgmma_wait<1>();  // S of tile i + 1 is done; P.V of tile i may run on
    hopper::fence_regs(sc);
    if (lane == 0) hopper::mbar_arrive(&k_empty[(i + 1) % kStages]);
    softmax(i + 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    if (lane == 0) hopper::mbar_arrive(&v_empty[i % kStages]);
    rescale_and_pack();
  }
  if (ntiles > 0) {
    my_turn();
    issue_pv(ntiles - 1);
    pass_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = q0 + r_lo + 8 * h;
    if (r < 0) continue;
    const float inv = 1.f / ((l[h] == 0.f) ? 1.f : l[h]);
    __nv_bfloat16* orow = o + (static_cast<long long>(bh) * Sq + r) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, D) bf16 matrix per head, heads stacked: dims (D, rows, heads);
// boxes of one column panel by box_rows rows of one head.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int rows, int heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Panels<D>::PC), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Panels<D>::SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int group, int Sq, int Sk,
                float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map<D>(&tq, q, Sq, BH, kBQ2);
  if (!err) err = make_map<D>(&tk, k, Sk, BH / group, BK);
  if (!err) err = make_map<D>(&tv, v, Sk, BH / group, BK);
  if (err) return err;
  constexpr int smem = bf16_smem_bytes<D, BK>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_bf16_kernel<D, BK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(BH, (Sq + kBQ2 - 1) / kBQ2);
  flash_attention_bf16_kernel<D, BK><<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), group, Sq, Sk, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window < 1 means no window. dtype: 0 float32 (CUDA cores), 1 bfloat16
// (tensor cores; q, k, v 16-byte aligned).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int group, int Sq, int Sk, int D, float scale,
                                      int causal, int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, BH, group, Sq, Sk, D, scale, causal, window, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return launch_bf16<32, 128>(q, k, v, o, BH, group, Sq, Sk, scale, causal, window, s);
    case 64: return launch_bf16<64, 128>(q, k, v, o, BH, group, Sq, Sk, scale, causal, window, s);
    case 128: return launch_bf16<128, 64>(q, k, v, o, BH, group, Sq, Sk, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
