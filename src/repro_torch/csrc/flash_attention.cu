// Flash attention forward (online softmax; causal and/or sliding window;
// grouped-query heads), for Hopper (sm_90a).
//
// Replaces flash_attention_fwd in src/repro/kernels/flash_attention/
// kernel.py. Same function: per (batch, q head) row i of q,
//   o_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j   over the keys j that
//   the mask keeps (causal: j <= i; window W: i - j < W; positions start
// at 0 for both q and k), accumulated in f32; a row with no key kept is
// 0 (the l == 0 -> 1 guard); masked scores are -1e30, not -inf. q head h
// reads kv head h / G (the reference's "b // G" with its (K, G) order).
//
// Bound on this card: operations, at both serving shapes (bf16, causal,
// S = T = 2048): zamba2 (B*H 128, D 64) does 68.8 GFLOP against 134 MB
// of inputs and output, MLA (deepseek-v2-lite, B*H 64, q/k 192 = nope
// 128 + rope 64, v 128) 85.9 GFLOP against 168 MB; at the bf16
// tensor-core peak of 989 TFLOP/s that is 0.0695 and 0.0869 ms (the
// bytes at 3.35 TB/s: 0.040 and 0.050 ms). Only wgmma reaches that rate
// on Hopper, so bf16 runs both products there (the second kernel).
//
// Two kernels; the wrapper (kernels/flash_attention/kernel.py, _path)
// picks one from the dtype, the head dims and the alignment alone:
// - "wgmma": bf16 with D and Dv multiples of 8 up to 256, 16-byte base
//   pointers and strides that are multiples of 8 elements: every
//   attention config of the reference (64, 80, 120, 128, MLA's 192/128)
//   and every layout the model passes.
// - "fp32": f32, which must stay within 2e-5 of the f32 arithmetic, and
//   the bf16 that TMA cannot take (the first kernel).
//
// Design (fp32 cores). The TPU kernel walks a sequential (q block,
// kv block) grid and carries the running max / denominator /
// accumulator in scratch across kv steps. Hopper blocks run in no
// order, so here one block owns one (batch*head, 64-row q tile) and
// loops over the kv tiles inside, from the window's first tile to the
// causal limit (tiles fully outside the mask are never loaded). 256
// threads: four threads per q row; each computes 8 of the 32 scores of
// a kv tile from shared memory (q and k rows padded by one float
// against bank conflicts), the row's max and sum by two xor-shuffles,
// and owns every fourth column of the row's f32 output accumulator in
// registers. Inputs are read through strides (batch, head, sequence;
// unit stride along the head dim), so the model's (B, S, H, D) layout
// needs no copy. The ragged edge (S, T not multiples of the tile) is
// masked here.
//
// C interface (loaded with ctypes): returns cudaGetLastError() of the
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 32;          // kv rows per tile
constexpr int kThreads = 256;    // 4 threads per q row
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;             // element strides; the head dim is unit
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// DVT: accumulator columns per thread (ceil(Dv / 4) rounded up to a
// bucket), so the accumulator stays in registers.
template <typename T, int DVT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int G,
                 int S, int Tn, int D, int Dv, Strides qs, Strides ks,
                 Strides vs, Strides os, bool causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;                         // padded row pitch
  float* Qs = smem;                             // [kBQ][D+1]
  float* Ks = Qs + kBQ * dp;                    // [kBK][D+1]
  float* Vs = Ks + kBK * dp;                    // [kBK][Dv]
  float* Ps = Vs + kBK * Dv;                    // [kBQ][kBK+1]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - blockIdx.x;         // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, t = tid & 3;          // q row, lane in the row
  const int qi = q0 + r;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    Qs[rr * dp + d] = (q0 + rr < S) ? to_f(qb[(q0 + rr) * qs.s + d]) : 0.f;
  }

  // kv range that any row of this tile keeps
  int k_lo = 0, k_hi = Tn;
  if (causal) k_hi = min(Tn, q0 + kBQ);
  if (window) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kBK) * kBK;

  float m = kNegInf, l = 0.f;
  float acc[DVT];
#pragma unroll
  for (int j = 0; j < DVT; ++j) acc[j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                            // Ks/Vs/Ps free
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, d = i - rr * D;
      Ks[rr * dp + d] = (k0 + rr < Tn) ? to_f(kb[(k0 + rr) * ks.s + d]) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int rr = i / Dv, d = i - rr * Dv;
      Vs[i] = (k0 + rr < Tn) ? to_f(vb[(k0 + rr) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // scores of row r against kv rows t, t+4, ..., t+28 of the tile
    float s[kBK / 4];
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * dp;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj)
        s[jj] = fmaf(qv, Ks[(t + 4 * jj) * dp + d], s[jj]);
    }
    float mloc = kNegInf;
    bool keep[kBK / 4];
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const int kj = k0 + t + 4 * jj;
      bool ok = kj < Tn;
      if (causal) ok = ok && qi >= kj;
      if (window) ok = ok && qi - kj < window;
      keep[jj] = ok;
      s[jj] = ok ? s[jj] * scale : kNegInf;
      mloc = fmaxf(mloc, s[jj]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const float p = keep[jj] ? expf(s[jj] - m_new) : 0.f;
      Ps[r * (kBK + 1) + t + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();                            // Ps complete

    const float* prow = Ps + r * (kBK + 1);
#pragma unroll
    for (int j = 0; j < DVT; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = prow[kk];
      const float* vrow = Vs + kk * Dv;
#pragma unroll
      for (int j = 0; j < DVT; ++j) {
        const int c = t + 4 * j;
        if (c < Dv) acc[j] = fmaf(p, vrow[c], acc[j]);
      }
    }
  }

  if (qi < S) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int j = 0; j < DVT; ++j) {
      const int c = t + 4 * j;
      if (c < Dv) from_f(orow + c, acc[j] * inv);
    }
  }
}

template <typename T, int DVT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int Tn, int D, int Dv, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * Dv + kBQ * (kBK + 1));
  auto kern = flash_fwd_kernel<T, DVT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / K, S, Tn, D, Dv,
      qs, ks, vs, os, causal != 0, window, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on wgmma, fed by TMA: the "wgmma" path ----
//
// FlashAttention-3's forward shape. One block owns one (batch*head,
// 128-row q tile), longest causal rows first, and three warpgroups: two
// consumers of 64 q rows each (wgmma's M) and a producer, which hands
// most of its registers to the consumers (setmaxnreg) and whose thread 0
// brings the Q tile once and then K and V tiles into a two-stage ring by
// TMA (cp.async.bulk.tensor; 4-D maps over (head dim, sequence, head,
// batch) built from the wrapper's strides; 128-byte swizzle; 64
// head-dim columns a box). Loads complete on mbarriers: one for Q, and
// per stage a "full" barrier each for K and V and a "free" barrier each
// on which all 256 consumer threads arrive once they are done with that
// K or V. TMA's out-of-bounds zero fill covers a ragged S or T and pads
// D and Dv up to a multiple of 64 (120 -> 128): no load is masked.
//
// Per kv tile i, each consumer warpgroup
// - issues S = Q K^T of tile i + 1 (wgmma m64nBNk16, both operands
//   K-major in shared memory; HD / 16 k-steps: 12 at D 192, 4 at D 64);
// - rescales O while that runs, then issues O += P V of tile i: P of
//   tile i, rounded once to bf16 in registers, is the register A operand
//   of wgmma m64nHDVk16 (S's accumulator layout is the A layout: no
//   shuffle); V is the shared B operand read MN-major through wgmma's
//   transpose bit (no transpose of V anywhere);
// - runs the online softmax of tile i + 1 on S's accumulator registers
//   in f32 while the tensor cores do P V: a row sits in the four lanes of
//   a quad (two xor-shuffles for its max; its sum is reduced once, at the
//   end), exp2 with scale * log2(e) folded in. Only tiles that cross the
//   causal diagonal, the window's edge or the end of T are masked; tiles
//   wholly outside the mask are never loaded.
// P is rounded to bf16 once, one pass over P V as in FlashAttention-2/3
// (no second pass over its bf16 remainder): the card's error with one
// pass stays inside the bf16 tolerance at every case (PERF.md). The epilogue divides by l (l == 0 -> 1) and stores bf16
// pairs through the output's strides.
//
// Tiles come from the head dims at compile time: HD, HDV = D, Dv rounded
// up to 64. While S of the next tile is in flight, S (BN / 2 registers a
// thread), P (BN / 4) and O (HDV / 2) are all live, and ptxas keeps the
// consumers near 168 registers, so the kv tile BN is 128 only for
// HDV 64 (zamba2: 128 live) and 64 otherwise (MLA's 192/128: 112 live;
// Q 48 KB + 2 x (24 + 16) KB of shared memory). HDV 192 spills 48 bytes
// and HDV 256 about 600 (ptxas -v); no served config has them.
constexpr int kWBQ = 128;        // q rows per block (two warpgroups x 64)
constexpr int kWThreads = 384;   // two consumer warpgroups + a producer one
constexpr int kWConsumers = 256;
constexpr int kWStages = 2;      // K/V ring depth
// setmaxnreg: 168 registers a thread at launch (65536 / 384); the
// producer gives 128 x (168 - 24) to the consumers, 256 x (240 - 168)
constexpr int kWProducerRegs = 24;
constexpr int kWConsumerRegs = 240;

template <int HD, int HDV>
struct WgTile {
  static constexpr int kBN = HDV <= 64 ? 128 : 64;     // kv rows a tile
  static constexpr int kQ = kWBQ * HD * 2;          // bytes of each tile
  static constexpr int kK = kBN * HD * 2;
  static constexpr int kV = kBN * HDV * 2;
  static constexpr int kBars = 8 * (1 + 4 * kWStages);
  // tiles 1024-aligned (the 128-byte swizzle's period); + alignment slack
  static constexpr int kSmem = kQ + kWStages * (kK + kV) + kBars + 1024;
};




__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}



// One warpgroup's view of its 64 rows; this thread holds rows qi0 and
// qi1 = qi0 + 8, and of each 8 columns of S and O the pair 2t, 2t + 1.
struct Rows {
  int qi0, qi1, r_lo, t;
  float m0, m1, l0, l1;    // running max (raw score), this lane's sum
};

// The online softmax of one kv tile on S's accumulator: masks the tile
// if it crosses the causal diagonal, the window's edge or the end of T,
// moves the running max, turns sc into p = exp(scale (s - max)) (in
// f32) and returns the factors (a0, a1) that rescale O's two rows.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], Rows& r,
                                             int k0, int Tn, bool causal,
                                             int window, float scale_log2,
                                             float& a0, float& a1) {
  const bool edge = k0 + BN > Tn || (causal && k0 + BN - 1 > r.r_lo) ||
                    (window && r.r_lo + 63 - k0 >= window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int kj = k0 + (j >> 2) * 8 + 2 * r.t + (j & 1);
      const int qi = (j & 2) ? r.qi1 : r.qi0;
      bool ok = kj < Tn;
      if (causal) ok = ok && qi >= kj;
      if (window) ok = ok && qi - kj < window;
      if (!ok) sc[j] = -INFINITY;
    }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    if (j & 2) mx1 = fmaxf(mx1, sc[j]);
    else mx0 = fmaxf(mx0, sc[j]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // a row with no key kept yet keeps max -inf: exponents taken from 0
  const float mb0 = (mx0 == -INFINITY ? 0.f : mx0) * scale_log2;
  const float mb1 = (mx1 == -INFINITY ? 0.f : mx1) * scale_log2;
  a0 = ex2(r.m0 * scale_log2 - mb0);                // -inf -> 0
  a1 = ex2(r.m1 * scale_log2 - mb1);
  r.m0 = mx0;
  r.m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const float p = ex2(fmaf(sc[j], scale_log2, (j & 2) ? -mb1 : -mb0));
    sc[j] = p;
    if (j & 2) ps1 += p;
    else ps0 += p;
  }
  r.l0 = r.l0 * a0 + ps0;
  r.l1 = r.l1 * a1 + ps1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// P in bf16 as wgmma's register A operand: S's accumulator layout is
// the A layout, 16 columns (4 registers) a k-step
template <int BN>
__device__ __forceinline__ void to_a(const float (&sc)[BN / 2],
                                     uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pa[kk][q] = pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kWThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int H, int G, int S,
                       int Tn, int Dv, Strides os, bool causal, int window,
                       float scale_log2) {
  using Cfg = WgTile<HD, HDV>;
  constexpr int BN = Cfg::kBN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + Cfg::kQ;                 // + stage * kK
  const uint32_t sV = sK + kWStages * Cfg::kK;      // + stage * kV
  // barriers: Q; then per stage K full, V full, K free, V free
  const uint32_t bar_q = sV + kWStages * Cfg::kV;
  const auto bar = [&](int kind, int s) {
    return bar_q + 8 * (1 + kind * kWStages + s);
  };
  enum { kFullK, kFullV, kFreeK, kFreeV };

  const int n_qt = (S + kWBQ - 1) / kWBQ;
  const int qt = n_qt - 1 - blockIdx.x;             // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qt * kWBQ;
  int k_lo = 0, k_hi = Tn;                          // keys any row keeps
  if (causal) k_hi = min(Tn, q0 + kWBQ);
  if (window) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(bar(kFullK, s), 1);
      mbar_init(bar(kFullV, s), 1);
      mbar_init(bar(kFreeK, s), kWConsumers);
      mbar_init(bar(kFreeV, s), kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform as ptxas sees it (a shuffle from lane 0), so
  // that each role's code is allocated its setmaxnreg count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kWConsumers / 128) {                  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kWProducerRegs));
    if (threadIdx.x == kWConsumers) {
      mbar_expect_tx(bar_q, Cfg::kQ);
      for (int c = 0; c < HD / 64; ++c)
        tma_load(sQ + c * kWBQ * 128, &tq, bar_q, c * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWStages, k0 = k_lo + i * BN;
        const uint32_t free_ph = (i / kWStages - 1) & 1;
        if (i >= kWStages) mbar_wait(bar(kFreeK, s), free_ph);
        mbar_expect_tx(bar(kFullK, s), Cfg::kK);
        for (int c = 0; c < HD / 64; ++c)
          tma_load(sK + s * Cfg::kK + c * BN * 128, &tk, bar(kFullK, s),
                   c * 64, k0, kh, b);
        if (i >= kWStages) mbar_wait(bar(kFreeV, s), free_ph);
        mbar_expect_tx(bar(kFullV, s), Cfg::kV);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(sV + s * Cfg::kV + c * BN * 128, &tv, bar(kFullV, s),
                   c * 64, k0, kh, b);
      }
    }
  } else {                                          // a consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kWConsumerRegs));
    const int wg = warp >> 2, wq = warp & 3;
    Rows r;
    r.t = lane & 3;
    r.r_lo = q0 + wg * 64;
    r.qi0 = r.r_lo + wq * 16 + (lane >> 2);
    r.qi1 = r.qi0 + 8;
    r.m0 = r.m1 = -INFINITY;
    r.l0 = r.l1 = 0.f;
    const uint32_t sQw = sQ + wg * 64 * 128;
    float oacc[HDV / 2], sc[BN / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < HDV / 2; ++j) oacc[j] = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sc[j] = 0.f;
    float a0, a1;

    // S = Q K^T of tile i into sc (issued, not waited for)
    const auto issue_qk = [&](int i) {
      const int s = i % kWStages;
      mbar_wait(bar(kFullK, s), (i / kWStages) & 1);
      const uint64_t dq = sw128_desc(sQw, 16, 1024);
      const uint64_t dk = sw128_desc(sK + s * Cfg::kK, 16, 1024);
      pin(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // k-step kk: box kk / 4, 32 bytes (16 columns) a step inside it;
        // descriptors count 16-byte units
        const uint32_t off = (kk & 3) * 2;
        Wgmma<BN>::ss(sc, dq + (kk >> 2) * (kWBQ * 8) + off,
                      dk + (kk >> 2) * (BN * 8) + off, kk > 0);
      }
      wg_commit();
    };

    // O += P V of tile i from pa (issued, not waited for)
    const auto issue_pv = [&](int i) {
      const int s = i % kWStages;
      mbar_wait(bar(kFullV, s), (i / kWStages) & 1);
      const uint64_t dv = sw128_desc(sV + s * Cfg::kV, BN * 128, 1024);
      pin(oacc);
      pin(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)          // 16 kv rows a step
        Wgmma<HDV>::rs(oacc, pa[kk], dv + kk * 128);
      wg_commit();
    };
    const auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < HDV / 2; ++j) oacc[j] *= (j & 2) ? a1 : a0;
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      issue_qk(0);
      wg_wait<0>();
      pin(sc);
      mbar_arrive(bar(kFreeK, 0));
      softmax_tile<BN>(sc, r, k_lo, Tn, causal, window, scale_log2, a0, a1);
      to_a<BN>(sc, pa);
      // Per tile i: issue S of tile i + 1, rescale O while it runs, issue
      // O += P V of tile i; the softmax of tile i + 1 runs while the
      // tensor cores do P V. The loop body has no branch around a wgmma,
      // so none is serialized.
      for (int i = 0; i + 1 < n_tiles; ++i) {
        issue_qk(i + 1);
        rescale_o();
        issue_pv(i);
        wg_wait<1>();                               // S of tile i + 1
        pin(sc);
        mbar_arrive(bar(kFreeK, (i + 1) % kWStages));
        softmax_tile<BN>(sc, r, k_lo + (i + 1) * BN, Tn, causal, window,
                         scale_log2, a0, a1);
        wg_wait<0>();                               // P V of tile i
        pin(oacc);
        pin(pa);
        mbar_arrive(bar(kFreeV, i % kWStages));
        to_a<BN>(sc, pa);
      }
      rescale_o();
      issue_pv(n_tiles - 1);
      wg_wait<0>();
      pin(oacc);
      pin(pa);
      mbar_arrive(bar(kFreeV, (n_tiles - 1) % kWStages));
    }

    float l0 = r.l0, l1 = r.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    __nv_bfloat16* o0 = o + b * os.b + h * os.h + (long long)r.qi0 * os.s;
    __nv_bfloat16* o1 = o + b * os.b + h * os.h + (long long)r.qi1 * os.s;
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      const int c = n * 8 + 2 * r.t;
      if (c >= Dv) continue;
      if (r.qi0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(
            oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
      if (r.qi1 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(
            oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
    }
  }
}


// A bf16 (batch, head, seq, dim) tensor read through its strides, as
// a 4-D map (dim, seq, head, batch) of 64 x rows boxes, 128-byte swizzle,
// zeros outside.
int make_map(CUtensorMap* map, const void* ptr, int dim, int seq, int heads,
             int batch, Strides st, int rows) {
  const cuuint64_t sizes[4] = {(cuuint64_t)dim, (cuuint64_t)seq,
                               (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return tma_map_bf16(map, ptr, 4, sizes, strides, box);
}

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int K, int S, int Tn, int D, int Dv, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal, int window,
                 float scale, cudaStream_t stream) {
  using Cfg = WgTile<HD, HDV>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, S, H, B, qs, kWBQ);
  if (err == 0) err = make_map(&tk, k, D, Tn, K, B, ks, Cfg::kBN);
  if (err == 0) err = make_map(&tv, v, Dv, Tn, K, B, vs, Cfg::kBN);
  if (err != 0) return err;
  auto kern = flash_fwd_wgmma_kernel<HD, HDV>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kWBQ - 1) / kWBQ, B * H);
  kern<<<grid, kWThreads, Cfg::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, H, H / K, S, Tn, Dv, os, causal != 0,
      window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_wgmma_dv(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int K, int S, int Tn, int D, int Dv,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  switch ((Dv + 63) / 64) {
    case 1:
      return launch_wgmma<HD, 64>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                  vs, os, causal, window, scale, stream);
    case 2:
      return launch_wgmma<HD, 128>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                   vs, os, causal, window, scale, stream);
    case 3:
      return launch_wgmma<HD, 192>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                   vs, os, causal, window, scale, stream);
    default:
      return launch_wgmma<HD, 256>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                   vs, os, causal, window, scale, stream);
  }
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int S, int Tn, int D, int Dv,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1:
      return dispatch_wgmma_dv<64>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                   vs, os, causal, window, scale, stream);
    case 2:
      return dispatch_wgmma_dv<128>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs,
                                    ks, vs, os, causal, window, scale, stream);
    case 3:
      return dispatch_wgmma_dv<192>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs,
                                    ks, vs, os, causal, window, scale, stream);
    default:
      return dispatch_wgmma_dv<256>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs,
                                    ks, vs, os, causal, window, scale, stream);
  }
}

// What the wgmma path needs of a tensor: a 16-byte base pointer and
// strides that are multiples of 8 elements (16 bytes).
bool tma_ok(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.s % 8 == 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int K, int S, int Tn, int D, int Dv, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int window,
             float scale, cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 16>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                         causal, window, scale, stream);
  if (Dv <= 128)
    return launch<T, 32>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                         causal, window, scale, stream);
  return launch<T, 64>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                       causal, window, scale, stream);
}

}  // namespace

// q (B, H, S, D), k (B, K, Tn, D), v (B, K, Tn, Dv), o (B, H, S, Dv), each
// given by its (batch, head, sequence) element strides with a unit stride
// along the last dim; H % K == 0; D, Dv <= 256. dtype: 0 float32,
// 1 bfloat16 (all four tensors alike). path, as the wrapper's _path
// chose it: 0 the fp32-core kernel, 1 wgmma + TMA (bf16, D, Dv
// multiples of 8, tensors as tma_ok wants).
// A path that does not take these inputs returns cudaErrorInvalidValue
// and launches nothing.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int path, int B, int H, int K, int S, int Tn, int D, int Dv,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D > 256 || Dv > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (path == 0) {
    if (dtype == 0)
      return dispatch<float>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs,
                             os, causal, window, scale, st);
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                   vs, os, causal, window, scale, st);
  }
  if (path == 1 && dtype == 1 && D % 8 == 0 && Dv % 8 == 0 &&
      tma_ok(q, qs) && tma_ok(k, ks) && tma_ok(v, vs))
    return dispatch_wgmma(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                          causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
