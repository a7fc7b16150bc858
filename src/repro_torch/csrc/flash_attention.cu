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
// Bound on this card: at the serving shape (B*H = 128, S = T = 2048,
// D = 64, causal, bf16) the two products are 69 GFLOP against 67 MB of
// inputs and output, so operations, not bytes, bound it. bf16 with head
// dims <= 128 (every GQA config of the reference) therefore runs the two
// products on the tensor cores (mma.sync, below); f32, which must stay
// within 2e-5 of the f32 arithmetic, and wider heads run them on the
// fp32 cores (the first kernel). MLA's bf16 prefill (deepseek-v2-lite:
// q/k head dim 192 = nope 128 + rope 64, v 128) is such a wider head and
// takes the fp32-core path. wgmma + TMA is a later change.
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
#include <stdint.h>

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


// ---- bf16 on the tensor cores: mma.sync.m16n8k16, f32 accumulation ----
//
// Same schedule, one block per (batch*head, 64-row q tile), a loop over
// 64-row kv tiles; four warps, each owning 16 q rows. S = Q K^T comes
// from mma with Q's fragments held in registers for the whole kv loop;
// the online softmax runs on S's accumulator fragments (a row's scores
// spread over the four lanes of a quad: two xor-shuffles); O += P V
// feeds P straight from those fragments. P is split into a bf16 high
// part and a bf16 remainder, two mma's, so the product keeps ~16 bits
// of P's mantissa: the result stays as close to the f32 arithmetic as
// the fp32-core path, instead of moving by P's bf16 rounding (2^-9).
// V is staged transposed in shared memory so that its B fragments are
// 32-bit loads. Rows of 8 extra bf16 keep the quads' shared loads on
// distinct banks. Head dims are padded with zeros to HD (64 or 128).
// Tiles come in by 16-byte loads where the head dims and strides are
// multiples of 8 (every config), else value by value.
constexpr int kMBQ = 64;         // q rows per block (4 warps x 16)
constexpr int kMBK = 64;         // kv rows per tile
constexpr int kMThreads = 128;
constexpr int kPad = 8;          // bf16 of padding per shared row

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kMThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int H, int G, int S,
                     int Tn, int D, int Dv, Strides qs, Strides ks,
                     Strides vs, Strides os, bool causal, int window,
                     float scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kP = HD + kPad;                 // Qs / Ks row pitch
  constexpr int kPV = kMBK + kPad;              // Vt row pitch
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kMBQ * kP;
  __nv_bfloat16* Vt = Ks + kMBK * kP;           // [HD][kMBK + kPad]
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  const int n_qt = (S + kMBQ - 1) / kMBQ;
  const int qt = n_qt - 1 - blockIdx.x;         // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qt * kMBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;        // quad row, lane in quad

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  if (vec) {                                    // 16-byte loads, 8 values
    for (int i = tid; i < kMBQ * (HD / 8); i += kMThreads) {
      const int r = i / (HD / 8), d8 = (i - r * (HD / 8)) * 8;
      uint4 v4 = make_uint4(0, 0, 0, 0);
      if (q0 + r < S && d8 < D)
        v4 = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qs.s + d8);
      *reinterpret_cast<uint4*>(Qs + r * kP + d8) = v4;
    }
  } else {
    for (int i = tid; i < kMBQ * HD; i += kMThreads) {
      const int r = i / HD, d = i - r * HD;
      Qs[r * kP + d] = (q0 + r < S && d < D) ? qb[(q0 + r) * qs.s + d] : zero;
    }
  }
  __syncthreads();
  uint32_t qf[HD / 16][4];                      // Q's A fragments
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld32(Qs + r0 * kP + c);
    qf[kk][1] = ld32(Qs + (r0 + 8) * kP + c);
    qf[kk][2] = ld32(Qs + r0 * kP + c + 8);
    qf[kk][3] = ld32(Qs + (r0 + 8) * kP + c + 8);
  }
  const int qi0 = q0 + r0, qi1 = qi0 + 8;       // this lane's two rows

  int k_lo = 0, k_hi = Tn;
  if (causal) k_hi = min(Tn, q0 + kMBQ);
  if (window) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kMBK) * kMBK;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kMBK) {
    __syncthreads();                            // Ks / Vt free
    if (vec) {
      for (int i = tid; i < kMBK * (HD / 8); i += kMThreads) {
        const int j = i / (HD / 8), d8 = (i - j * (HD / 8)) * 8;
        const bool in = k0 + j < Tn;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (in && d8 < D)
          kv = *reinterpret_cast<const uint4*>(kb + (k0 + j) * ks.s + d8);
        if (in && d8 < Dv)
          vv = *reinterpret_cast<const uint4*>(vb + (k0 + j) * vs.s + d8);
        *reinterpret_cast<uint4*>(Ks + j * kP + d8) = kv;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[(d8 + e) * kPV + j] = ve[e];
      }
    } else {
      for (int i = tid; i < kMBK * HD; i += kMThreads) {
        const int j = i / HD, d = i - j * HD;
        const bool in = k0 + j < Tn;
        Ks[j * kP + d] = (in && d < D) ? kb[(k0 + j) * ks.s + d] : zero;
        Vt[d * kPV + j] = (in && d < Dv) ? vb[(k0 + j) * vs.s + d] : zero;
      }
    }
    __syncthreads();

    float s[kMBK / 8][4];
#pragma unroll
    for (int n = 0; n < kMBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * kP + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                 ld32(kr), ld32(kr + 8));
      }
    }

    // mask, scale, online softmax (rows qi0: e = 0, 1; qi1: e = 2, 3)
    float mloc[2] = {kNegInf, kNegInf};
    uint64_t keep = 0;
#pragma unroll
    for (int n = 0; n < kMBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const int qi = e < 2 ? qi0 : qi1;
        bool ok = kj < Tn;
        if (causal) ok = ok && qi >= kj;
        if (window) ok = ok && qi - kj < window;
        if (ok) keep |= 1ull << (n * 4 + e);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        mloc[e >> 1] = fmaxf(mloc[e >> 1], s[n][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 1));
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 2));
      const float m_new = fmaxf(m[r], mloc[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kMBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (keep >> (n * 4 + e)) & 1ull
                            ? expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P = hi + lo in bf16
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      const float* pa = s[2 * kk];
      const float* pb = s[2 * kk + 1];
      const float pv[4][2] = {{pa[0], pa[1]}, {pa[2], pa[3]},
                              {pb[0], pb[1]}, {pb[2], pb[3]}};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(pv[r][0]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(pv[r][1]);
        hi[r] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
        lo[r] = pack_bf16(pv[r][0] - __bfloat162float(h0),
                          pv[r][1] - __bfloat162float(h1));
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * kPV + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(acc[n], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(acc[n], lo[0], lo[1], lo[2], lo[3], b0, b1);
      }
    }
  }

  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
  __nv_bfloat16* o0 = o + b * os.b + h * os.h + (long long)qi0 * os.s;
  __nv_bfloat16* o1 = o + b * os.b + h * os.h + (long long)qi1 * os.s;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n * 8 + 2 * t + e;
      if (c >= Dv) continue;
      if (qi0 < S) o0[c] = __float2bfloat16_rn(acc[n][e] * inv0);
      if (qi1 < S) o1[c] = __float2bfloat16_rn(acc[n][2 + e] * inv1);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int Tn, int D, int Dv, Strides qs,
               Strides ks, Strides vs, Strides os, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
      (size_t)((kMBQ + kMBK) * (HD + kPad) + HD * (kMBK + kPad));
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto ok8 = [](const void* p, Strides st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
           st.h % 8 == 0 && st.s % 8 == 0;
  };
  const bool vec = D % 8 == 0 && Dv % 8 == 0 && ok8(q, qs) && ok8(k, ks) &&
                   ok8(v, vs);
  const dim3 grid((S + kMBQ - 1) / kMBQ, B * H);
  kern<<<grid, kMThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, H / K, S, Tn, D, Dv,
      qs, ks, vs, os, causal != 0, window, scale, vec);
  return (int)cudaGetLastError();
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
// 1 bfloat16 (all four tensors alike). bf16 with D, Dv <= 128 (every
// GQA config of the reference) takes the tensor-core path; f32, and bf16
// with a wider head (MLA's prefill, D 192), the fp32-core path.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int K, int S, int Tn, int D, int Dv, const long long* strides,
    int causal, int window, float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                           causal, window, scale, (cudaStream_t)stream);
  if (D <= 64 && Dv <= 64)
    return launch_mma<64>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                          causal, window, scale, (cudaStream_t)stream);
  if (D <= 128 && Dv <= 128)
    return launch_mma<128>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks, vs, os,
                           causal, window, scale, (cudaStream_t)stream);
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, S, Tn, D, Dv, qs, ks,
                                 vs, os, causal, window, scale,
                                 (cudaStream_t)stream);
}
