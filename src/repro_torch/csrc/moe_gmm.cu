// Grouped expert FFN of the MoE layers, for Hopper (sm_90a).
//
// Replaces moe_gmm in src/repro/kernels/moe_gmm/kernel.py. Same
// function: per expert e, on its capacity bucket x_e (C, d),
//   y_e = (act(x_e Wg_e) o (x_e Wu_e)) Wd_e
// with f32 arithmetic and y in x's dtype; act is silu or the tanh
// approximation of gelu (jax.nn.gelu), both with IEEE expf / tanhf.
// Empty capacity slots are zero rows and are computed like any other.
//
// Bound on this card: at deepseek-v2-lite-16b's prefill shape (E 64,
// C 960, d 2048, F 1408, bf16) the three products are 1.06 TFLOP
// against 1.61 GB of inputs and output, so operations bound it (1.08 ms
// at 989 TFLOP/s). At its decode shape (C 8) the 1.1 GB of expert
// weights bound it (0.33 ms).
//
// Design. The TPU kernel keeps a (rows, d) f32 accumulator in VMEM
// across F tiles, so the (C, F) hidden never reaches memory. At d = 2048
// and 64 rows that accumulator is 512 KB, more than the 227 KB of
// shared memory of a Hopper SM. Here two kernels run back to back on
// the stream:
//   1. gate/up: h = act(x Wg) o (x Wu) into an (E, C, F) f32 workspace;
//   2. down:    y = h Wd.
// Each is a tiled product: one block owns one (expert, row tile, column
// tile) and loops over the contracted dim in slabs staged through
// shared memory. Blocks walk the column tiles fastest, so the blocks in
// flight share their row tiles and weight slabs in L2.
// - x bf16: the products run on the tensor cores (mma.sync.m16n8k16,
//   bf16 in, f32 accumulate). An operand that is f32 at the source (h;
//   the weights when the params are f32) is split into a bf16 high part
//   and a bf16 remainder, and the product takes hi*hi + hi*lo + lo*hi,
//   so it keeps ~16 bits of mantissa instead of bf16's 8.
//   * bf16 weights and C > 16 (the serving prefill): tiles stream into
//     shared memory by cp.async, three slabs in flight, fragments by
//     ldmatrix; h is kept in the workspace already split (third kernel
//     family below).
//   * otherwise (f32 weights; C <= 16, the decode shape, where the
//     weights' bytes are the cost; dims not multiples of 8): the next
//     slab's global loads are issued into registers before the current
//     slab is multiplied, and split there. Row tiles are 64 rows, or 16
//     when C <= 16.
// - x f32: the products run on the fp32 cores, fmaf in order over the
//   contracted dim, so the result stays within 1e-5 of the f32
//   arithmetic (the reference's tolerance); bf16 weights are widened
//   exactly.
// The path follows the dtypes, never a switch. Rows, columns and the
// contracted dim are all guarded (zero-filled), so no dim has to be a
// multiple of a tile (the reference's sweep has E 3, C 40, d 96, F 192).
//
// C interface (loaded with ctypes): returns the first non-zero
// cudaGetLastError() of the two launches, else 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// silu (act 0) or jax.nn.gelu's tanh approximation (act 1)
__device__ __forceinline__ float act_f(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));
  const float c = 0.7978845608028654f;          // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
}

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// ---- x f32: the fp32 cores ----
//
// 256 threads as 16 x 16; a block owns a 64 x 64 output tile (x2 when
// gated: the gate and up products share the A slab) and each thread a
// 4 x 4 sub-tile interleaved by 16, so a warp's shared reads are
// broadcasts (A) or consecutive (B). A is staged transposed, padded by
// one float against bank conflicts.
constexpr int kFBM = 64, kFBN = 64, kFBK = 16, kFThreads = 256;

// A (E, M, K) f32, B / B2 (E, K, N) TB. GATED: out (E, M, N) f32 =
// act(A B) o (A B2); else out = A B.
template <bool GATED, typename TB>
__global__ void __launch_bounds__(kFThreads)
gmm_f32_kernel(const float* __restrict__ A, const TB* __restrict__ B,
               const TB* __restrict__ B2, float* __restrict__ out, int M,
               int N, int K, int act) {
  constexpr int kNB = GATED ? 2 : 1;
  __shared__ float As[kFBK][kFBM + 1];
  __shared__ float Bs[kNB][kFBK][kFBN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* Ae = A + (size_t)e * M * K;
  const TB* Be[kNB];
  Be[0] = B + (size_t)e * K * N;
  if (GATED) Be[kNB - 1] = B2 + (size_t)e * K * N;

  float acc[kNB][4][4];
#pragma unroll
  for (int o = 0; o < kNB; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    __syncthreads();                            // slabs free
#pragma unroll
    for (int j = 0; j < kFBM * kFBK / kFThreads; ++j) {
      const int i = tid + j * kFThreads;
      const int r = i / kFBK, k = i % kFBK;
      As[k][r] = (m0 + r < M && k0 + k < K)
                     ? Ae[(size_t)(m0 + r) * K + k0 + k] : 0.f;
    }
#pragma unroll
    for (int o = 0; o < kNB; ++o)
#pragma unroll
      for (int j = 0; j < kFBK * kFBN / kFThreads; ++j) {
        const int i = tid + j * kFThreads;
        const int k = i / kFBN, n = i % kFBN;
        Bs[o][k][n] = (k0 + k < K && n0 + n < N)
                          ? to_f(Be[o][(size_t)(k0 + k) * N + n0 + n])
                          : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int o = 0; o < kNB; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[o][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[o][i][j] = fmaf(a[i], b, acc[o][i][j]);
        }
    }
  }

  float* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= N) continue;
      oe[(size_t)r * N + c] =
          GATED ? act_f(acc[0][i][j], act) * acc[kNB - 1][i][j]
                : acc[0][i][j];
    }
  }
}

template <bool GATED, typename TB>
int launch_f32(const float* A, const TB* B, const TB* B2, float* out,
               int E, int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, E);
  gmm_f32_kernel<GATED, TB><<<grid, kFThreads, 0, stream>>>(
      A, B, B2, out, M, N, K, act);
  return (int)cudaGetLastError();
}

// ---- x bf16: the tensor cores, mma.sync.m16n8k16 ----
//
// 128 threads (4 warps); a block owns a BM x 64 output tile (x2 when
// gated) and loops over the contracted dim in 32-wide slabs. Shared
// tiles are bf16 (hi, and lo for an operand that is f32 at the source):
// A as [row][k], B transposed as [col][k], both with k contiguous so
// every fragment is a 32-bit shared load (the fragment layout of the
// flash kernel), rows padded by 8 bf16 so a quad's loads fall on
// distinct banks. Warps tile the block 2 x 2 (BM 64) or 1 x 4 (BM 16).
constexpr int kBN = 64, kBK = 32, kThreads = 128;
constexpr int kPitch = kBK + 8;                 // bf16 per shared row

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 tile at (r, c) of a [row][k] shared tile:
// rows r and r + 8, k pairs at c and c + 8
__device__ __forceinline__ void load_a(uint32_t (&f)[4],
                                       const __nv_bfloat16* base, int r,
                                       int c) {
  f[0] = ld32(base + r * kPitch + c);
  f[1] = ld32(base + (r + 8) * kPitch + c);
  f[2] = ld32(base + r * kPitch + c + 8);
  f[3] = ld32(base + (r + 8) * kPitch + c + 8);
}

// Two consecutive-k values -> packed bf16 hi (and the remainder lo).
template <bool SPLIT>
__device__ __forceinline__ void put2(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                     float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  if (SPLIT)
    *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(
        v0 - __low2float(h), v1 - __high2float(h));
}

// A (E, M, K) TA, B / B2 (E, K, N) TB. GATED: out (E, M, N) f32 =
// act(A B) o (A B2); else out = A B in TO.
template <int BM, bool GATED, typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
gmm_mma_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
               const TB* __restrict__ B2, TO* __restrict__ out, int M,
               int N, int K, int act) {
  constexpr bool kSA = IsF32<TA>::value, kSB = IsF32<TB>::value;
  constexpr int kNB = GATED ? 2 : 1;
  constexpr int WM = BM >= 32 ? 2 : 1;          // warps along rows
  constexpr int WN = 4 / WM;                    // warps along columns
  constexpr int MI = BM / WM / 16;              // 16-row mma tiles / warp
  constexpr int NI = kBN / WN / 8;              // 8-col mma tiles / warp
  constexpr int kAP = BM * kBK / 2 / kThreads;  // A pairs per thread
  constexpr int kBP = kBK / 2 * kBN / kThreads; // B pairs per thread
  static_assert(kAP >= 1 && MI >= 1 && NI >= 1, "tile shape");

  __shared__ __align__(16) __nv_bfloat16 As[kSA ? 2 : 1][BM * kPitch];
  __shared__ __align__(16) __nv_bfloat16 Bs[kNB][kSB ? 2 : 1][kBN * kPitch];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const TA* Ae = A + (size_t)e * M * K;
  const TB* Be[kNB];
  Be[0] = B + (size_t)e * K * N;
  if (GATED) Be[kNB - 1] = B2 + (size_t)e * K * N;

  // registers holding the next slab: A pairs along k of one row; B pairs
  // along k of one column (consecutive threads on consecutive columns)
  float ra[kAP][2], rb[kNB][kBP][2];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kAP; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 2), k = k0 + 2 * (i % (kBK / 2));
      const bool in = m0 + r < M;
      const TA* p = Ae + (size_t)(m0 + r) * K + k;
      ra[j][0] = (in && k < K) ? to_f(p[0]) : 0.f;
      ra[j][1] = (in && k + 1 < K) ? to_f(p[1]) : 0.f;
    }
#pragma unroll
    for (int o = 0; o < kNB; ++o)
#pragma unroll
      for (int j = 0; j < kBP; ++j) {
        const int i = tid + j * kThreads;
        const int c = n0 + i % kBN, k = k0 + 2 * (i / kBN);
        const bool in = c < N;
        const TB* p = Be[o] + (size_t)k * N + c;
        rb[o][j][0] = (in && k < K) ? to_f(p[0]) : 0.f;
        rb[o][j][1] = (in && k + 1 < K) ? to_f(p[N]) : 0.f;
      }
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kAP; ++j) {
      const int i = tid + j * kThreads;
      const int off = (i / (kBK / 2)) * kPitch + 2 * (i % (kBK / 2));
      put2<kSA>(As[0] + off, As[kSA ? 1 : 0] + off, ra[j][0], ra[j][1]);
    }
#pragma unroll
    for (int o = 0; o < kNB; ++o)
#pragma unroll
      for (int j = 0; j < kBP; ++j) {
        const int i = tid + j * kThreads;
        const int off = (i % kBN) * kPitch + 2 * (i / kBN);
        put2<kSB>(Bs[o][0] + off, Bs[o][kSB ? 1 : 0] + off, rb[o][j][0],
                  rb[o][j][1]);
      }
  };

  float acc[kNB][MI][NI][4];
#pragma unroll
  for (int o = 0; o < kNB; ++o)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[o][mi][ni][q] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  for (int s = 0; s < nk; ++s) {
    __syncthreads();                            // previous slab consumed
    stage();
    __syncthreads();
    if (s + 1 < nk) load((s + 1) * kBK);        // in flight during the mma's
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ah[MI][4], al[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = (wm * MI + mi) * 16 + g;
        const int c = kk * 16 + 2 * t;
        load_a(ah[mi], As[0], r, c);
        if (kSA) load_a(al[mi], As[kSA ? 1 : 0], r, c);
      }
#pragma unroll
      for (int o = 0; o < kNB; ++o)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int n = (wn * NI + ni) * 8 + g;
          const __nv_bfloat16* bh = Bs[o][0] + n * kPitch + kk * 16 + 2 * t;
          const uint32_t bh0 = ld32(bh), bh1 = ld32(bh + 8);
          uint32_t bl0 = 0, bl1 = 0;
          if (kSB) {
            const __nv_bfloat16* bl =
                Bs[o][kSB ? 1 : 0] + n * kPitch + kk * 16 + 2 * t;
            bl0 = ld32(bl);
            bl1 = ld32(bl + 8);
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[o][mi][ni], ah[mi], bh0, bh1);
            if (kSB) mma_bf16(acc[o][mi][ni], ah[mi], bl0, bl1);
            if (kSA) mma_bf16(acc[o][mi][ni], al[mi], bh0, bh1);
          }
        }
    }
  }

  // accumulator fragment: rows g and g + 8, columns 2t and 2t + 1
  TO* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + (wm * MI + mi) * 16 + g + (q >> 1) * 8;
        const int c = n0 + (wn * NI + ni) * 8 + 2 * t + (q & 1);
        if (r >= M || c >= N) continue;
        const float v = GATED ? act_f(acc[0][mi][ni][q], act) *
                                    acc[kNB - 1][mi][ni][q]
                              : acc[0][mi][ni][q];
        store(oe + (size_t)r * N + c, v);
      }
}

template <int BM, bool GATED, typename TA, typename TB, typename TO>
int launch_mma(const TA* A, const TB* B, const TB* B2, TO* out, int E,
               int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, E);
  gmm_mma_kernel<BM, GATED, TA, TB, TO><<<grid, kThreads, 0, stream>>>(
      A, B, B2, out, M, N, K, act);
  return (int)cudaGetLastError();
}

// ---- x and weights bf16, C > 16: cp.async pipeline + ldmatrix ----
//
// The serving path's case (bf16 activations and params, prefill-sized
// buckets). Every operand is bf16 at the source, so tiles go straight
// from device memory to shared memory by 16-byte cp.async, three slabs
// in flight, and fragments come from ldmatrix (B's transposed). The
// workspace holds h as a bf16 high part and a bf16 remainder (the same
// bytes as f32), so the down product reads both halves by cp.async too
// and takes hi*Wd + lo*Wd: the ~16 bits of mantissa of the register
// path. 256 threads (8 warps as 4 x 2); a block owns a 128 x 64 output
// tile (x2 when gated), each warp 32 x 32. Needs d, F multiples of 8
// and 16-byte aligned tensors (every config; the caller checks).
constexpr int kPM = 128, kPN = 64, kPK = 32, kPStages = 3, kPThreads = 256;
constexpr int kPAP = kPK + 8;                   // A row pitch (bf16)
constexpr int kPBP = kPN + 8;                   // B row pitch (bf16)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// GATED: A (E, M, K) = x, B / B2 (E, K, N) = Wg / Wu; out / out_lo get
// the high part and the remainder of act(A B) o (A B2). Else: A / A2 =
// the two halves of h, B = Wd; out = A B + A2 B (out_lo unused).
template <bool GATED>
__global__ void __launch_bounds__(kPThreads)
gmm_pipe_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ A2,
                const __nv_bfloat16* __restrict__ B,
                const __nv_bfloat16* __restrict__ B2,
                __nv_bfloat16* __restrict__ out,
                __nv_bfloat16* __restrict__ out_lo, int M, int N, int K,
                int act) {
  constexpr int kNA = GATED ? 1 : 2, kNB = GATED ? 2 : 1;
  constexpr int MI = 2, NI = 4;                 // warp tile 32 x 32
  constexpr int kATile = kPM * kPAP, kBTile = kPK * kPBP;
  constexpr int kStage = kNA * kATile + kNB * kBTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const size_t a_off = (size_t)e * M * K, b_off = (size_t)e * K * N;
  const __nv_bfloat16* As[2] = {A + a_off, GATED ? A + a_off : A2 + a_off};
  const __nv_bfloat16* Bs[2] = {B + b_off, GATED ? B2 + b_off : B + b_off};

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* sa = smem + stage * kStage;
#pragma unroll
    for (int a = 0; a < kNA; ++a)
#pragma unroll
      for (int j = 0; j < kPM * kPK / 8 / kPThreads; ++j) {
        const int c = tid + j * kPThreads;
        const int r = c / (kPK / 8), kc = (c % (kPK / 8)) * 8;
        const bool in = m0 + r < M && k0 + kc < K;
        cp_async16(sa + a * kATile + r * kPAP + kc,
                   in ? As[a] + (size_t)(m0 + r) * K + k0 + kc : As[a], in);
      }
    __nv_bfloat16* sb = sa + kNA * kATile;
#pragma unroll
    for (int b = 0; b < kNB; ++b)
#pragma unroll
      for (int j = 0; j < kPK * kPN / 8 / kPThreads; ++j) {
        const int c = tid + j * kPThreads;
        const int r = c / (kPN / 8), nc = (c % (kPN / 8)) * 8;
        const bool in = k0 + r < K && n0 + nc < N;
        cp_async16(sb + b * kBTile + r * kPBP + nc,
                   in ? Bs[b] + (size_t)(k0 + r) * N + n0 + nc : Bs[b], in);
      }
  };

  float acc[kNB][MI][NI][4];
#pragma unroll
  for (int o = 0; o < kNB; ++o)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[o][mi][ni][q] = 0.f;

  const int nk = (K + kPK - 1) / kPK;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < nk) load(s, s * kPK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kPStages - 2>();              // slab kt has landed
    __syncthreads();                            // and slab kt-1 is consumed
    const int pre = kt + kPStages - 1;
    if (pre < nk) load(pre % kPStages, pre * kPK);
    cp_async_commit();
    const __nv_bfloat16* sa = smem + (kt % kPStages) * kStage;
    const __nv_bfloat16* sb = sa + kNA * kATile;
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 16) {
      uint32_t af[kNA][MI][4];
#pragma unroll
      for (int a = 0; a < kNA; ++a)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(af[a][mi], sa + a * kATile +
                                 (wm * 32 + mi * 16 + (lane & 15)) * kPAP +
                                 kk + (lane >> 4) * 8);
#pragma unroll
      for (int b = 0; b < kNB; ++b)
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t bf[4];                       // n blocks 2np, 2np + 1
          ldsm_x4_t(bf, sb + b * kBTile + (kk + (lane & 15)) * kPBP +
                            wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int a = 0; a < kNA; ++a) {
              mma_bf16(acc[b][mi][2 * np], af[a][mi], bf[0], bf[1]);
              mma_bf16(acc[b][mi][2 * np + 1], af[a][mi], bf[2], bf[3]);
            }
        }
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: rows g and g + 8, columns 2t and 2t + 1
  const size_t o_off = (size_t)e * M * N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + wm * 32 + mi * 16 + g + hr * 8;
        const int c = n0 + wn * 32 + ni * 8 + 2 * t;  // N % 8 == 0: c + 1
        if (r >= M || c >= N) continue;                // is in when c is
        const size_t i = o_off + (size_t)r * N + c;
        const float p0 = acc[0][mi][ni][2 * hr];
        const float p1 = acc[0][mi][ni][2 * hr + 1];
        if (GATED) {
          const float v0 = act_f(p0, act) * acc[kNB - 1][mi][ni][2 * hr];
          const float v1 = act_f(p1, act) * acc[kNB - 1][mi][ni][2 * hr + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(out + i) = h;
          store2(out_lo + i, v0 - __low2float(h), v1 - __high2float(h));
        } else {
          store2(out + i, p0, p1);
        }
      }
}

template <bool GATED>
int launch_pipe(const __nv_bfloat16* A, const __nv_bfloat16* A2,
                const __nv_bfloat16* B, const __nv_bfloat16* B2,
                __nv_bfloat16* out, __nv_bfloat16* out_lo, int E, int M,
                int N, int K, int act, cudaStream_t stream) {
  constexpr int kNA = GATED ? 1 : 2, kNB = GATED ? 2 : 1;
  const size_t smem = sizeof(__nv_bfloat16) * kPStages *
                      (kNA * kPM * kPAP + kNB * kPK * kPBP);
  auto kern = gmm_pipe_kernel<GATED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM, E);
  kern<<<grid, kPThreads, smem, stream>>>(A, A2, B, B2, out, out_lo, M, N,
                                          K, act);
  return (int)cudaGetLastError();
}

template <typename TW>
int run(const void* x, const void* wg, const void* wu, const void* wd,
        float* h, void* y, bool x_f32, int E, int C, int d, int F, int act,
        cudaStream_t stream) {
  const TW* g = (const TW*)wg;
  const TW* u = (const TW*)wu;
  const TW* dn = (const TW*)wd;
  int err;
  if (x_f32) {
    err = launch_f32<true, TW>((const float*)x, g, u, h, E, C, F, d, act,
                               stream);
    if (err) return err;
    return launch_f32<false, TW>(h, dn, nullptr, (float*)y, E, C, d, F, act,
                                 stream);
  }
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!IsF32<TW>::value && C > 16 && d % 8 == 0 && F % 8 == 0 && a16(x) &&
      a16(wg) && a16(wu) && a16(wd) && a16(h) && a16(y)) {
    // h's f32 workspace holds the bf16 high parts, then the remainders
    __nv_bfloat16* hh = reinterpret_cast<__nv_bfloat16*>(h);
    __nv_bfloat16* hl = hh + (size_t)E * C * F;
    const __nv_bfloat16* gb = (const __nv_bfloat16*)wg;
    err = launch_pipe<true>(xb, nullptr, gb, (const __nv_bfloat16*)wu, hh,
                            hl, E, C, F, d, act, stream);
    if (err) return err;
    return launch_pipe<false>(hh, hl, (const __nv_bfloat16*)wd, nullptr, yb,
                              nullptr, E, C, d, F, act, stream);
  }
  if (C <= 16) {
    err = launch_mma<16, true>(xb, g, u, h, E, C, F, d, act, stream);
    if (err) return err;
    return launch_mma<16, false>((const float*)h, dn, (const TW*)nullptr,
                                 yb, E, C, d, F, act, stream);
  }
  err = launch_mma<64, true>(xb, g, u, h, E, C, F, d, act, stream);
  if (err) return err;
  return launch_mma<64, false>((const float*)h, dn, (const TW*)nullptr, yb,
                               E, C, d, F, act, stream);
}

}  // namespace

// x (E, C, d), wg / wu (E, d, F), wd (E, F, d), all contiguous; h an
// (E, C, F) f32 workspace; y (E, C, d) in x's dtype. x_dtype / w_dtype:
// 0 float32, 1 bfloat16 (the three weights alike). act: 0 silu, 1 gelu
// (tanh approximation).
extern "C" int moe_gmm(const void* x, const void* wg, const void* wu,
                       const void* wd, void* h, void* y, int x_dtype,
                       int w_dtype, int E, int C, int d, int F, int act,
                       void* stream) {
  if (E > 65535 || x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (w_dtype == 0)
    return run<float>(x, wg, wu, wd, (float*)h, y, x_dtype == 0, E, C, d, F,
                      act, (cudaStream_t)stream);
  return run<__nv_bfloat16>(x, wg, wu, wd, (float*)h, y, x_dtype == 0, E, C,
                            d, F, act, (cudaStream_t)stream);
}
