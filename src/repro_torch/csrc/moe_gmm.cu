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
// weights bound it (0.33 ms at 3.35 TB/s). With the config's own f32
// params the weights are 2.2 GB (0.66 ms at C 8), and the hi / lo
// products below make 7/3 of the work (~2.5 ms at C 960).
//
// Design. The TPU kernel keeps a (rows, d) f32 accumulator in VMEM
// across F tiles, so the (C, F) hidden never reaches memory. At d = 2048
// and 64 rows that accumulator is 512 KB, more than the 227 KB of
// shared memory of a Hopper SM. Here two kernels run back to back on
// the stream:
//   1. gate/up: h = act(x Wg) o (x Wu) into an (E, C, F) workspace;
//   2. down:    y = h Wd.
// Four paths; the wrapper (kernels/moe_gmm/kernel.py, _path) picks one
// from the dtypes, C, d, F and the alignment alone, and the C entry
// refuses a path whose preconditions fail:
// - "wgmma" (bf16 x, C above the stream threshold, d and F multiples
//   of 8, 16-byte aligned tensors): the serving prefill. For
//   operations: wgmma fed by TMA. bf16 weights: a producer warpgroup
//   and two consumer warpgroups, operands from shared memory (below).
//   f32 weights: the weights split hi / lo in registers as wgmma's A
//   operand, h kept as a hi / lo pair (below).
// - "stream" (the same, C at most the threshold): the serving decode.
//   For bytes: the weights, bf16 or f32, stream through shared memory
//   by TMA at close to the card's bandwidth (below).
// - "mma" (bf16 x that TMA cannot take: d or F not multiples of 8,
//   tensors off 16 bytes): mma.sync.m16n8k16 on the tensor cores,
//   operands staged through registers. An operand that is f32 at the
//   source (h; the weights when the params are f32) is split into a
//   bf16 high part and a bf16 remainder, and the product takes hi*hi +
//   hi*lo + lo*hi, so it keeps ~16 bits of mantissa instead of bf16's
//   8. Row tiles are 64 rows, or 16 when C <= 16.
// - "f32" (f32 x): the fp32 cores, fmaf in order over the contracted
//   dim, so the result stays within 1e-5 of the f32 arithmetic (the
//   reference's tolerance); bf16 weights are widened exactly.
// With bf16 weights the two TMA paths round h to bf16 once, as flash
// rounds P: the card's error stays inside the bf16 tolerance (PERF.md
// has the bound and the measured error). With f32 weights they keep h
// as hi + lo, and the other paths keep it in f32. Rows, columns and the
// contracted dim are guarded everywhere (zero-filled by TMA's
// out-of-bounds fill on the TMA paths), so no dim has to be a multiple
// of a tile (the reference's sweep has E 3, C 40, d 96, F 192).
//
// C interface (loaded with ctypes): returns the first non-zero
// cudaGetLastError() of the two launches, else 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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
// ---- bf16 x and weights on wgmma, fed by TMA ----
//
// Tiles come in 128-byte-swizzled TMA boxes of 64 bf16 columns, 8 KB
// for 64 rows. Every operand is read in its natural layout: x and h
// (rows of the contracted dim) are K-major, the weights (E, K, cols)
// MN-major, which wgmma takes through a transpose bit, so nothing is
// transposed anywhere. Loads complete on a "full" mbarrier per stage;
// every consumer thread arrives on the stage's "free" mbarrier once the
// products that read it are done. Each consumer keeps one k-slab of
// products in flight (wgmma.wait_group 1) while the next is issued.
constexpr int kBox = 64 * 128;     // bytes of a box of 64 rows

// A contiguous bf16 (or f32) (outer, rows, inner) tensor as a 3-D map
// of 128-byte x box_rows boxes: 64 bf16 or 32 f32 columns.
int make_map3(CUtensorMap* map, const void* ptr, int inner, int rows,
              int outer, int box_rows, bool f32 = false) {
  const int es = f32 ? 4 : 2;
  const cuuint64_t sizes[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                               (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * es,
                                 (cuuint64_t)rows * inner * es};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)box_rows,
                             1};
  return tma_map(map,
                 f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 ptr, 3, sizes, strides, box);
}

// -> blocks of `kern` the card holds at once, into *out; 0 or a
// cudaError_t
template <typename K>
int resident_blocks(K kern, int threads, int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       threads, smem);
  if (ce != cudaSuccess) return (int)ce;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// The "wgmma" path (prefill). One block owns one (expert, 128-row tile,
// column tile) and three warpgroups: two consumers of 64 rows each
// (wgmma's M) and a producer, which hands its registers to the
// consumers (setmaxnreg) and whose thread 0 keeps the ring full. A
// stage is one 64-deep k-slab: the A box (128 rows of x or h) and the B
// boxes (64 k rows x the tile's columns of Wg and Wu, or of Wd). Per
// slab a consumer issues 4 k-steps of wgmma m64nNk16 per weight, A
// K-major, B MN-major. Gated: 128 columns, and the g and u accumulators
// (2 x 64 f32 a thread) meet in the epilogue as act(g) * u, which is
// stored to h in bf16. Down: 256 columns (128 f32 a thread), so a slab
// brings as many operations per byte through L2 as a gated one.
constexpr int kGRows = 128;
constexpr int kGThreads = 384, kGConsumers = 256;
constexpr int kGProducerRegs = 24, kGConsumerRegs = 240;
constexpr int kGBudget = 200 * 1024;   // bytes of the ring

template <bool GATED>
struct GTile {
  static constexpr int kNW = GATED ? 2 : 1;          // weights
  static constexpr int kCols = GATED ? 128 : 256;    // output columns
  static constexpr int kA = kGRows * 128;            // 16 KB
  static constexpr int kB = (kCols / 64) * kBox;     // 16 / 32 KB a weight
  static constexpr int kStage = kA + kNW * kB;       // 48 KB
  static constexpr int kStages = kGBudget / kStage;  // 4
  static constexpr int kSmem = kStages * kStage + 16 * kStages + 1024;
};

// GATED: A = x (E, M, K), B / B2 = Wg / Wu (E, K, N), out = h (E, M, N)
// = act(A B) o (A B2). Else A = h, B = Wd, out = y = A B. bf16 out.
template <bool GATED>
__global__ void __launch_bounds__(kGThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tb2,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 int act) {
  using T = GTile<GATED>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + T::kStages * T::kStage;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto freed = [&](int s) { return bars + 8 * (T::kStages + s); };
  const int e = blockIdx.z, m0 = blockIdx.y * kGRows;
  const int n0 = blockIdx.x * T::kCols;
  const int nk = (K + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(freed(s), kGConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform as ptxas sees it (a shuffle from lane 0), so
  // that each role's code is allocated its setmaxnreg count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kGConsumers / 128) {                  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kGProducerRegs));
    if (threadIdx.x == kGConsumers) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % T::kStages;
        if (ks >= T::kStages) mbar_wait(freed(s), (ks / T::kStages - 1) & 1);
        const uint32_t st = base + s * T::kStage;
        mbar_expect_tx(full(s), T::kStage);
        tma_load3(st, &ta, full(s), ks * 64, m0, e);
#pragma unroll
        for (int w = 0; w < T::kNW; ++w)
#pragma unroll
          for (int c = 0; c < T::kCols / 64; ++c)
            tma_load3(st + T::kA + w * T::kB + c * kBox, w ? &tb2 : &tb,
                      full(s), n0 + c * 64, ks * 64, e);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kGConsumerRegs));
  float acc[T::kNW][T::kCols / 2];
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % T::kStages;
    mbar_wait(full(s), (ks / T::kStages) & 1);
    const uint32_t st = base + s * T::kStage;
    const uint64_t da = sw128_desc(st + role * 64 * 128, 16, 1024);
    const uint64_t db = sw128_desc(st + T::kA, kBox, 1024);
#pragma unroll
    for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)       // 16 k a step: 32 bytes along A's
#pragma unroll                           // rows, 16 rows (2 KB) of B's
      for (int w = 0; w < T::kNW; ++w)   // boxes; descriptors count 16 B
        Wgmma<T::kCols>::template ss<0, 1>(
            acc[w], da + kk * 2, db + w * (T::kB >> 4) + kk * 128,
            (ks | kk) != 0);
    wg_commit();
    wg_wait<1>();                                   // slab ks - 1 is done
#pragma unroll
    for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
    if (ks > 0) mbar_arrive(freed((ks - 1) % T::kStages));
  }
  wg_wait<0>();
#pragma unroll
  for (int w = 0; w < T::kNW; ++w) pin(acc[w]);

  // accumulator: rows g and g + 8 of the warp's 16, columns 2t, 2t + 1
  // of each 8
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = m0 + role * 64 + warp * 16 + (lane >> 2);
  __nv_bfloat16* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int j = 0; j < T::kCols / 8; ++j) {
    const int c = n0 + j * 8 + 2 * (lane & 3);   // N % 8 == 0: c + 1 is
    if (c >= N) continue;                        // in when c is
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + hr * 8;
      if (r >= M) continue;
      float v0 = acc[0][4 * j + 2 * hr], v1 = acc[0][4 * j + 2 * hr + 1];
      if (GATED) {
        v0 = act_f(v0, act) * acc[T::kNW - 1][4 * j + 2 * hr];
        v1 = act_f(v1, act) * acc[T::kNW - 1][4 * j + 2 * hr + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(oe + (size_t)r * N + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <bool GATED>
int launch_wgmma(const void* a, const void* b, const void* b2, void* out,
                 int E, int M, int N, int K, int act, cudaStream_t stream) {
  using T = GTile<GATED>;
  CUtensorMap ta, tb, tb2;
  int err = make_map3(&ta, a, K, M, E, kGRows);
  if (err == 0) err = make_map3(&tb, b, N, K, E, 64);
  if (err == 0) err = make_map3(&tb2, GATED ? b2 : b, N, K, E, 64);
  if (err != 0) return err;
  auto kern = gmm_wgmma_kernel<GATED>;
  const cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((N + T::kCols - 1) / T::kCols, (M + kGRows - 1) / kGRows,
                  E);
  kern<<<grid, kGThreads, T::kSmem, stream>>>(ta, tb, tb2,
                                              (__nv_bfloat16*)out, M, N, K,
                                              act);
  return (int)cudaGetLastError();
}

// The "stream" path (decode). Bytes bound it: every weight byte is read
// once, so the weights must stream at close to the card's bandwidth.
// The operands are swapped: the weight tile is wgmma's 64-row A operand
// (Wg / Wu / Wd read MN-major), and the bucket's C rows are the narrow
// N side (8 to 64, C rounded up; rows past C are TMA's zeros). So
// out^T (64 columns, N) = W^T (64, K) x^T (K, N). A block is one
// consumer warpgroup and a producer warp; it owns a sequence of
// (expert, 64-column) items, persistent over a grid that fills every SM
// (two blocks an SM), so the producer loads the next item's slabs while
// the consumers finish this one, and the ring (4 to 11 stages, 90 to
// 102 KB) never drains between items.
constexpr int kSThreads = 160;
constexpr int kSBudget = 104 * 1024;   // bytes of the ring: two blocks an SM
constexpr int kStreamMaxC = 64;

template <bool GATED, int N>
struct STile {
  static constexpr int kNW = GATED ? 2 : 1;
  static constexpr int kB = N * 128;                 // x or h: N rows
  static constexpr int kStage = kNW * kBox + kB;
  static constexpr int kStages =
      kSBudget / kStage > 12 ? 12 : kSBudget / kStage;
  static constexpr int kSmem = kStages * kStage + 16 * kStages + 1024;
};

// GATED: W / W2 = Wg / Wu (E, K, M), X = x (E, C, K), out = h (E, C, M)
// = act(X W) o (X W2). Else W = Wd, X = h, out = y = X W. bf16 out.
template <bool GATED, int N>
__global__ void __launch_bounds__(kSThreads, 2)
gmm_stream_kernel(const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tw2,
                  const __grid_constant__ CUtensorMap tx,
                  __nv_bfloat16* __restrict__ out, int E, int C, int M,
                  int K, int act) {
  using T = STile<GATED, N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + T::kStages * T::kStage;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto freed = [&](int s) { return bars + 8 * (T::kStages + s); };
  const int mt = (M + 63) / 64, items = E * mt, nk = (K + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(freed(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                         // the producer warp
    if (threadIdx.x == 128) {
      int it = 0;                                   // slabs so far
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int e = item / mt, m0 = (item % mt) * 64;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % T::kStages;
          if (it >= T::kStages) mbar_wait(freed(s), (it / T::kStages - 1) & 1);
          const uint32_t st = base + s * T::kStage;
          mbar_expect_tx(full(s), T::kStage);
          tma_load3(st, &tw, full(s), m0, ks * 64, e);
          if (GATED) tma_load3(st + kBox, &tw2, full(s), m0, ks * 64, e);
          tma_load3(st + T::kNW * kBox, &tx, full(s), ks * 64, 0, e);
        }
      }
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[T::kNW][N / 2];
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, it += nk) {
    const int e = item / mt, m0 = (item % mt) * 64;
    for (int ks = 0; ks < nk; ++ks) {
      const int s = (it + ks) % T::kStages;
      mbar_wait(full(s), ((it + ks) / T::kStages) & 1);
      const uint32_t st = base + s * T::kStage;
      const uint64_t dw = sw128_desc(st, kBox, 1024);
      const uint64_t dx = sw128_desc(st + T::kNW * kBox, 16, 1024);
#pragma unroll
      for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int w = 0; w < T::kNW; ++w)
          Wgmma<N>::template ss<1, 0>(acc[w], dw + w * (kBox >> 4) + kk * 128,
                                      dx + kk * 2, (ks | kk) != 0);
      wg_commit();
      wg_wait<1>();
#pragma unroll
      for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
      if (ks > 0) mbar_arrive(freed((it + ks - 1) % T::kStages));
    }
    wg_wait<0>();
#pragma unroll
    for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
    mbar_arrive(freed((it + nk - 1) % T::kStages));

    // accumulator (transposed): output columns m0 + warp * 16 + g and
    // + 8, bucket rows 2t, 2t + 1 of each 8
    __nv_bfloat16* oe = out + (size_t)e * C * M;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + warp * 16 + (lane >> 2) + (q >> 1) * 8;
        const int r = j * 8 + 2 * (lane & 3) + (q & 1);
        if (m >= M || r >= C) continue;
        float v = acc[0][4 * j + q];
        if (GATED) v = act_f(v, act) * acc[T::kNW - 1][4 * j + q];
        oe[(size_t)r * M + m] = __float2bfloat16_rn(v);
      }
  }
}

template <bool GATED, int N>
int launch_stream(const void* w, const void* w2, const void* xin, void* out,
                  int E, int C, int M, int K, int act, cudaStream_t stream) {
  using T = STile<GATED, N>;
  CUtensorMap tw, tw2, tx;
  int err = make_map3(&tw, w, M, K, E, 64);
  if (err == 0) err = make_map3(&tw2, GATED ? w2 : w, M, K, E, 64);
  if (err == 0) err = make_map3(&tx, xin, K, C, E, N);
  if (err != 0) return err;
  auto kern = gmm_stream_kernel<GATED, N>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  static int resident = 0;                          // blocks the card holds
  if (resident == 0) {
    err = resident_blocks(kern, kSThreads, T::kSmem, &resident);
    if (err != 0) return err;
  }
  const int items = E * ((M + 63) / 64);
  const int grid = items < resident ? items : resident;
  kern<<<grid, kSThreads, T::kSmem, stream>>>(tw, tw2, tx,
                                              (__nv_bfloat16*)out, E, C, M,
                                              K, act);
  return (int)cudaGetLastError();
}

template <int N>
int run_stream(const void* x, const void* wg, const void* wu, const void* wd,
               void* h, void* y, int E, int C, int d, int F, int act,
               cudaStream_t stream) {
  const int err = launch_stream<true, N>(wg, wu, x, h, E, C, F, d, act,
                                         stream);
  if (err) return err;
  return launch_stream<false, N>(wd, nullptr, h, y, E, C, d, F, act, stream);
}

// ---- bf16 x with f32 weights on wgmma, fed by TMA ----
//
// The weights stay f32 in device memory and reach shared memory by TMA
// as f32 boxes (32 columns of 128 bytes, 128-byte swizzle). Each
// consumer thread reads its A fragments of the weight tile from there,
// splits each value into hi = bf16(w) and lo = bf16(w - hi), and issues
// wgmma with A from registers (the RS form), so the operands are
// swapped as on the stream path: the weight tile is the 64-row M side
// (output columns) and the bucket's rows are N, out^T = W^T x^T. x is
// bf16, exact, and is B (K-major) with no remainder: gate and up take
// x w_hi + x w_lo. The gate/up epilogue writes h as a hi / lo pair of
// bf16 (h_hi = bf16(h), h_lo = bf16(h - h_hi)), interleaved by 32
// columns: each row of the workspace is Fp / 32 groups of 32 hi then
// the same 32 lo (Fp: F rounded up to 32, the pad written as zeros), so
// one 128-byte TMA box carries the hi and the lo of 32 f, and the down
// kernel's k-slab is 32 f deep with the usual K-major descriptors. Down
// takes wd_hi h_hi + wd_lo h_hi + wd_hi h_lo. So no weight and no h
// value enters a product as a single bf16: each keeps ~16 bits of
// mantissa, the products of the "mma" path.
//
// One kernel template serves both paths: a block is WM x WN consumer
// warpgroups and a producer warp, persistent over (expert, row tile,
// column tile) items (column tiles fastest, so the blocks in flight
// share an expert's weights and rows in L2). Consumer (wm, wn) owns
// columns 64 wm.. and rows N wn.. of the block's tile. Per 16-deep
// k-step it splits the step's fragments while the previous step's
// wgmma group runs (two fragment buffers, wgmma.wait_group 1).
// - "stream" (decode, C <= the threshold): one consumer, N 8 to 64,
//   two blocks an SM; the weights stream once.
// - "wgmma" (prefill): gate/up 1 x 2 consumers of 128 rows (a 64 x 256
//   tile, 64 KB stages, 3 of them), down 2 x 1 of 256 rows (128 x 256,
//   48 KB stages, 4).
constexpr int kWCols = 32;                      // f32 columns of a box

template <bool GATED, int N, int WM, int WN>
struct WTile {
  static constexpr int kNW = GATED ? 2 : 1;             // weights
  static constexpr int kK = GATED ? 64 : 32;            // k a slab
  static constexpr int kBoxW = kK * 128;                // one f32 box
  static constexpr int kW = WM * (64 / kWCols) * kBoxW; // a weight's tile
  static constexpr int kX = N * 128;                    // a consumer's rows
  static constexpr int kStage = kNW * kW + WN * kX;
  static constexpr int kConsumers = 128 * WM * WN;
  // two consumers: a producer warpgroup that hands its registers to them
  // (setmaxnreg; ptxas budgets a 288-thread block as 384 threads and
  // spilled the gate/up consumers at 168); one: a producer warp
  static constexpr bool kDonor = WM * WN > 1;
  static constexpr int kThreads = kConsumers + (kDonor ? 128 : 32);
  static constexpr int kBlocksPerSM = kDonor ? 1 : 2;
  static constexpr int kBudget = (WM * WN == 1 ? 104 : 200) * 1024;
  static constexpr int kStages =
      kBudget / kStage > 12 ? 12 : kBudget / kStage;
  static constexpr int kSmem = kStages * kStage + 16 * kStages + 1024;
  static constexpr int kCols = 64 * WM, kRows = N * WN;
  static_assert(kStages >= 2, "ring");
};

// v0, v1 (consecutive k of one row of A) -> packed bf16 hi, and lo
__device__ __forceinline__ uint32_t split2(float v0, float v1,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// GATED: W / W2 = Wg / Wu (E, K = d, M = F) f32, X = x (E, C, d) bf16,
// out = h (E, C, 2 Fp) as hi / lo groups of 32 (above). Else W = Wd
// (E, K = F, M = d) f32, X = that h, out = y (E, C, d) bf16.
template <bool GATED, int N, int WM, int WN>
__global__ void __launch_bounds__(WTile<GATED, N, WM, WN>::kThreads,
                                  WTile<GATED, N, WM, WN>::kBlocksPerSM)
gmm_w32_kernel(const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tw2,
               const __grid_constant__ CUtensorMap tx,
               __nv_bfloat16* __restrict__ out, int E, int C, int M, int K,
               int act) {
  using T = WTile<GATED, N, WM, WN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bars = base + T::kStages * T::kStage;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto freed = [&](int s) { return bars + 8 * (T::kStages + s); };
  const int ct = (M + T::kCols - 1) / T::kCols;
  const int per_e = ct * ((C + T::kRows - 1) / T::kRows);
  const int items = E * per_e, nk = (K + T::kK - 1) / T::kK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(freed(s), T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, uniform as ptxas sees it (a shuffle from lane 0), so that
  // each role's code is allocated its setmaxnreg count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == WM * WN) {                            // the producer
    if constexpr (T::kDonor)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(kGProducerRegs));
    if (threadIdx.x == T::kConsumers) {
      int it = 0;                                   // slabs so far
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int e = item / per_e, r = item % per_e;
        const int m0 = (r % ct) * T::kCols, c0 = (r / ct) * T::kRows;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % T::kStages;
          if (it >= T::kStages) mbar_wait(freed(s), (it / T::kStages - 1) & 1);
          const uint32_t st = base + s * T::kStage;
          mbar_expect_tx(full(s), T::kStage);
#pragma unroll
          for (int w = 0; w < T::kNW; ++w)
#pragma unroll
            for (int b = 0; b < T::kCols / kWCols; ++b)
              tma_load3(st + w * T::kW + b * T::kBoxW, w ? &tw2 : &tw,
                        full(s), m0 + b * kWCols, ks * T::kK, e);
          // x: k 64 ks..; h: f 32 ks.., its hi and lo (64 columns)
#pragma unroll
          for (int wn = 0; wn < WN; ++wn)
            tma_load3(st + T::kNW * T::kW + wn * T::kX, &tx, full(s),
                      ks * 64, c0 + wn * N, e);
        }
      }
    }
    return;
  }

  if constexpr (T::kDonor)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kGConsumerRegs));
  const int wm = role % WM, wn = role / WM;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // A fragment of a 16-deep k-step at row k0 = 16 kk of the tile: A's
  // rows (output columns) 16 warp + g and + 8, its k pairs 2t, 2t + 1
  // and + 8. Weight column c sits in box c / 32 at 16-byte chunk
  // (c % 32) / 4, XORed with the k row's low 3 bits (the 128-byte
  // swizzle): off[dr][dc], k row 2t + dr, column + 8 dc. Rows + 8 are
  // 1024 bytes on, with the same swizzle. A warp's 32 reads of one value
  // fall on 32 banks.
  int off[2][2];
  {
    const int box = 2 * wm + (warp >> 1);
    const int chunk = 4 * (warp & 1) + (g >> 2);
#pragma unroll
    for (int dr = 0; dr < 2; ++dr)
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int row = 2 * t + dr;
        off[dr][dc] = box * T::kBoxW + row * 128 +
                      (((chunk + 2 * dc) ^ row) << 4) + (g & 3) * 4;
      }
  }
  const auto ldw = [&](const unsigned char* p, int dr, int dc) {
    return *reinterpret_cast<const float*>(p + off[dr][dc]);
  };

  float acc[T::kNW][N / 2];
  uint32_t fh[2][T::kNW][4], fl[2][T::kNW][4];     // two k-steps' buffers
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int e = item / per_e, r = item % per_e;
    const int m0 = (r % ct) * T::kCols + 64 * wm;
    const int c0 = (r / ct) * T::kRows + N * wn;
#pragma unroll
    for (int w = 0; w < T::kNW; ++w)
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[w][j] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % T::kStages;
      mbar_wait(full(s), (it / T::kStages) & 1);
      const unsigned char* sw = sbase + s * T::kStage;
      const uint64_t dx = sw128_desc(
          base + s * T::kStage + T::kNW * T::kW + wn * T::kX, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < T::kK / 16; ++kk) {
        const int b = kk & 1;
#pragma unroll
        for (int w = 0; w < T::kNW; ++w) {
          const unsigned char* p = sw + w * T::kW + kk * 16 * 128;
          // a[0]: column c, k 2t, 2t + 1; a[1]: c + 8; a[2], a[3]: k + 8
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const unsigned char* pq = p + (q >> 1) * 8 * 128;
            fh[b][w][q] = split2(ldw(pq, 0, q & 1), ldw(pq, 1, q & 1),
                                 fl[b][w][q]);
          }
        }
#pragma unroll
        for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
        pin(fh[b]);
        pin(fl[b]);
        wg_fence();
        if (GATED) {
          // 32 bytes (16 k) a step along x's K-major rows
#pragma unroll
          for (int w = 0; w < T::kNW; ++w) {
            Wgmma<N>::template rs<0>(acc[w], fh[b][w], dx + kk * 2);
            Wgmma<N>::template rs<0>(acc[w], fl[b][w], dx + kk * 2);
          }
        } else {
          // h's row of 64: f 0-31 hi (16 a step), then their lo
          Wgmma<N>::template rs<0>(acc[0], fh[b][0], dx + kk * 2);
          Wgmma<N>::template rs<0>(acc[0], fl[b][0], dx + kk * 2);
          Wgmma<N>::template rs<0>(acc[0], fh[b][0], dx + 4 + kk * 2);
        }
        wg_commit();
        wg_wait<1>();                               // the step before
#pragma unroll
        for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
        pin(fh[b ^ 1]);
        pin(fl[b ^ 1]);
        if (kk == 0 && ks > 0)                      // slab ks - 1 is done
          mbar_arrive(freed((it - 1) % T::kStages));
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int w = 0; w < T::kNW; ++w) pin(acc[w]);
    pin(fh[0]);
    pin(fl[0]);
    pin(fh[1]);
    pin(fl[1]);
    mbar_arrive(freed((it - 1) % T::kStages));

    // accumulator (transposed): output columns m0 + 16 warp + g and + 8,
    // bucket rows 2t, 2t + 1 of each 8
    const int Fp = (M + 31) & ~31;                  // GATED: h's groups
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + warp * 16 + g + (q >> 1) * 8;
        const int row = c0 + j * 8 + 2 * t + (q & 1);
        if (row >= C) continue;
        if (GATED) {
          if (m >= Fp) continue;                    // the pad is zeros
          const float v = act_f(acc[0][4 * j + q], act) *
                          acc[T::kNW - 1][4 * j + q];
          const __nv_bfloat16 hi = __float2bfloat16_rn(v);
          __nv_bfloat16* p = out + ((size_t)e * C + row) * (2 * Fp) +
                             (m >> 5) * 64 + (m & 31);
          p[0] = hi;
          p[32] = __float2bfloat16_rn(v - __bfloat162float(hi));
        } else {
          if (m >= M) continue;
          out[((size_t)e * C + row) * M + m] =
              __float2bfloat16_rn(acc[0][4 * j + q]);
        }
      }
  }
}

// GATED: w / w2 = Wg / Wu, xin = x, out = h (hi / lo groups), M = F,
// K = d. Else w = Wd, xin = h, out = y, M = d, K = F.
template <bool GATED, int N, int WM, int WN>
int launch_w32(const void* w, const void* w2, const void* xin, void* out,
               int E, int C, int M, int K, int act, cudaStream_t stream) {
  using T = WTile<GATED, N, WM, WN>;
  CUtensorMap tw, tw2, tx;
  int err = make_map3(&tw, w, M, K, E, T::kK, true);
  if (err == 0) err = make_map3(&tw2, GATED ? w2 : w, M, K, E, T::kK, true);
  // x: (E, C, d) bf16; h: (E, C, 2 Fp) bf16, Fp = F rounded up to 32
  if (err == 0)
    err = make_map3(&tx, xin, GATED ? K : 2 * ((K + 31) & ~31), C, E, N);
  if (err != 0) return err;
  auto kern = gmm_w32_kernel<GATED, N, WM, WN>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  static int resident = 0;                          // blocks the card holds
  if (resident == 0) {
    err = resident_blocks(kern, T::kThreads, T::kSmem, &resident);
    if (err != 0) return err;
  }
  const int items = E * ((M + T::kCols - 1) / T::kCols) *
                    ((C + T::kRows - 1) / T::kRows);
  const int grid = items < resident ? items : resident;
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(
      tw, tw2, tx, (__nv_bfloat16*)out, E, C, M, K, act);
  return (int)cudaGetLastError();
}

template <int N>
int run_w32_stream(const void* x, const void* wg, const void* wu,
                   const void* wd, void* h, void* y, int E, int C, int d,
                   int F, int act, cudaStream_t stream) {
  const int err = launch_w32<true, N, 1, 1>(wg, wu, x, h, E, C, F, d, act,
                                            stream);
  if (err) return err;
  return launch_w32<false, N, 1, 1>(wd, nullptr, h, y, E, C, d, F, act,
                                    stream);
}

// bf16 x, f32 weights; h an (E, C, 2 Fp) bf16 workspace (hi / lo groups)
int run_w32(bool stream_path, const void* x, const void* wg, const void* wu,
            const void* wd, void* h, void* y, int E, int C, int d, int F,
            int act, cudaStream_t stream) {
  if (stream_path) {
    if (C <= 8) return run_w32_stream<8>(x, wg, wu, wd, h, y, E, C, d, F,
                                         act, stream);
    if (C <= 16) return run_w32_stream<16>(x, wg, wu, wd, h, y, E, C, d, F,
                                           act, stream);
    if (C <= 32) return run_w32_stream<32>(x, wg, wu, wd, h, y, E, C, d, F,
                                           act, stream);
    return run_w32_stream<64>(x, wg, wu, wd, h, y, E, C, d, F, act, stream);
  }
  const int err = launch_w32<true, 128, 1, 2>(wg, wu, x, h, E, C, F, d, act,
                                              stream);
  if (err) return err;
  return launch_w32<false, 256, 2, 1>(wd, nullptr, h, y, E, C, d, F, act,
                                      stream);
}

// bf16 x and weights; h an (E, C, F) bf16 workspace
int run_tma(bool stream_path, const void* x, const void* wg, const void* wu,
            const void* wd, void* h, void* y, int E, int C, int d, int F,
            int act, cudaStream_t stream) {
  if (stream_path) {
    if (C <= 8) return run_stream<8>(x, wg, wu, wd, h, y, E, C, d, F, act,
                                     stream);
    if (C <= 16) return run_stream<16>(x, wg, wu, wd, h, y, E, C, d, F, act,
                                       stream);
    if (C <= 32) return run_stream<32>(x, wg, wu, wd, h, y, E, C, d, F, act,
                                       stream);
    return run_stream<64>(x, wg, wu, wd, h, y, E, C, d, F, act, stream);
  }
  const int err = launch_wgmma<true>(x, wg, wu, h, E, C, F, d, act, stream);
  if (err) return err;
  return launch_wgmma<false>(h, wd, nullptr, y, E, C, d, F, act, stream);
}

// the "f32" and "mma" paths; h an (E, C, F) f32 workspace
template <typename TW>
int run_cores(const void* x, const void* wg, const void* wu, const void* wd,
              float* h, void* y, bool x_f32, int E, int C, int d, int F,
              int act, cudaStream_t stream) {
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

bool a16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (E, C, d), wg / wu (E, d, F), wd (E, F, d), all contiguous; y
// (E, C, d) in x's dtype; h a workspace: f32 (E, C, F) on paths 0-1,
// bf16 (E, C, F) on paths 2-3 with bf16 weights, and with f32 weights
// bf16 (E, C, 2 Fp), Fp = F rounded up to 32 (h's hi / lo groups).
// x_dtype / w_dtype: 0 float32, 1 bfloat16 (the three weights alike).
// act: 0 silu, 1 gelu (tanh approximation). path, as the wrapper's
// _path chose it: 0 "f32" (x f32), 1 "mma" (x bf16), 2 "stream" and 3
// "wgmma" (x bf16, d and F multiples of 8, every pointer 16-byte
// aligned; stream: C <= 64). A path that does not take these inputs
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int moe_gmm(const void* x, const void* wg, const void* wu,
                       const void* wd, void* h, void* y, int x_dtype,
                       int w_dtype, int path, int E, int C, int d, int F,
                       int act, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (E < 1 || E > 65535 || C < 1 || d < 1 || F < 1 || x_dtype < 0 ||
      x_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (path == 0 || path == 1) {
    if (x_dtype != (path == 0 ? 0 : 1)) return (int)cudaErrorInvalidValue;
    if (w_dtype == 0)
      return run_cores<float>(x, wg, wu, wd, (float*)h, y, path == 0, E, C,
                              d, F, act, st);
    return run_cores<__nv_bfloat16>(x, wg, wu, wd, (float*)h, y, path == 0,
                                    E, C, d, F, act, st);
  }
  if ((path == 2 || path == 3) && x_dtype == 1 && d % 8 == 0 &&
      F % 8 == 0 && a16(x) && a16(wg) && a16(wu) && a16(wd) && a16(h) &&
      a16(y) && (path == 3 || C <= kStreamMaxC)) {
    if (w_dtype == 1)
      return run_tma(path == 2, x, wg, wu, wd, h, y, E, C, d, F, act, st);
    return run_w32(path == 2, x, wg, wu, wd, h, y, E, C, d, F, act, st);
  }
  return (int)cudaErrorInvalidValue;
}
