// Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas in src/repro/kernels/ssd_scan/kernel.py. Same
// function, chunk by chunk (l rows, cs = cumsum(dt * A) in the chunk):
//   y     = (L o C B^T)(dt o x) + exp(cs) o (C state^T),
//           L[i, j] = exp(cs_i - cs_j) for j <= i, else 0
//   state = exp(cs_last) state + x^T (B o exp(cs_last - cs) dt)
// with the (p, n) state carried in f32 from the initial state across the
// chunks; y and the final state are cast to x's dtype at the end. x, B,
// C and the initial state share one dtype (f32 or bf16); dt and A are
// f32, as ssm_apply hands them over.
//
// Bound on this card: at the serving shape (b 4, s 2048, h 64, p 64,
// n 64, chunk 128) the scan moves ~143 MB (x and y 67 MB each) for
// ~13 GFLOP, so bytes bound it (0.043 ms at 3.35 TB/s).
//
// Three kernels; the wrapper (kernels/ssd_scan/kernel.py, _path) picks
// one from the dtype, p, n and the alignment alone, and the C entry
// refuses a path whose preconditions fail:
// - "wgmma" (bf16, p and n multiples of 8, x, B and C on 16 bytes): the
//   serving path. Chunk-parallel on wgmma fed by TMA, the state handed
//   from chunk to chunk through L2 (the third kernel, below).
// - "mma" (the other bf16: p or n not a multiple of 8, a base off 16
//   bytes): one block per (batch, head, p tile) walks the chunks in
//   order on mma.sync (the second kernel).
// - "f32": f32 inputs, held to (2e-4, 1e-5) of the f32 arithmetic, on
//   the fp32 cores (the first kernel).
//
// Design (fp32 cores). The TPU kernel walks a sequential (batch, head,
// chunk) grid and keeps the state in VMEM scratch between chunk steps.
// Here one block owns one (batch, head, p tile) and loops over the
// chunks inside, with the state tile in shared memory in f32 for the
// whole sequence. Per chunk the block stages x, B, C (f32) and cs in
// shared memory, forms W = L o C B^T (times dt, folded into the
// columns) in shared memory, and computes y and the state update from
// register tiles (each thread owns an 8 x 4 tile of y and of the state
// update, interleaved by 16 so that a warp's shared loads are
// broadcasts or consecutive). The p axis is split into tiles only when
// the chunk's working set would not fit in the 227 KB of shared memory
// (the wrapper picks the widest tile that fits: 64 at the serving
// shape, so no work is repeated there); W is independent of p and is
// recomputed by each p tile.
//
// C interface (loaded with ctypes): returns cudaGetLastError() of the
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kMaxL = 128;       // chunk
constexpr int kMaxN = 128;       // state size
constexpr int kMaxPT = 64;       // p tile

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fstate, int S,
                int H, int P, int N, int L, int PT) {
  extern __shared__ float smem[];
  const int np = N + 1;                         // padded pitches
  const int lp = L + 1;
  float* Xs = smem;                             // [L][PT]
  float* Bs = Xs + L * PT;                      // [L][N+1]
  float* Cs = Bs + L * np;                      // [L][N]
  float* Ws = Cs + L * N;                       // [L][L+1]
  float* St = Ws + L * lp;                      // [PT][N+1]
  float* cs = St + PT * np;                     // [L]
  float* dts = cs + L;                          // [L]
  float* tail = dts + L;                        // [L]

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H;
  const int p0 = blockIdx.y * PT;
  const int pt = min(PT, P - p0);               // columns of this tile
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float a = A[hi];

  // state tile <- initial state (f32)
  for (int i = tid; i < pt * N; i += kThreads) {
    const int pp = i / N, nn = i - pp * N;
    St[pp * np + nn] =
        init ? init[(((long long)bi * H + hi) * P + p0 + pp) * N + nn] : 0.f;
  }

  const int nc = S / L;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)bi * S + (long long)c * L;
    __syncthreads();                            // previous chunk done
    for (int i = tid; i < L * pt; i += kThreads) {
      const int m = i / pt, pp = i - m * pt;
      Xs[m * PT + pp] = x[((t0 + m) * H + hi) * P + p0 + pp];
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int m = i / N, nn = i - m * N;
      Bs[m * np + nn] = B[(t0 + m) * N + nn];
      Cs[m * N + nn] = C[(t0 + m) * N + nn];
    }
    for (int i = tid; i < L; i += kThreads) dts[i] = dt[(t0 + i) * H + hi];
    __syncthreads();

    // cs = cumsum(dt * A), in order and without contraction: a scan in
    // another order moves cs by a few ulp of |cs| (~100 at the serving
    // shape), which exp(cs_i - cs_j) turns into ~1e-5 relative error
    // and a long chunk into more than the f32 tolerance allows
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        cs[i] = run;
      }
    }
    __syncthreads();
    const float cs_last = cs[L - 1];
    for (int i = tid; i < L; i += kThreads)
      tail[i] = expf(cs_last - cs[i]) * dts[i];

    // W[i][m] = (m <= i) ? exp(cs_i - cs_m) * (C_i . B_m) * dt_m : 0
    {
      float w[8][8];
#pragma unroll
      for (int ai = 0; ai < 8; ++ai)
#pragma unroll
        for (int am = 0; am < 8; ++am) w[ai][am] = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        float cv[8], bv[8];
#pragma unroll
        for (int ai = 0; ai < 8; ++ai) {
          const int i = ty + 16 * ai;
          cv[ai] = i < L ? Cs[i * N + nn] : 0.f;
        }
#pragma unroll
        for (int am = 0; am < 8; ++am) {
          const int mm = tx + 16 * am;
          bv[am] = mm < L ? Bs[mm * np + nn] : 0.f;
        }
#pragma unroll
        for (int ai = 0; ai < 8; ++ai)
#pragma unroll
          for (int am = 0; am < 8; ++am)
            w[ai][am] = fmaf(cv[ai], bv[am], w[ai][am]);
      }
#pragma unroll
      for (int ai = 0; ai < 8; ++ai) {
        const int i = ty + 16 * ai;
        if (i >= L) continue;
#pragma unroll
        for (int am = 0; am < 8; ++am) {
          const int mm = tx + 16 * am;
          if (mm >= L) continue;
          Ws[i * lp + mm] =
              mm <= i ? expf(cs[i] - cs[mm]) * w[ai][am] * dts[mm] : 0.f;
        }
      }
    }

    // y_off[i][p] = exp(cs_i) * (C_i . state_p), in registers
    float acc[8][4];
#pragma unroll
    for (int ai = 0; ai < 8; ++ai)
#pragma unroll
      for (int ap = 0; ap < 4; ++ap) acc[ai][ap] = 0.f;
    for (int nn = 0; nn < N; ++nn) {
      float cv[8], sv[4];
#pragma unroll
      for (int ai = 0; ai < 8; ++ai) {
        const int i = ty + 16 * ai;
        cv[ai] = i < L ? Cs[i * N + nn] : 0.f;
      }
#pragma unroll
      for (int ap = 0; ap < 4; ++ap) {
        const int pp = tx + 16 * ap;
        sv[ap] = pp < pt ? St[pp * np + nn] : 0.f;
      }
#pragma unroll
      for (int ai = 0; ai < 8; ++ai)
#pragma unroll
        for (int ap = 0; ap < 4; ++ap)
          acc[ai][ap] = fmaf(cv[ai], sv[ap], acc[ai][ap]);
    }
#pragma unroll
    for (int ai = 0; ai < 8; ++ai) {
      const int i = ty + 16 * ai;
      const float e = i < L ? expf(cs[i]) : 0.f;
#pragma unroll
      for (int ap = 0; ap < 4; ++ap) acc[ai][ap] *= e;
    }
    __syncthreads();                            // Ws complete, St read

    // y[i][p] += sum_{m <= i} W[i][m] x[m][p]
    const int m_end = min(L, ty + 16 * 7 + 1);
    for (int mm = 0; mm < m_end; ++mm) {
      float wv[8], xv[4];
#pragma unroll
      for (int ai = 0; ai < 8; ++ai) {
        const int i = ty + 16 * ai;
        wv[ai] = i < L ? Ws[i * lp + mm] : 0.f;
      }
#pragma unroll
      for (int ap = 0; ap < 4; ++ap) {
        const int pp = tx + 16 * ap;
        xv[ap] = pp < pt ? Xs[mm * PT + pp] : 0.f;
      }
#pragma unroll
      for (int ai = 0; ai < 8; ++ai)
#pragma unroll
        for (int ap = 0; ap < 4; ++ap)
          acc[ai][ap] = fmaf(wv[ai], xv[ap], acc[ai][ap]);
    }
#pragma unroll
    for (int ai = 0; ai < 8; ++ai) {
      const int i = ty + 16 * ai;
      if (i >= L) continue;
      float* yrow = y + ((t0 + i) * H + hi) * P + p0;
#pragma unroll
      for (int ap = 0; ap < 4; ++ap) {
        const int pp = tx + 16 * ap;
        if (pp < pt) yrow[pp] = acc[ai][ap];
      }
    }

    // state[p][n] = exp(cs_last) state[p][n] + sum_m x[m][p] B[m][n] tail[m]
    // (each thread updates its own elements: p = ty + 16 ap, n = tx + 16 an)
    {
      float u[4][8];
#pragma unroll
      for (int ap = 0; ap < 4; ++ap)
#pragma unroll
        for (int an = 0; an < 8; ++an) u[ap][an] = 0.f;
      for (int mm = 0; mm < L; ++mm) {
        const float tm = tail[mm];
        float xv[4], bv[8];
#pragma unroll
        for (int ap = 0; ap < 4; ++ap) {
          const int pp = ty + 16 * ap;
          xv[ap] = pp < pt ? Xs[mm * PT + pp] : 0.f;
        }
#pragma unroll
        for (int an = 0; an < 8; ++an) {
          const int nn = tx + 16 * an;
          bv[an] = nn < N ? Bs[mm * np + nn] * tm : 0.f;
        }
#pragma unroll
        for (int ap = 0; ap < 4; ++ap)
#pragma unroll
          for (int an = 0; an < 8; ++an)
            u[ap][an] = fmaf(xv[ap], bv[an], u[ap][an]);
      }
      const float dec = expf(cs_last);
#pragma unroll
      for (int ap = 0; ap < 4; ++ap) {
        const int pp = ty + 16 * ap;
        if (pp >= pt) continue;
#pragma unroll
        for (int an = 0; an < 8; ++an) {
          const int nn = tx + 16 * an;
          if (nn < N) St[pp * np + nn] = St[pp * np + nn] * dec + u[ap][an];
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < pt * N; i += kThreads) {
    const int pp = i / N, nn = i - pp * N;
    fstate[(((long long)bi * H + hi) * P + p0 + pp) * N + nn] =
        St[pp * np + nn];
  }
}

size_t smem_bytes(int L, int N, int PT) {
  return sizeof(float) * (size_t)(L * PT + L * (N + 1) + L * N +
                                  L * (L + 1) + PT * (N + 1) + 3 * L);
}

int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* init, void* y, void* fstate, int b,
           int S, int H, int P, int N, int L, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int PT = kMaxPT;
  while (PT > 16 && smem_bytes(L, N, PT) > (size_t)max_smem) PT /= 2;
  const size_t smem = smem_bytes(L, N, PT);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * H, (P + PT - 1) / PT);
  ssd_scan_kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)B,
      (const float*)C, (const float*)init, (float*)y, (float*)fstate, S, H,
      P, N, L, PT);
  return (int)cudaGetLastError();
}


// ---- bf16 on the tensor cores: mma.sync.m16n8k16, f32 accumulation ----
//
// Same schedule (one block per (batch, head, 64-wide p tile), a loop over
// the chunks), 8 warps. Warp w owns chunk rows [16w, 16w + 16): it forms
// its rows of C B^T and of C state^T from one pass over n (C's A
// fragments shared by both), turns the first into W in registers (mask,
// exp(cs_i - cs_m), dt_m; only the m tiles at or below the diagonal are
// computed), and adds W X with W fed straight from its accumulator
// fragments. The f32 state lives in registers as the accumulator
// fragments of the update x^T (B o tail): warp w owns p rows
// [16 (w % 4), +16) and half of n. Operands that are not bf16 to begin
// with (W, the state, B o tail) are split into a bf16 high part and a
// bf16 remainder, two mma's, so each product keeps ~16 bits of mantissa
// and the result stays close to the f32 arithmetic of the plain version.
// x and (B o tail) are staged transposed in shared memory so that every
// B fragment is a 32-bit load; rows of 8 extra bf16 keep a quad's loads
// on distinct banks. n is padded with zeros to NN (64 or 128), the chunk
// to 128 rows. x, B and C come in value by value: what this kernel takes
// (p or n not a multiple of 8, a base off 16 bytes) has no 16-byte
// vectors.
constexpr int kML = 128;         // chunk rows the layout is cut for
constexpr int kMP = 64;          // p tile
constexpr int kMThreads = 256;   // 8 warps
constexpr int kSPad = 8;         // bf16 of padding per shared row

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// v = hi + lo with both in bf16
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// A fragments (hi, lo) of a 16 x 16 tile held as two accumulator tiles
// (columns 0-7 in c0, 8-15 in c1), as mma's m16n8k16 takes them
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float v[4][2] = {{c0[0], c0[1]}, {c0[2], c0[3]},
                         {c1[0], c1[1]}, {c1[2], c1[3]}};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    bf16 h0, l0, h1, l1;
    split(v[r][0], h0, l0);
    split(v[r][1], h1, l1);
    hi[r] = pack2(h0, h1);
    lo[r] = pack2(l0, l1);
  }
}

template <int NN>
__global__ void __launch_bounds__(kMThreads)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ B,
                    const bf16* __restrict__ C, const bf16* __restrict__ init,
                    bf16* __restrict__ y, bf16* __restrict__ fstate, int S,
                    int H, int P, int N, int L) {
  constexpr int kPN = NN + kSPad;               // rows indexed by n
  constexpr int kPL = kML + kSPad;              // rows indexed by m
  constexpr int kSN = NN / 16;                  // state n tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw); // [kML][kPN]  C[m][n]
  bf16* Bs = Cs + kML * kPN;                    // [kML][kPN]  B[m][n]
  bf16* Sh = Bs + kML * kPN;                    // [kMP][kPN]  state hi
  bf16* Sl = Sh + kMP * kPN;                    // [kMP][kPN]  state lo
  bf16* Xt = Sl + kMP * kPN;                    // [kMP][kPL]  x[m][p]^T
  bf16* BTh = Xt + kMP * kPL;                   // [NN][kPL]   (B o tail)^T
  bf16* BTl = BTh + NN * kPL;
  float* cs = reinterpret_cast<float*>(BTl + NN * kPL);   // [kML]
  float* dts = cs + kML;                                  // [kML]

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int p0 = blockIdx.y * kMP;
  const int pt = min(kMP, P - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float a = A[hi];
  const bf16 zero = __float2bfloat16_rn(0.f);
  const long long sbase = ((long long)bi * H + hi) * P + p0;  // state row 0

  // the state: accumulator fragments, p = sp0 + g (+8), n = sn0 + ...
  const int sp0 = 16 * (warp & 3), sn0 = (warp >> 2) * (NN / 2);
  float st[kSN][4];
#pragma unroll
  for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = sp0 + g + (e >> 1) * 8;
      const int nn = sn0 + nt * 8 + 2 * t + (e & 1);
      st[nt][e] = (init && pp < pt && nn < N)
                      ? __bfloat162float(init[(sbase + pp) * N + nn]) : 0.f;
    }
  for (int i = tid; i < kMP * NN; i += kMThreads) {
    const int pp = i / NN, nn = i - pp * NN;
    Sh[pp * kPN + nn] =
        (init && pp < pt && nn < N) ? init[(sbase + pp) * N + nn] : zero;
    Sl[pp * kPN + nn] = zero;
  }

  const int i0 = 16 * warp;
  const int ia = i0 + g, ib = ia + 8;           // this lane's chunk rows
  const int nc = S / L;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)bi * S + (long long)c * L;
    __syncthreads();                            // previous chunk done
    for (int i = tid; i < kML * NN; i += kMThreads) {
      const int m = i / NN, nn = i - m * NN;
      const bool in = m < L && nn < N;
      Cs[m * kPN + nn] = in ? C[(t0 + m) * N + nn] : zero;
      Bs[m * kPN + nn] = in ? B[(t0 + m) * N + nn] : zero;
    }
    for (int i = tid; i < kML * kMP; i += kMThreads) {
      const int m = i / kMP, pp = i - m * kMP;
      Xt[pp * kPL + m] = (m < L && pp < pt)
                             ? x[((t0 + m) * H + hi) * P + p0 + pp] : zero;
    }
    for (int i = tid; i < kML; i += kMThreads)
      dts[i] = i < L ? dt[(t0 + i) * H + hi] : 0.f;
    __syncthreads();
    if (tid == 0) {                             // in order, as above
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        cs[i] = run;
      }
      for (int i = L; i < kML; ++i) cs[i] = run;
    }
    __syncthreads();
    const float cs_last = cs[L - 1];

    // (B o tail)^T, tail_m = exp(cs_last - cs_m) dt_m, split hi / lo
    for (int i = tid; i < NN * kML; i += kMThreads) {
      const int nn = i / kML, m = i - nn * kML;
      float v = 0.f;
      if (m < L)
        v = __bfloat162float(Bs[m * kPN + nn]) *
            (expf(cs_last - cs[m]) * dts[m]);
      split(v, BTh[nn * kPL + m], BTl[nn * kPL + m]);
    }

    // rows [i0, i0 + 16): S = C B^T (m tiles <= diagonal), Y = C state^T
    float w[kML / 8][4], ya[kMP / 8][4];
#pragma unroll
    for (int nt = 0; nt < kML / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[nt][e] = 0.f;
#pragma unroll
    for (int pn = 0; pn < kMP / 8; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[pn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk) {
      const bf16* cr = Cs + ia * kPN + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(cr), a1 = ld32(cr + 8 * kPN);
      const uint32_t a2 = ld32(cr + 8), a3 = ld32(cr + 8 * kPN + 8);
#pragma unroll
      for (int nt = 0; nt < kML / 8; ++nt) {
        if (nt > 2 * warp + 1) continue;        // above the diagonal
        const bf16* br = Bs + (nt * 8 + g) * kPN + kk * 16 + 2 * t;
        mma_bf16(w[nt], a0, a1, a2, a3, ld32(br), ld32(br + 8));
      }
#pragma unroll
      for (int pn = 0; pn < kMP / 8; ++pn) {
        const int off = (pn * 8 + g) * kPN + kk * 16 + 2 * t;
        mma_bf16(ya[pn], a0, a1, a2, a3, ld32(Sh + off),
                 ld32(Sh + off + 8));
        mma_bf16(ya[pn], a0, a1, a2, a3, ld32(Sl + off),
                 ld32(Sl + off + 8));
      }
    }
    const float ea = ia < L ? expf(cs[ia]) : 0.f;
    const float eb = ib < L ? expf(cs[ib]) : 0.f;
#pragma unroll
    for (int pn = 0; pn < kMP / 8; ++pn) {
      ya[pn][0] *= ea;
      ya[pn][1] *= ea;
      ya[pn][2] *= eb;
      ya[pn][3] *= eb;
    }
    // W = L o S o dt (columns)
#pragma unroll
    for (int nt = 0; nt < kML / 8; ++nt) {
      if (nt > 2 * warp + 1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int m = nt * 8 + 2 * t + (e & 1);
        w[nt][e] = (m <= i && i < L)
                       ? expf(cs[i] - cs[m]) * w[nt][e] * dts[m] : 0.f;
      }
    }
    // Y += W X
#pragma unroll
    for (int kk = 0; kk < kML / 16; ++kk) {
      if (kk > warp) continue;
      uint32_t wh[4], wl[4];
      split_a(w[2 * kk], w[2 * kk + 1], wh, wl);
#pragma unroll
      for (int pn = 0; pn < kMP / 8; ++pn) {
        const bf16* xr = Xt + (pn * 8 + g) * kPL + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(xr), b1 = ld32(xr + 8);
        mma_bf16(ya[pn], wh[0], wh[1], wh[2], wh[3], b0, b1);
        mma_bf16(ya[pn], wl[0], wl[1], wl[2], wl[3], b0, b1);
      }
    }
#pragma unroll
    for (int pn = 0; pn < kMP / 8; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int pp = pn * 8 + 2 * t + (e & 1);
        if (i < L && pp < pt)
          y[((t0 + i) * H + hi) * P + p0 + pp] =
              __float2bfloat16_rn(ya[pn][e]);
      }
    __syncthreads();                            // BT ready; Sh/Sl read

    // state = exp(cs_last) state + x^T (B o tail)
    const float dec = expf(cs_last);
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] *= dec;
#pragma unroll
    for (int kk = 0; kk < kML / 16; ++kk) {
      if (kk * 16 >= L) continue;
      const bf16* xr = Xt + (sp0 + g) * kPL + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(xr), a1 = ld32(xr + 8 * kPL);
      const uint32_t a2 = ld32(xr + 8), a3 = ld32(xr + 8 * kPL + 8);
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt) {
        const int off = (sn0 + nt * 8 + g) * kPL + kk * 16 + 2 * t;
        mma_bf16(st[nt], a0, a1, a2, a3, ld32(BTh + off),
                 ld32(BTh + off + 8));
        mma_bf16(st[nt], a0, a1, a2, a3, ld32(BTl + off),
                 ld32(BTl + off + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = sp0 + g + (e >> 1) * 8;
        const int nn = sn0 + nt * 8 + 2 * t + (e & 1);
        split(st[nt][e], Sh[pp * kPN + nn], Sl[pp * kPN + nn]);
      }
  }

#pragma unroll
  for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = sp0 + g + (e >> 1) * 8;
      const int nn = sn0 + nt * 8 + 2 * t + (e & 1);
      if (pp < pt && nn < N)
        fstate[(sbase + pp) * N + nn] = __float2bfloat16_rn(st[nt][e]);
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NN>
int launch_mma(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* init, void* y, void* fstate, int b,
               int S, int H, int P, int N, int L, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (size_t)(2 * kML * (NN + kSPad) +
                              2 * kMP * (NN + kSPad) + kMP * (kML + kSPad) +
                              2 * NN * (kML + kSPad)) +
      sizeof(float) * 2 * kML;
  auto kern = ssd_scan_mma_kernel<NN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * H, (P + kMP - 1) / kMP);
  kern<<<grid, kMThreads, smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const bf16*)init, (bf16*)y, (bf16*)fstate, S, H, P, N,
      L);
  return (int)cudaGetLastError();
}

// ---- bf16 on wgmma fed by TMA, chunk-parallel: the "wgmma" path ----
//
// The kernel above walks 16 chunks in order per (batch, head): 256
// sequential chains at the serving shape, each chunk loaded
// synchronously. Here a block takes one work item, a (batch, chunk,
// head, 64-wide p tile): 4096 items at the serving shape.
// Items start in chunk order from an atomic ticket (the first thing a
// block does), so the item a block waits on has started before it and
// is resident: the lowest unfinished ticket never waits, and the grid
// cannot deadlock however many blocks the card holds. A chain (batch,
// head, p tile) hands its f32 state from chunk to chunk through one
// slot in device memory (8 MB in all at the serving shape, L2-resident)
// whose 64-bit words each carry a value and the number of the chunk
// that wrote it (the decoupled look-back of single-pass scans: a reader
// polls the data itself, so no flag and no memory fence sit on the
// chain, where a flag behind a gpu-scope fence held each hop longest).
// The wrapper allocates the ticket and the slots and zeroes them; the
// kernel allocates nothing.
//
// Per item, 256 threads (two warpgroups of 64 chunk rows, wgmma's M):
// 1. Thread 0 takes the ticket and loads the B and C tiles (128 rows x
//    n) and the x tile (128 rows x 64 p, a box of x (b, s, h, p) at one
//    head, rows H P apart) by TMA onto two mbarriers. Rows past
//    the chunk and columns past p or n are TMA's zeros (maps over (p, h,
//    row, batch * chunk) and (n, row, batch * chunk)), so any chunk
//    <= 128 is taken.
// 2. Warp 0 loads the head's dt (stride H, plain loads) and scans cs =
//    cumsum(dt A) (4 rows a lane in order, then a shuffle scan), so cs
//    differs from the in-order sum by a few ulp of |cs|: ~1e-5 relative
//    in L, far inside bf16's 2^-9. tail_m = exp(cs_last - cs_m) dt_m and
//    exp(cs_i) are taken once per row.
// 3. The chain's slot words are read early (their latency hides behind
//    steps 4-5); (B o tail) is formed once, in B's swizzled layout.
// 4. upd = x^T (B o tail) on wgmma (x and B o tail both MN-major through
//    the transpose bits), one warpgroup per 64 columns of n.
// 5. The chain step, by those warpgroups: each thread waits until its
//    slot words carry chunk c's tag (bounded; traps), or takes the
//    initial state (or zeros) at chunk 0, and writes exp(cs_last) state
//    + upd in f32 with tag c + 1 (the last chunk writes the final state
//    in bf16 instead). This elementwise step over 64 x n values is the
//    only serial work of a chunk hop.
// 6. S = C B^T (both K-major, as flash's Q K^T), W = mask o exp(cs_i -
//    cs_m) o dt_m o S in registers (a warp skips the pairs right of its
//    rows' diagonal), Y = W X with W as the register A operand and X
//    read MN-major through the transpose bit (flash's P V).
// 7. Y += exp(cs_i) o (C state^T), the state from step 5 (K-major in
//    shared memory); y is staged in bf16 and stored by one TMA store.
// A block takes one head: with 2 or 4 heads a block sharing the ticket,
// the B and C loads, S and the scans, ptxas spilled 644 bytes a thread
// at the 128 registers that two blocks an SM allow, and the kernel took
// twice as long (PERF.md, the heads sweep).
// Precision: W, the state and B o tail are f32 values that the f32
// arithmetic of the plain version keeps; each is split into a bf16 high
// part and a bf16 remainder and its product runs twice (PERF.md derives
// why one bf16 rounding of any of them would leave the tolerance at the
// serving shape). C, B and x are bf16 at the source and exact.
constexpr int kCRows = 128;      // chunk rows a tile holds
constexpr int kCThreads = 256;   // two warpgroups
constexpr int kCBox = kCRows * 128;   // bytes of a 128-row, 64-column box
constexpr int kSBox = 64 * 128;       // bytes of a 64-row box (the state)
constexpr int kRowF = 5 * kCRows;     // floats of one head's row terms
constexpr float kLog2e = 1.4426950408889634f;

template <int NN>
struct CTile {
  static constexpr int kNB = NN / 64;            // 64-column boxes of n
  static constexpr int kB = kNB * kCBox;        // offsets in bytes: C at
  static constexpr int kX = 2 * kB;             // 0, then B, x, (B o tail)
  static constexpr int kBth = kX + kCBox;       // hi (also y's staging)
  static constexpr int kBtl = kBth + kB;        // and lo, the state hi and
  static constexpr int kSh = kBtl + kB;         // lo, the row terms, the
  static constexpr int kSl = kSh + kNB * kSBox; // mbarriers
  static constexpr int kF = kSl + kNB * kSBox;
  static constexpr int kBar = kF + ((kRowF + 1) * 4 + 15) / 16 * 16;
  static constexpr int kSmem = kBar + 32 + 1024;  // and the item; slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A slot word: an f32 state value in the low half, the number of the
// chunk whose state it is in the high half. A 64-bit word is read and
// written whole, so a reader that sees the tag it waits for holds that
// chunk's value: no flag, no fence.
__device__ __forceinline__ ulonglong2 ld_slot(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_slot(unsigned long long* p, float a,
                                        float b, unsigned tag) {
  const unsigned long long hi = (unsigned long long)tag << 32;
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};\n"
               :: "l"(p), "l"(hi | __float_as_uint(a)),
                  "l"(hi | __float_as_uint(b))
               : "memory");
}

__device__ __forceinline__ bool tagged(ulonglong2 v, unsigned tag) {
  return (unsigned)(v.x >> 32) == tag && (unsigned)(v.y >> 32) == tag;
}

// (a, b) = hi + lo with both bf16 pairs (a in the low half); -> hi
__device__ __forceinline__ uint32_t pack_split(float a, float b,
                                               uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int NN>
__global__ void __launch_bounds__(kCThreads, 2)
ssd_scan_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const bf16* __restrict__ init, bf16* __restrict__ fstate,
                 unsigned* __restrict__ ticket,
                 unsigned long long* __restrict__ slots, int S, int H,
                 int P, int N, int L, int nc, int items_per_chunk) {
  using T = CTile<NN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  float* cs2 = reinterpret_cast<float*>(sm + T::kF);  // cs log2(e)
  float* tail = cs2 + kCRows;          // exp(cs_last - cs) dt
  float* ecs = tail + kCRows;          // exp(cs)
  float* col = ecs + kCRows;           // (-cs2_m, dt_m) pairs
  float* s_dec = col + 2 * kCRows;     // exp(cs_last)
  int* s_item = reinterpret_cast<int*>(sm + T::kBar + 16);
  const uint32_t bar = base + T::kBar, barx = bar + 8;
  const int tid = threadIdx.x, PT = (P + 63) / 64;

  if (tid == 0) {             // the ticket; C, B and x by TMA
    mbar_init(bar, 1);
    mbar_init(barx, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int item = (int)atomicAdd(ticket, 1u);
    *s_item = item;
    const int c = item / items_per_chunk, k = item % items_per_chunk;
    const int bc = (k / (PT * H)) * nc + c;         // batch * nc + chunk
    mbar_expect_tx(bar, 2 * T::kB);
#pragma unroll
    for (int j = 0; j < T::kNB; ++j) {
      tma_load3(base + j * kCBox, &tc, bar, j * 64, 0, bc);
      tma_load3(base + T::kB + j * kCBox, &tb, bar, j * 64, 0, bc);
    }
    mbar_expect_tx(barx, kCBox);
    tma_load(base + T::kX, &tx, barx, (k % PT) * 64, (k / PT) % H, 0, bc);
  }
  __syncthreads();
  const int item = *s_item;
  const int c = item / items_per_chunk, k = item % items_per_chunk;
  const int pt = k % PT, hd = (k / PT) % H, bi = k / (PT * H);
  const int p0 = pt * 64, bc = bi * nc + c;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (tid < 32) {             // warp 0: the head's dt and cs
    const long long row0 = (long long)bi * S + (long long)c * L;
    float d[4], v[4], run = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * lane + j;
      d[j] = r < L ? dt[(row0 + r) * H + hd] : 0.f;
    }
    // cs = cumsum(dt A): 4 rows a lane in order, then a shuffle scan
    const float a = A[hd];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run = __fadd_rn(run, __fmul_rn(d[j], a));
      v[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, u);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * lane + j;
      const float cs = __fadd_rn(excl, v[j]);     // rows past L: cs_last
      cs2[r] = cs * kLog2e;
      col[2 * r] = -cs2[r];
      col[2 * r + 1] = d[j];
      ecs[r] = expf(cs);
      tail[r] = expf(last - cs) * d[j];           // rows past L: dt 0
    }
    if (lane == 0) *s_dec = expf(last);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  // the warpgroup, uniform as ptxas sees it (a shuffle from lane 0)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // descriptors: C (A operand, this warpgroup's 64 rows), B, x, B o tail
  const uint64_t dca = sw128_desc(base + wg * 64 * 128, 16, 1024);
  const uint64_t dbk = sw128_desc(base + T::kB, 16, 1024);
  const uint64_t dxm = sw128_desc(base + T::kX, kCBox, 1024);
  const int r0 = wg * 64 + warp * 16 + g, r1 = r0 + 8;  // chunk rows
  const int kc = (bi * H + hd) * PT + pt;           // the chain
  // The chain's slot words (pair r = 2 j + h2 of this thread's upd
  // fragment at ((wg 16 + r) 128 + thread) 2: a warp's loads and
  // stores are 512 contiguous bytes). Chunk c's state is read now,
  // before the B o tail pass and upd, so the load's latency hides
  // behind them; words that do not carry tag c yet are read again.
  unsigned long long* slot = slots + (size_t)kc * 64 * NN +
                             (size_t)wg * 16 * 256 + (tid & 127) * 2;
  ulonglong2 w[16];
  if (wg < T::kNB && c > 0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) w[r] = ld_slot(slot + r * 256);
  }

  // (B o tail) hi / lo at B's own (swizzled) offsets: 16 bytes a step
  for (int u = tid; u < T::kNB * kCBox / 16; u += kCThreads) {
    const int off = u * 16;
    const float tm = tail[(off & (kCBox - 1)) >> 7];
    const uint4 bv = *reinterpret_cast<const uint4*>(sm + T::kB + off);
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(&bv);
    uint4 hv, lv;
    uint32_t* hw = reinterpret_cast<uint32_t*>(&hv);
    uint32_t* lw = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b2 =
          *reinterpret_cast<const __nv_bfloat162*>(&bw[j]);
      hw[j] = pack_split(__bfloat162float(b2.x) * tm,
                         __bfloat162float(b2.y) * tm, lw[j]);
    }
    *reinterpret_cast<uint4*>(sm + T::kBth + off) = hv;
    *reinterpret_cast<uint4*>(sm + T::kBtl + off) = lv;
  }
  fence_proxy_async();
  __syncthreads();
  mbar_wait(barx, 0);                // x

  if (wg < T::kNB) {                 // n columns [64 wg, 64 wg + 64)
    float upd[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) upd[j] = 0.f;
    const uint64_t dbh =
        sw128_desc(base + T::kBth + wg * kCBox, kCBox, 1024);
    const uint64_t dbl =
        sw128_desc(base + T::kBtl + wg * kCBox, kCBox, 1024);
    pin(upd);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kCRows / 16; ++kk)  // 16 chunk rows a step
      Wgmma<64>::ss<1, 1>(upd, dxm + kk * 128, dbh + kk * 128, kk > 0);
#pragma unroll
    for (int kk = 0; kk < kCRows / 16; ++kk)
      Wgmma<64>::ss<1, 1>(upd, dxm + kk * 128, dbl + kk * 128, 1);
    wg_commit();
    wg_wait<0>();
    pin(upd);

    // the chain step: accumulator rows p = 16 warp + g (+ 8), columns
    // n = 64 wg + 8 j + 2 t4 (+ 1)
    const float dec = *s_dec;
    const long long sbase = ((long long)bi * H + hd) * P + p0;
    float2 st[16];
    if (c > 0) {                     // until every word carries tag c
      uint32_t pend = 0u;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (!tagged(w[r], (unsigned)c)) pend |= 1u << r;
      for (uint32_t n = 0; pend != 0u; ++n) {
        if (n == (1u << 24)) __trap();  // seconds: fail, never hang
        __nanosleep(32);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          if (pend >> r & 1u) w[r] = ld_slot(slot + r * 256);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          if ((pend >> r & 1u) && tagged(w[r], (unsigned)c))
            pend &= ~(1u << r);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
        st[r] = make_float2(__uint_as_float((unsigned)w[r].x),
                            __uint_as_float((unsigned)w[r].y));
    } else {                         // chunk 0: the initial state
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int p = 16 * warp + g + 8 * (r & 1);
        const int n = 64 * wg + 8 * (r >> 1) + 2 * t4;
        st[r] = make_float2(0.f, 0.f);
        if (init != nullptr && p0 + p < P && n < N) {  // any alignment
          const bf16* iv = init + (sbase + p) * N + n;
          st[r] = make_float2(__bfloat162float(iv[0]),
                              __bfloat162float(iv[1]));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int p = 16 * warp + g + 8 * (r & 1);
      const int n = 64 * wg + 8 * (r >> 1) + 2 * t4;
      const float nx0 = fmaf(st[r].x, dec, upd[2 * r]);
      const float nx1 = fmaf(st[r].y, dec, upd[2 * r + 1]);
      if (c + 1 < nc)
        st_slot(slot + r * 256, nx0, nx1, (unsigned)(c + 1));
      else if (p0 + p < P && n < N)
        *reinterpret_cast<__nv_bfloat162*>(fstate + (sbase + p) * N + n) =
            __floats2bfloat162_rn(nx0, nx1);
      // state_in, K-major (rows p, columns n) in 128-byte-swizzled
      // 64-column boxes, for C state^T
      const int cl = n & 63;
      const int off = wg * kSBox + p * 128 +
                      (((cl >> 3) ^ (p & 7)) << 4) + (cl & 7) * 2;
      uint32_t lo;
      *reinterpret_cast<uint32_t*>(sm + T::kSh + off) =
          pack_split(st[r].x, st[r].y, lo);
      *reinterpret_cast<uint32_t*>(sm + T::kSl + off) = lo;
    }
    fence_proxy_async();
  }

  // S = C B^T for this warpgroup's 64 rows, all 128 columns
  float sc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) sc[j] = 0.f;
  pin(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NN / 16; ++kk) {      // box kk / 4, 32 bytes
    const uint32_t off = (kk >> 2) * (kCBox >> 4) + (kk & 3) * 2;
    Wgmma<128>::ss(sc, dca + off, dbk + off, kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  pin(sc);

  // W = mask o exp(cs_i - cs_m) o dt_m o S (exp2 of cs log2(e)), split
  // hi / lo as wgmma's register A operand (S's accumulator layout is
  // the A layout: k-step kk, pair q holds row r0 (q even) or r1 (q
  // odd), columns 16 kk + 8 (q / 2) + 2 t4, + 1). A pair right of its
  // rows' diagonal is 0 (decided per warp), one on it is masked. Rows
  // past L have C's zeros, so S and W are 0 there.
  const float c0 = cs2[r0], c1 = cs2[r1];
  uint32_t wh[8][4], wl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wh[kk][q] = wl[kk][q] = 0u;
      const int m8 = 16 * kk + 8 * (q >> 1);  // this pair's 8 columns
      const int top = r0 - g + 8 * (q & 1);   // its rows' first
      if (m8 > top) continue;                 // right of the diagonal
      const int m = m8 + 2 * t4;
      const float4 cm = *reinterpret_cast<const float4*>(col + 2 * m);
      const float ci = (q & 1) ? c1 : c0;
      float w0 = ex2(ci + cm.x) * cm.y * sc[8 * kk + 2 * q];
      float w1 = ex2(ci + cm.z) * cm.w * sc[8 * kk + 2 * q + 1];
      if (m8 == top) {                        // on the diagonal
        const int i = (q & 1) ? r1 : r0;
        w0 = m <= i ? w0 : 0.f;
        w1 = m + 1 <= i ? w1 : 0.f;
      }
      wh[kk][q] = pack_split(w0, w1, wl[kk][q]);
    }

  // Y = W X (W hi, then lo), X MN-major
  float yacc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) yacc[j] = 0.f;
  pin(yacc);
  pin(wh);
  pin(wl);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    Wgmma<64>::rs(yacc, wh[kk], dxm + kk * 128);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    Wgmma<64>::rs(yacc, wl[kk], dxm + kk * 128);
  wg_commit();
  wg_wait<0>();
  pin(yacc);
  pin(wh);
  pin(wl);

  __syncthreads();                   // the state is in shared memory
  float yo[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) yo[j] = 0.f;
  const uint64_t dsh = sw128_desc(base + T::kSh, 16, 1024);
  const uint64_t dsl = sw128_desc(base + T::kSl, 16, 1024);
  pin(yo);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NN / 16; ++kk) {
    const uint32_t off = (kk & 3) * 2;
    Wgmma<64>::ss(yo, dca + (kk >> 2) * (kCBox >> 4) + off,
                  dsh + (kk >> 2) * (kSBox >> 4) + off, kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < NN / 16; ++kk) {
    const uint32_t off = (kk & 3) * 2;
    Wgmma<64>::ss(yo, dca + (kk >> 2) * (kCBox >> 4) + off,
                  dsl + (kk >> 2) * (kSBox >> 4) + off, 1);
  }
  wg_commit();
  wg_wait<0>();
  pin(yo);

  // y in bf16, staged where B o tail was (read by upd), in the y map's
  // swizzled layout; one TMA store writes the rows and columns inside
  // the tensor
  const float e0 = ecs[r0], e1 = ecs[r1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int off = ((j ^ g) << 4) + 4 * t4;  // r0 & 7 == r1 & 7 == g
    *reinterpret_cast<__nv_bfloat162*>(sm + T::kBth + r0 * 128 + off) =
        __floats2bfloat162_rn(fmaf(e0, yo[4 * j], yacc[4 * j]),
                              fmaf(e0, yo[4 * j + 1], yacc[4 * j + 1]));
    *reinterpret_cast<__nv_bfloat162*>(sm + T::kBth + r1 * 128 + off) =
        __floats2bfloat162_rn(fmaf(e1, yo[4 * j + 2], yacc[4 * j + 2]),
                              fmaf(e1, yo[4 * j + 3], yacc[4 * j + 3]));
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store(&ty, base + T::kBth, p0, hd, 0, bc);
    bulk_commit();
    bulk_wait_read();
  }
}

template <int NN>
int launch_chunk(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* init, void* y, void* fstate,
                 void* ticket, void* slots, int b, int S, int H, int P,
                 int N, int L, cudaStream_t stream) {
  using T = CTile<NN>;
  const int nc = S / L;
  const int per_chunk = b * H * ((P + 63) / 64);
  // x, y (b, S, H, P) as (P, H, row, batch * chunk); B, C (b, S, N) as
  // (N, row, batch * chunk): rows past L are outside, so TMA zero-fills
  // them on loads and skips them on the store
  CUtensorMap tx, tb, tc, ty;
  const cuuint64_t xs[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)L,
                            (cuuint64_t)b * nc};
  const cuuint64_t xst[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                             (cuuint64_t)L * H * P * 2};
  const cuuint32_t xbox[4] = {64, 1, kCRows, 1};
  const cuuint64_t bs[3] = {(cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)b * nc};
  const cuuint64_t bst[2] = {(cuuint64_t)N * 2, (cuuint64_t)L * N * 2};
  const cuuint32_t bbox[3] = {64, kCRows, 1};
  int err = tma_map_bf16(&tx, x, 4, xs, xst, xbox);
  if (err == 0) err = tma_map_bf16(&ty, y, 4, xs, xst, xbox);
  if (err == 0) err = tma_map_bf16(&tb, B, 3, bs, bst, bbox);
  if (err == 0) err = tma_map_bf16(&tc, C, 3, bs, bst, bbox);
  if (err != 0) return err;
  auto kern = ssd_scan_chunk_kernel<NN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<nc * per_chunk, kCThreads, T::kSmem, stream>>>(
      tx, tb, tc, ty, (const float*)dt, (const float*)A, (const bf16*)init,
      (bf16*)fstate, (unsigned*)ticket, (unsigned long long*)slots, S, H, P,
      N, L, nc, per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x (b, S, H, P), dt (b, S, H) f32, A (H,) f32, B/C (b, S, N),
// init (b, H, P, N) or null (zeros), y (b, S, H, P), fstate (b, H, P, N);
// all contiguous. S % L == 0, L <= 128, P, N <= 128. dtype (of x, B, C,
// init, y, fstate): 0 float32, 1 bfloat16. path, as the wrapper's _path
// chose it: 0 the fp32 cores (f32), 1 mma.sync (bf16), 2 wgmma + TMA
// (bf16, P and N multiples of 8, x, B, C on 16 bytes; scratch: 2 +
// chains x 64 x NN zeroed 64-bit words on 16 bytes, the ticket and then
// the slots, NN = 64 for N <= 64 else 128, a chain being a (batch,
// head, 64-wide p tile)). A path that does not take these inputs
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init,
                        void* y, void* fstate, void* scratch,
                        int dtype, int path, int b, int S, int H, int P,
                        int N, int L, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (L <= 0 || L > kMaxL || N > kMaxN || P > 2 * kMaxPT || S % L != 0)
    return (int)cudaErrorInvalidValue;
  if (path == 0 && dtype == 0)
    return launch(x, dt, A, B, C, init, y, fstate, b, S, H, P, N, L, st);
  if (path == 1 && dtype == 1) {
    if (N <= 64)
      return launch_mma<64>(x, dt, A, B, C, init, y, fstate, b, S, H, P, N,
                            L, st);
    return launch_mma<128>(x, dt, A, B, C, init, y, fstate, b, S, H, P, N,
                           L, st);
  }
  if (path == 2 && dtype == 1 && P % 8 == 0 && N % 8 == 0 && aligned16(x) &&
      aligned16(B) && aligned16(C) && aligned16(scratch)) {
    void* slots = static_cast<unsigned long long*>(scratch) + 2;
    if (N <= 64)
      return launch_chunk<64>(x, dt, A, B, C, init, y, fstate, scratch,
                              slots, b, S, H, P, N, L, st);
    return launch_chunk<128>(x, dt, A, B, C, init, y, fstate, scratch, slots,
                             b, S, H, P, N, L, st);
  }
  return (int)cudaErrorInvalidValue;
}
