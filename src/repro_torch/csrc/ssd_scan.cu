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
// ~13 GFLOP, so bytes bound it. bf16 inputs run the chunk's four
// products on the tensor cores (mma.sync, the second kernel below);
// f32 inputs, held to (2e-4, 1e-5) of the f32 arithmetic, run them on
// the fp32 cores (the first kernel).
//
// Design (fp32 cores). The TPU kernel walks a sequential (batch, head,
// chunk) grid and keeps the state in VMEM scratch between chunk steps.
// Hopper blocks run in no order, so here one block owns one (batch,
// head, p tile) and loops over the chunks inside, with the state tile
// in shared memory in f32 for the whole sequence. Per chunk the block
// stages x, B, C (f32) and cs in shared memory, forms W = L o C B^T
// (times dt, folded into the columns) in shared memory, and computes y
// and the state update from register tiles (each thread owns an 8 x 4
// tile of y and of the state update, interleaved by 16 so that a
// warp's shared loads are broadcasts or consecutive). The p axis is
// split into tiles only when the chunk's working set would not fit in
// the 227 KB of shared memory (the wrapper picks the widest tile that
// fits: 64 at the serving shape, so no work is repeated there); W is
// independent of p and is recomputed by each p tile.
//
// C interface (loaded with ctypes): returns cudaGetLastError() of the
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// to 128 rows. x, B and C come in by 16-byte loads where n and p are
// multiples of 8 (every config), else value by value.
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
                    int H, int P, int N, int L, bool vec) {
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
    if (vec) {                                  // 16-byte loads, 8 values
      for (int i = tid; i < kML * (NN / 8); i += kMThreads) {
        const int m = i / (NN / 8), n8 = (i - m * (NN / 8)) * 8;
        uint4 cv = make_uint4(0, 0, 0, 0), bv = cv;
        if (m < L && n8 < N) {
          cv = *reinterpret_cast<const uint4*>(C + (t0 + m) * N + n8);
          bv = *reinterpret_cast<const uint4*>(B + (t0 + m) * N + n8);
        }
        *reinterpret_cast<uint4*>(Cs + m * kPN + n8) = cv;
        *reinterpret_cast<uint4*>(Bs + m * kPN + n8) = bv;
      }
      for (int i = tid; i < kML * (kMP / 8); i += kMThreads) {
        const int m = i / (kMP / 8), p8 = (i - m * (kMP / 8)) * 8;
        uint4 xv = make_uint4(0, 0, 0, 0);
        if (m < L && p8 < pt)
          xv = *reinterpret_cast<const uint4*>(
              x + ((t0 + m) * H + hi) * P + p0 + p8);
        const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) Xt[(p8 + j) * kPL + m] = xe[j];
      }
    } else {
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
  const bool vec = N % 8 == 0 && P % 8 == 0 && aligned16(x) &&
                   aligned16(B) && aligned16(C);
  const dim3 grid(b * H, (P + kMP - 1) / kMP);
  kern<<<grid, kMThreads, smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const bf16*)init, (bf16*)y, (bf16*)fstate, S, H, P, N,
      L, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (b, S, H, P), dt (b, S, H) f32, A (H,) f32, B/C (b, S, N),
// init (b, H, P, N) or null (zeros), y (b, S, H, P), fstate (b, H, P, N);
// all contiguous. S % L == 0, L <= 128, P, N <= 128. dtype (of x, B, C,
// init, y, fstate): 0 float32 (fp32 cores), 1 bfloat16 (tensor cores).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init,
                        void* y, void* fstate, int dtype, int b, int S,
                        int H, int P, int N, int L, void* stream) {
  if (L > kMaxL || N > kMaxN || P > 2 * kMaxPT || S % L != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(x, dt, A, B, C, init, y, fstate, b, S, H, P, N, L,
                  (cudaStream_t)stream);
  if (N <= 64)
    return launch_mma<64>(x, dt, A, B, C, init, y, fstate, b, S, H, P, N, L,
                          (cudaStream_t)stream);
  return launch_mma<128>(x, dt, A, B, C, init, y, fstate, b, S, H, P, N, L,
                         (cudaStream_t)stream);
}
