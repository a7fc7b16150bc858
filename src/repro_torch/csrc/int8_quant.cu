// Int8 affine quantize / dequantize of (R, G) group rows, for Hopper
// (sm_90a).
//
// Replaces the Pallas pair in src/repro/kernels/int8_quant/kernel.py:
//   int8_quantize_pallas   -> int8_quantize   (per row: min, max, scale,
//                             zero point, q = clip(rint(x/scale + zp)))
//   int8_dequantize_pallas -> int8_dequantize (x' = scale * (q - zp))
//
// Bound on this card: memory. Per value, quantize moves 4 bytes in and
// 1 out (+ 8 bytes of scale/zp per row), dequantize 1 in and 4 out; the
// arithmetic is a few flops a value, far below the card's rate. So the
// design is one pass over memory with coalesced loads: one warp per row
// (a 256-value row is two 16-byte loads per lane, consecutive lanes on
// consecutive addresses), the row's min/max by warp shuffles, the row
// kept in registers between the reduction and the map, q stored four
// bytes a lane; dequantize is an elementwise pass, 4 values a thread.
// At the codec's shapes (a few thousand rows) a call moves a few MB and
// launch latency, not bandwidth, sets its time.
//
// C interface (loaded with ctypes): pointers and the stream as void*,
// each entry returns cudaGetLastError() of its launch.
#include "int8_rows.cuh"

using namespace int8rows;

namespace {

__global__ void __launch_bounds__(kRowThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, float* __restrict__ zp,
                long long rows, int g, bool vec) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (long long)gridDim.x * (blockDim.x / kWarp);
  for (long long r = (long long)blockIdx.x * (blockDim.x / kWarp) +
                     threadIdx.x / kWarp;
       r < rows; r += warps) {
    int8_t* qr = q + r * g;
    const Affine a = process_row(
        x + r * g, g, vec, lane,
        [&](int i4, Affine, float q0, float q1, float q2, float q3) {
          reinterpret_cast<char4*>(qr)[i4] =
              make_char4((signed char)q0, (signed char)q1, (signed char)q2,
                         (signed char)q3);
        },
        [&](int j, Affine, float qj) { qr[j] = (int8_t)qj; });
    if (lane == 0) {
      scale[r] = a.scale;
      zp[r] = a.zp;
    }
  }
}

__global__ void __launch_bounds__(kElemThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  const float* __restrict__ zp, float* __restrict__ out,
                  long long rows, int g, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {                      // g % 4 == 0: a char4 never spans rows
    const long long n4 = rows * g / 4;
    for (long long i4 = first; i4 < n4; i4 += stride) {
      const long long r = i4 * 4 / g;
      const Affine a{scale[r], zp[r]};
      const char4 c = reinterpret_cast<const char4*>(q)[i4];
      reinterpret_cast<float4*>(out)[i4] =
          make_float4(dequantize((float)c.x, a), dequantize((float)c.y, a),
                      dequantize((float)c.z, a), dequantize((float)c.w, a));
    }
    return;
  }
  const long long n = rows * g;
  for (long long i = first; i < n; i += stride) {
    const long long r = i / g;
    out[i] = dequantize((float)q[i], Affine{scale[r], zp[r]});
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" int int8_quantize(const void* x, void* q, void* scale, void* zp,
                             long long rows, int g, void* stream) {
  const bool vec = g % 4 == 0 && g <= 4 * kMaxVec * kWarp &&
                   aligned(x, 16) && aligned(q, 4);
  quantize_kernel<<<row_blocks(rows), kRowThreads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scale, (float*)zp, rows, g, vec);
  return (int)cudaGetLastError();
}

extern "C" int int8_dequantize(const void* q, const void* scale,
                               const void* zp, void* out, long long rows,
                               int g, void* stream) {
  const bool vec = g % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  const long long work = vec ? rows * g / 4 : rows * g;
  dequantize_kernel<<<elem_blocks(work), kElemThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scale, (const float*)zp, (float*)out,
      rows, g, vec);
  return (int)cudaGetLastError();
}
