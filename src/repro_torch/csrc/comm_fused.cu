// Fused cohort-compression kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels in src/repro/kernels/comm_fused/kernel.py:
//   int8_roundtrip_pallas -> int8_roundtrip: (R, G) group rows ->
//       dequantize(quantize(x)) in one kernel; q, scale and zp live only
//       in registers and never reach device memory.
//   sparse_combine_pallas -> sparse_combine: from the residual-added
//       cohort buffer y and the 0/1 survivor mask, delivered =
//       y * mask * scale and residual = y - delivered, both outputs from
//       one read of the inputs.
//
// Bound on this card: memory. int8_roundtrip moves 4 bytes in and 4 out
// per value, sparse_combine 8 in and 8 out; both do a handful of flops a
// value. So: one pass, coalesced 16-byte accesses. The roundtrip is one
// warp per row with the row held in registers between its min/max
// reduction and the map (the per-row math is shared with the int8
// quantize kernel, int8_rows.cuh); sparse_combine is an elementwise
// pass, 4 values a thread. The survivor scale (1 for top-k, n/k for
// unbiased rand-k) is an fp32 kernel argument, so no host-to-device copy
// precedes the launch. Top-k selection itself stays with torch.topk.
//
// C interface (loaded with ctypes): pointers and the stream as void*,
// each entry returns cudaGetLastError() of its launch.
#include "int8_rows.cuh"

using namespace int8rows;

namespace {

__global__ void __launch_bounds__(kRowThreads)
roundtrip_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long rows, int g, bool vec) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (long long)gridDim.x * (blockDim.x / kWarp);
  for (long long r = (long long)blockIdx.x * (blockDim.x / kWarp) +
                     threadIdx.x / kWarp;
       r < rows; r += warps) {
    float* orow = out + r * g;
    process_row(
        x + r * g, g, vec, lane,
        [&](int i4, Affine a, float q0, float q1, float q2, float q3) {
          reinterpret_cast<float4*>(orow)[i4] =
              make_float4(dequantize(q0, a), dequantize(q1, a),
                          dequantize(q2, a), dequantize(q3, a));
        },
        [&](int j, Affine a, float qj) { orow[j] = dequantize(qj, a); });
  }
}

__device__ __forceinline__ void combine(float y, float m, float s,
                                        float& d, float& r) {
  d = __fmul_rn(__fmul_rn(y, m), s);
  r = __fsub_rn(y, d);
}

__global__ void __launch_bounds__(kElemThreads)
sparse_combine_kernel(const float* __restrict__ y,
                      const float* __restrict__ mask, float scale,
                      float* __restrict__ out, float* __restrict__ res,
                      long long n, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i4 = first; i4 < n4; i4 += stride) {
      const float4 yv = reinterpret_cast<const float4*>(y)[i4];
      const float4 mv = reinterpret_cast<const float4*>(mask)[i4];
      float4 d, r;
      combine(yv.x, mv.x, scale, d.x, r.x);
      combine(yv.y, mv.y, scale, d.y, r.y);
      combine(yv.z, mv.z, scale, d.z, r.z);
      combine(yv.w, mv.w, scale, d.w, r.w);
      reinterpret_cast<float4*>(out)[i4] = d;
      reinterpret_cast<float4*>(res)[i4] = r;
    }
    return;
  }
  for (long long i = first; i < n; i += stride)
    combine(y[i], mask[i], scale, out[i], res[i]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

}  // namespace

extern "C" int int8_roundtrip(const void* x, void* out, long long rows,
                              int g, void* stream) {
  const bool vec = g % 4 == 0 && g <= 4 * kMaxVec * kWarp &&
                   aligned16(x) && aligned16(out);
  roundtrip_kernel<<<row_blocks(rows), kRowThreads, 0,
                     (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                             rows, g, vec);
  return (int)cudaGetLastError();
}

extern "C" int sparse_combine(const void* y, const void* mask, float scale,
                              void* out, void* res, long long n,
                              void* stream) {
  const bool vec = n % 4 == 0 && aligned16(y) && aligned16(mask) &&
                   aligned16(out) && aligned16(res);
  sparse_combine_kernel<<<elem_blocks(vec ? n / 4 : n), kElemThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)y, (const float*)mask, scale, (float*)out, (float*)res,
      n, vec);
  return (int)cudaGetLastError();
}
