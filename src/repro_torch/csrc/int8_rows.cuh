// Per-row int8 affine math shared by the quantize and roundtrip kernels.
//
// A row is one group of G consecutive values (G <= 256 on the codec
// path). One warp owns one row: the lanes load the row, reduce min and
// max with warp shuffles, and every lane then holds the row's scale and
// zero point in registers, so the elementwise map needs no shared
// memory and no second trip to device memory.
//
// Numerics: the reference's op order in fp32, each op rounded on its
// own. The __f*_rn intrinsics are IEEE round-to-nearest and are never
// contracted into an FMA, so a build flag cannot change a result; the
// division is a true division (a reciprocal multiply would move .5
// rounding boundaries), and rintf rounds half to even like jnp.round.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace int8rows {

constexpr float kQmax = 127.0f;
constexpr int kWarp = 32;
constexpr int kMaxVec = 2;            // float4 per lane: 2 * 4 * 32 = 256

struct Affine {
  float scale;
  float zp;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// scale = max((mx - mn) / 254, 1e-12); zp = -127 - mn / scale
__device__ __forceinline__ Affine row_affine(float mn, float mx) {
  Affine a;
  a.scale = fmaxf(__fdiv_rn(__fsub_rn(mx, mn), 2.0f * kQmax), 1e-12f);
  a.zp = __fsub_rn(-kQmax, __fdiv_rn(mn, a.scale));
  return a;
}

// q = clip(round(x / scale + zp), -127, 127), as a float
__device__ __forceinline__ float quantize(float x, Affine a) {
  const float v = rintf(__fadd_rn(__fdiv_rn(x, a.scale), a.zp));
  return fminf(fmaxf(v, -kQmax), kQmax);
}

// x' = scale * (q - zp)
__device__ __forceinline__ float dequantize(float q, Affine a) {
  return __fmul_rn(a.scale, __fsub_rn(q, a.zp));
}

// Walks one row of g values starting at xr with the calling warp.
// emit4(i4, a, q0, q1, q2, q3) is called for each float4 slot (vector
// path), emit1(j, a, q) for each value (scalar path); both receive the
// row's affine map and quantized values as floats. Returns the map.
//
// Vector path (vec): g % 4 == 0, g <= 256 and xr 16-byte aligned; the row
// sits in registers, two 16-byte loads per lane, one read of memory.
// Scalar path: any g; min/max in a first pass, the map in a second
// (the second read of the same row hits L1/L2).
template <class Emit4, class Emit1>
__device__ __forceinline__ Affine process_row(const float* __restrict__ xr,
                                              int g, bool vec, int lane,
                                              Emit4 emit4, Emit1 emit1) {
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  if (vec) {
    const int n4 = g >> 2;
    float4 v[kMaxVec];
#pragma unroll
    for (int k = 0; k < kMaxVec; ++k) {
      const int i4 = lane + k * kWarp;
      if (i4 < n4) {
        v[k] = reinterpret_cast<const float4*>(xr)[i4];
        mn = fminf(mn, fminf(fminf(v[k].x, v[k].y), fminf(v[k].z, v[k].w)));
        mx = fmaxf(mx, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
      }
    }
    const Affine a = row_affine(warp_min(mn), warp_max(mx));
#pragma unroll
    for (int k = 0; k < kMaxVec; ++k) {
      const int i4 = lane + k * kWarp;
      if (i4 < n4)
        emit4(i4, a, quantize(v[k].x, a), quantize(v[k].y, a),
              quantize(v[k].z, a), quantize(v[k].w, a));
    }
    return a;
  }
  for (int j = lane; j < g; j += kWarp) {
    const float x = xr[j];
    mn = fminf(mn, x);
    mx = fmaxf(mx, x);
  }
  const Affine a = row_affine(warp_min(mn), warp_max(mx));
  for (int j = lane; j < g; j += kWarp) emit1(j, a, quantize(xr[j], a));
  return a;
}

// Launch shape of the one-warp-per-row kernels: 8 warps a block, a
// grid-stride loop over rows beyond 65535 blocks.
constexpr int kRowThreads = 256;

inline unsigned row_blocks(long long rows) {
  const long long warps = kRowThreads / kWarp;
  long long b = (rows + warps - 1) / warps;
  return (unsigned)(b < 65535 ? (b > 0 ? b : 1) : 65535);
}

// Launch shape of the elementwise kernels (grid-stride).
constexpr int kElemThreads = 256;

inline unsigned elem_blocks(long long work) {
  long long b = (work + kElemThreads - 1) / kElemThreads;
  return (unsigned)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

}  // namespace int8rows
