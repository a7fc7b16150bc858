// Int8 affine quantize / dequantize of a list of tensors, for Hopper
// (sm_90a): one launch per list.
//
// Replaces the Pallas pair in src/repro/kernels/int8_quant/kernel.py:
//   int8_quantize_pallas   -> int8_quantize_segments   (per row: min,
//                             max, scale, zero point, q = clip(rint(x /
//                             scale + zp)))
//   int8_dequantize_pallas -> int8_dequantize_segments (x' = scale *
//                             (q - zp))
//
// A segment is one tensor of the list, cut into rows of g consecutive
// values (the codec's groups: g = min(256, numel)); the last row of a
// ragged tensor is edge-padded, x[min(j, numel - 1)], in registers.
//
// Bound on this card: memory, and at the codec's shapes the launch. Per
// value quantize moves 4 bytes in and 1 out, dequantize 1 in and 4 out
// (+ 8 bytes of scale/zp a row); a few flops a value. A model leg of
// S²FL sends 7-8 tensors of 64 values to 295 KB each, a feature
// transfer one tensor of a few MB: the fixed cost of a launch (a few µs
// on the card, tens of µs on the host) is most of a small tensor's time,
// so a whole list goes in one launch. The segment table travels by
// value in the kernel's parameter space (__grid_constant__: up to 64
// segments, under 4 KB), so there is no host-to-device copy; a longer
// list takes several launches.
//
// Both kernels run one warp per row over all the segments' rows. A warp
// finds its segment by a binary search of the table's first rows (the
// row is uniform per warp, so the loads are constant-bank broadcasts).
// Quantize keeps the row in registers (two float4 a lane at g = 256),
// reduces min and max with warp shuffles and stores q four bytes a lane;
// dequantize reads the row as char4 and writes float4, and writes only
// the tensor's own numel (the padding of the last row stays on the
// wire). A g that is not a multiple of 4, or a base off 16 bytes (x, out)
// or 4 bytes (q), takes the per-value path of the same kernel.
//
// Both launch with programmatic dependent launch: a kernel of the pair
// may be scheduled while the grid before it on the stream drains (a
// round trip's dequantize behind its quantize); it waits for that grid
// (griddepcontrol.wait) before it touches memory, then lets the next
// grid launch. Side by side this shortened a round trip on the card.
//
// Numerics: int8_rows.cuh's op order, each op rounded on its own, true
// divisions, rintf; no fast math. Bit-equal to the plain versions.
//
// C interface (loaded with ctypes): a host array of Leaf records and
// the stream; each entry launches once and returns the launch's error.
#include "int8_rows.cuh"

using namespace int8rows;

namespace {

constexpr int kMaxSegments = 64;
constexpr int kWarpsPerBlock = kRowThreads / kWarp;

// one tensor of the list, as the host hands it over
struct Leaf {
  const void* x;            // quantize: the values; dequantize: the output
  const void* q;            // (rows, g) int8
  const void* scale;        // (rows,) f32
  const void* zp;           // (rows,) f32
  long long numel;          // the tensor's values
  long long g;              // values a row
};

struct Segment {
  float* x;
  int8_t* q;
  float* scale;
  float* zp;
  long long numel;
  long long row0;           // the segment's first row in the launch
  int g;
  int vec;                  // the 16-byte path (see above)
};

struct Table {
  Segment seg[kMaxSegments];
  long long rows;           // all segments' rows
  int n;
};

static_assert(sizeof(Table) <= 4096, "the table must fit 4 KB of params");

// The start of each kernel: wait for the grid before this one on the
// stream (its writes included), then let the next one launch.
__device__ __forceinline__ void dependent_launch_entry() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
}

// the segment that holds launch row r: the last with row0 <= r
__device__ __forceinline__ int find_segment(const Table& t, long long r) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].row0 <= r) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kRowThreads)
quantize_segments_kernel(const __grid_constant__ Table t) {
  dependent_launch_entry();
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock +
                     threadIdx.x / kWarp;
       r < t.rows; r += warps) {
    const Segment& s = t.seg[find_segment(t, r)];
    const long long lr = r - s.row0;
    const int g = s.g;
    const float* xr = s.x + lr * g;
    int8_t* qr = s.q + lr * g;
    // values of the tensor in this row; the rest repeat its last value
    const int valid = (int)min((long long)g, s.numel - lr * g);
    float mn = CUDART_INF_F, mx = -CUDART_INF_F;
    Affine a;
    if (s.vec) {
      const int n4 = g >> 2;
      float4 v[kMaxVec];
#pragma unroll
      for (int k = 0; k < kMaxVec; ++k) {
        const int i4 = lane + k * kWarp;
        if (i4 < n4) {
          const int j = 4 * i4;
          if (j + 4 <= valid) {
            v[k] = reinterpret_cast<const float4*>(xr)[i4];
          } else {
            v[k] = make_float4(xr[min(j, valid - 1)],
                               xr[min(j + 1, valid - 1)],
                               xr[min(j + 2, valid - 1)],
                               xr[min(j + 3, valid - 1)]);
          }
          mn = fminf(mn, fminf(fminf(v[k].x, v[k].y),
                               fminf(v[k].z, v[k].w)));
          mx = fmaxf(mx, fmaxf(fmaxf(v[k].x, v[k].y),
                               fmaxf(v[k].z, v[k].w)));
        }
      }
      a = row_affine(warp_min(mn), warp_max(mx));
#pragma unroll
      for (int k = 0; k < kMaxVec; ++k) {
        const int i4 = lane + k * kWarp;
        if (i4 < n4)
          reinterpret_cast<char4*>(qr)[i4] = make_char4(
              (signed char)quantize(v[k].x, a),
              (signed char)quantize(v[k].y, a),
              (signed char)quantize(v[k].z, a),
              (signed char)quantize(v[k].w, a));
      }
    } else {
      for (int j = lane; j < g; j += kWarp) {
        const float x = xr[min(j, valid - 1)];
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
      a = row_affine(warp_min(mn), warp_max(mx));
      for (int j = lane; j < g; j += kWarp)
        qr[j] = (int8_t)quantize(xr[min(j, valid - 1)], a);
    }
    if (lane == 0) {
      s.scale[lr] = a.scale;
      s.zp[lr] = a.zp;
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
dequantize_segments_kernel(const __grid_constant__ Table t) {
  dependent_launch_entry();
  dependent_launch_entry();
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock +
                     threadIdx.x / kWarp;
       r < t.rows; r += warps) {
    const Segment& s = t.seg[find_segment(t, r)];
    const long long lr = r - s.row0;
    const int g = s.g;
    const int8_t* qr = s.q + lr * g;
    float* outr = s.x + lr * g;
    const int valid = (int)min((long long)g, s.numel - lr * g);
    // the row's map: one load by lane 0, broadcast to the warp
    float sc = 0.0f, z = 0.0f;
    if (lane == 0) {
      sc = s.scale[lr];
      z = s.zp[lr];
    }
    const Affine a{__shfl_sync(0xffffffffu, sc, 0),
                   __shfl_sync(0xffffffffu, z, 0)};
    if (s.vec) {
      for (int i4 = lane; i4 < (g >> 2); i4 += kWarp) {
        const int j = 4 * i4;
        const char4 c = reinterpret_cast<const char4*>(qr)[i4];
        const float4 v = make_float4(
            dequantize((float)c.x, a), dequantize((float)c.y, a),
            dequantize((float)c.z, a), dequantize((float)c.w, a));
        if (j + 4 <= valid) {
          reinterpret_cast<float4*>(outr)[i4] = v;
        } else {
          if (j < valid) outr[j] = v.x;
          if (j + 1 < valid) outr[j + 1] = v.y;
          if (j + 2 < valid) outr[j + 2] = v.z;
        }
      }
    } else {
      for (int j = lane; j < valid; j += kWarp)
        outr[j] = dequantize((float)qr[j], a);
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// The launch table of leaves[0, n); -1 if n is out of range or a leaf
// is not one the kernels take.
int make_table(const Leaf* leaves, int n, bool quantize, Table* t) {
  if (n < 1 || n > kMaxSegments) return -1;
  long long row0 = 0;
  for (int i = 0; i < n; ++i) {
    const Leaf& l = leaves[i];
    if (l.numel < 1 || l.g < 1 || l.g > (1 << 30)) return -1;
    Segment& s = t->seg[i];
    s.x = (float*)l.x;
    s.q = (int8_t*)l.q;
    s.scale = (float*)l.scale;
    s.zp = (float*)l.zp;
    s.numel = l.numel;
    s.row0 = row0;
    s.g = (int)l.g;
    s.vec = l.g % 4 == 0 && aligned(l.x, 16) && aligned(l.q, 4) &&
            (!quantize || l.g <= 4 * kMaxVec * kWarp);
    row0 += (l.numel + l.g - 1) / l.g;
  }
  t->rows = row0;
  t->n = n;
  return 0;
}

// One launch of kernel over the table's rows, as a programmatic
// dependent of the grid before it on the stream.
int launch(void (*kernel)(const Table), const Table& t, void* stream) {
  const long long b = (t.rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b < 65535 ? b : 65535));
  cfg.blockDim = dim3(kRowThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, t);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int int8_quantize_segments(const void* leaves, int n,
                                      void* stream) {
  Table t;
  if (make_table((const Leaf*)leaves, n, true, &t))
    return (int)cudaErrorInvalidValue;
  return launch(quantize_segments_kernel, t, stream);
}

extern "C" int int8_dequantize_segments(const void* leaves, int n,
                                        void* stream) {
  Table t;
  if (make_table((const Leaf*)leaves, n, false, &t))
    return (int)cudaErrorInvalidValue;
  return launch(dequantize_segments_kernel, t, stream);
}
