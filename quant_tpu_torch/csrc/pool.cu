// 3x3 / stride-2 / pad-1 max pool over NHWC, -inf padding, W even: the
// ResNet stem pool. With pad_top = 1 (the image) H is even; with
// pad_top = 0 (a row band of an H-banded model, parallel/spatial.py) the
// input is the band with the one row above it that the rank received
// from its neighbour, so H is odd and output row oy reads rows 2oy..2oy+2.
// Either way the output has H / 2 rows and nothing pads the bottom.
//
// Replaces the TPU kernel quant_tpu/ops/pool.py `_pool_kernel` (via
// `max_pool_3x3_s2_p1`). The TPU version's W-stage/H-stage relayout
// existed only to suit Mosaic's lowering and is not carried over.
//
// out[b, oy, ox, c] is the max of x[b, 2oy+di, 2ox+dj, c] over di, dj in
// -1..1 inside the map, as lax.reduce_window with lax.max computes it: a
// window that holds a NaN yields NaN (`max.NaN`; fmaxf would drop it).
// The max picks one of its inputs, so the result is exact in f32 and
// bf16; only a NaN's payload may differ (the canonical NaN comes out).
//
// What bounds it on an H100: bytes. It reads the (N, H, W, C) map once
// and writes a quarter of it: 257 MB at the serving shape (128, 112, 112,
// 64) bf16, 0.077 ms at 3.35 TB/s. The design keeps the instructions per
// byte low enough that the memory sets the pace:
//   - a thread owns one output column ox and one vector of channels, 16
//     bytes where C and the pointers allow it, else 8, 4 or 2 (the
//     template's E, chosen by the launcher), and walks down kPoolRows
//     output rows. A block is a run of (ox, vector) items of one image
//     times a tile of rows, so a thread finds its coordinates with one
//     division and its loop has none; offsets inside a row are 32-bit,
//     rows advance a 64-bit pointer;
//   - a vertical carry: input row 2oy+1 is row 2(oy+1)-1 of the next
//     output, so its horizontal 3-max stays in registers and each output
//     row reads two new input rows. A tile's first row reads its halo
//     row 2oy-1, or -inf at oy = 0, as the Pallas kernel's halo block
//     (with pad_top = 0 every row is shifted down by one and row 0 is
//     real: the first tile reads it too);
//   - the horizontal overlap: column 2ox+1 is column 2(ox+1)-1 of the
//     neighbouring item, cv lanes away; L1 serves that second read
//     (ld.global.nc). Handing it over by __shfl_up_sync instead (the
//     `pool_shuffle` variant of probes/xnor_variants.py) costs the same
//     load for the lanes below cv and adds the shuffles.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kPoolRows = 8;          // output rows a thread walks down
constexpr int kPoolMaxThreads = 256;
constexpr int kMaxGridY = 65535;

// -inf in every lane of a 32-bit word of T.
template <typename T>
constexpr uint32_t kNegInf = sizeof(T) == 4 ? 0xff800000u : 0xff80ff80u;

// The max of two 32-bit words lane by lane as T, NaN-propagating.
template <typename T>
__device__ __forceinline__ uint32_t max_word(uint32_t a, uint32_t b);

template <>
__device__ __forceinline__ uint32_t max_word<float>(uint32_t a, uint32_t b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;"
      : "=f"(d)
      : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(d);
}

template <>
__device__ __forceinline__ uint32_t max_word<__nv_bfloat16>(uint32_t a,
                                                             uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <typename T>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(max_word<T>(a.x, b.x), max_word<T>(a.y, b.y),
                    max_word<T>(a.z, b.z), max_word<T>(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ uint2 vmax(uint2 a, uint2 b) {
  return make_uint2(max_word<T>(a.x, b.x), max_word<T>(a.y, b.y));
}

template <typename T>
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  return max_word<T>(a, b);
}

template <typename T>
__device__ __forceinline__ uint16_t vmax(uint16_t a, uint16_t b) {
  static_assert(sizeof(T) == 2, "a 2-byte vector holds one bf16");
  uint16_t d;
  asm("max.NaN.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

template <typename E>
__device__ __forceinline__ E fill(uint32_t w);
template <>
__device__ __forceinline__ uint4 fill<uint4>(uint32_t w) {
  return make_uint4(w, w, w, w);
}
template <>
__device__ __forceinline__ uint2 fill<uint2>(uint32_t w) {
  return make_uint2(w, w);
}
template <>
__device__ __forceinline__ uint32_t fill<uint32_t>(uint32_t w) {
  return w;
}
template <>
__device__ __forceinline__ uint16_t fill<uint16_t>(uint32_t w) {
  return static_cast<uint16_t>(w);
}

// Grid: x = image * chunks + chunk of the row's items, y = row tile
// (grid-stride past kMaxGridY tiles). Block: a multiple of 32 threads,
// one item each; cv vectors a pixel.
template <typename T, typename E>
__global__ void __launch_bounds__(kPoolMaxThreads)
    max_pool_3x3_s2_p1_kernel(const E* __restrict__ x, E* __restrict__ out,
                              int h, int w, int cv, int chunks,
                              int pad_top) {
  const int oh = h / 2, items = (w / 2) * cv;
  const int img = blockIdx.x / chunks;
  const int item = (blockIdx.x - img * chunks) * blockDim.x + threadIdx.x;
  const bool live = item < items;
  const int ox = item / cv;
  const long long row = static_cast<long long>(w) * cv;  // input row
  // Column 2ox of input row 0: 2ox*cv + (item - ox*cv) vectors in.
  const E* xi = x + static_cast<long long>(img) * h * row + item + ox * cv;
  E* oi = out + static_cast<long long>(img) * oh * items + item;
  const E lo = fill<E>(kNegInf<T>);

  // The 3-max of input columns 2ox-1..2ox+1 of the row at p.
  auto hmax = [&](const E* p) {
    E left = lo, mid = lo, right = lo;
    if (live) {
      mid = __ldg(p);
      right = __ldg(p + cv);
    }
    if (ox > 0 && live) left = __ldg(p - cv);
    return vmax<T>(vmax<T>(left, mid), right);
  };

  const int tiles = (oh + kPoolRows - 1) / kPoolRows;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int oy0 = tile * kPoolRows;
    const int oy1 = min(oy0 + kPoolRows, oh);
    const E* p = xi + (2LL * oy0 + 1 - pad_top) * row;
    E* o = oi + static_cast<long long>(oy0) * items;
    E carry = oy0 > 0 || pad_top == 0 ? hmax(p - row) : lo;
    for (int oy = oy0; oy < oy1; ++oy) {
      const E a = hmax(p), b = hmax(p + row);
      if (live) *o = vmax<T>(vmax<T>(carry, a), b);
      carry = b;
      p += 2 * row;
      o += items;
    }
  }
}

// The route: the widest of 16, 8, 4 and 2 bytes that divides a pixel's
// channels and both pointers (ops/pool.py `vector_bytes` mirrors it).
int vector_bytes(long long row_bytes, const void* x, const void* out) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  int v = 16;
  while (v > 2 && (row_bytes % v || a % v)) v /= 2;
  return v;
}

template <typename T, typename E>
int launch_as(const void* x, void* out, int n, int h, int w, int c,
              int pad_top, cudaStream_t stream) {
  const long long cv = static_cast<long long>(c) * sizeof(T) / sizeof(E);
  const long long items = (w / 2) * cv;
  if (static_cast<long long>(w) * cv > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // Chunks of at most kPoolMaxThreads items, split evenly, whole warps.
  const long long chunks = (items + kPoolMaxThreads - 1) / kPoolMaxThreads;
  const int threads =
      static_cast<int>(((items + chunks - 1) / chunks + 31) / 32 * 32);
  const long long tiles = (h / 2 + kPoolRows - 1) / kPoolRows;
  if (n * chunks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(n * chunks),
            static_cast<unsigned>(tiles < kMaxGridY ? tiles : kMaxGridY));
  max_pool_3x3_s2_p1_kernel<T, E><<<grid, threads, 0, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(out), h, w,
      static_cast<int>(cv), static_cast<int>(chunks), pad_top);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c,
           int pad_top, void* stream) {
  if (pad_top != 0 && pad_top != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || h < 2 || w < 2 || c <= 0)
    return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(static_cast<long long>(c) * sizeof(T), x, out)) {
    case 16:
      return launch_as<T, uint4>(x, out, n, h, w, c, pad_top, s);
    case 8:
      return launch_as<T, uint2>(x, out, n, h, w, c, pad_top, s);
    case 4:
      return launch_as<T, uint32_t>(x, out, n, h, w, c, pad_top, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_as<T, uint16_t>(x, out, n, h, w, c, pad_top, s);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int qtt_max_pool_3x3_s2_p1_f32(const void* x, void* out, int n,
                                          int h, int w, int c, int pad_top,
                                          void* stream) {
  return launch<float>(x, out, n, h, w, c, pad_top, stream);
}

extern "C" int qtt_max_pool_3x3_s2_p1_bf16(const void* x, void* out, int n,
                                           int h, int w, int c, int pad_top,
                                           void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, pad_top, stream);
}

extern "C" int qtt_max_pool_vector_bytes(long long row_bytes, const void* x,
                                         const void* out) {
  return vector_bytes(row_bytes, x, out);
}
