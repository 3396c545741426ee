// 3x3 / stride-2 / pad-1 max pool over NHWC, -inf padding, H and W even:
// the ResNet stem pool.
//
// Replaces the TPU kernel quant_tpu/ops/pool.py `_pool_kernel` (via
// `max_pool_3x3_s2_p1`). The TPU version's W-stage/H-stage relayout
// existed only to suit Mosaic's lowering and is not carried over.
//
// What bounds it on an H100: bytes. It reads the (N, H, W, C) map once
// and writes a quarter of it; the 8 compares per output are negligible.
// One thread per output element with the channel fastest, so a warp reads
// 32 neighbouring channels of one pixel (coalesced) and the 3x3 window's
// overlapping rows are served from L1/L2 rather than device memory. The
// max of the same 9 values is taken in float32, which is exact for f32
// and bf16 (the bf16 result converts back without rounding), so the
// result is bit-exact against F.max_pool2d / lax.reduce_window.

#include <math.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void max_pool_3x3_s2_p1_kernel(const T* __restrict__ x,
                                          T* __restrict__ out, int n, int h,
                                          int w, int c) {
  int oh = h / 2, ow = w / 2;
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                  threadIdx.x;
  long long total = static_cast<long long>(n) * oh * ow * c;
  if (idx >= total) return;
  int ch = static_cast<int>(idx % c);
  long long p = idx / c;
  int ox = static_cast<int>(p % ow);
  p /= ow;
  int oy = static_cast<int>(p % oh);
  int b = static_cast<int>(p / oh);
  float m = -INFINITY;
  for (int di = -1; di <= 1; ++di) {
    int iy = 2 * oy + di;
    if (iy < 0 || iy >= h) continue;
    for (int dj = -1; dj <= 1; ++dj) {
      int ix = 2 * ox + dj;
      if (ix < 0 || ix >= w) continue;
      float v = qtt::to_float(
          x[((static_cast<long long>(b) * h + iy) * w + ix) * c + ch]);
      m = fmaxf(m, v);
    }
  }
  out[idx] = qtt::from_float<T>(m);
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c,
           void* stream) {
  long long total = static_cast<long long>(n) * (h / 2) * (w / 2) * c;
  if (total > 0) {
    max_pool_3x3_s2_p1_kernel<T>
        <<<qtt::blocks_for(total), qtt::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<T*>(out), n, h, w, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qtt_max_pool_3x3_s2_p1_f32(const void* x, void* out, int n,
                                          int h, int w, int c, void* stream) {
  return launch<float>(x, out, n, h, w, c, stream);
}

extern "C" int qtt_max_pool_3x3_s2_p1_bf16(const void* x, void* out, int n,
                                           int h, int w, int c,
                                           void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, stream);
}
