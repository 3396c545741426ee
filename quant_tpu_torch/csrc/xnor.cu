// XNOR-popcount kernels over packed sign words (bit j of word w is the
// sign of element 32w+j, set for >= 0; pad bits are set).
//
// Replaces the TPU kernel quant_tpu/ops/binary_gemm.py `_xnor_kernel`
// (via `xnor_gemm`), and carries its contraction into the two forms the
// serving path needs:
//
//   qtt_xnor_gemm            the GEMM itself, same signature and result
//                            as the TPU kernel (pad correction included);
//   qtt_xnor_conv2d_*        implicit-GEMM binary conv over packed NHWC
//                            words and packed HWIO weights, with the
//                            epilogue of quant_tpu/ops/binary_infer.py's
//                            int8 branch (lines 312-323);
//   qtt_pack_threshold_signs_*  the producer: raw block input -> packed
//                            words, bit = (x - t >= 0) XOR (flip < 0)
//                            (threshold_sign_planes' ls-1 branch packed
//                            as quant_tpu/ops/packing.py does).
//
// What bounds them on an H100: the operands are packed 32 signs a word,
// so the conv and GEMM move few bytes and are bound by operations; these
// first versions issue XOR + POPC + ADD per 32 MACs on the CUDA cores, one
// thread per output element, far below the int8 tensor-core rate that the
// bound in PERF.md assumes. Threads of a warp take neighbouring output
// channels (weights coalesce; activation words are a warp-wide
// broadcast). The producer is bound by bytes: one warp per output word,
// lane j reads channel 32w+j (coalesced) and __ballot_sync assembles the
// word, so each input element is read once and each word written once.
// Tensor-core (b1 mma / wgmma) and fused producer->conv forms are later
// work.

#include "common.cuh"

namespace {

using qtt::from_float;
using qtt::round_to;
using qtt::to_float;

__global__ void xnor_gemm_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ bt,
                                 const float* __restrict__ vx,
                                 const float* __restrict__ vw,
                                 float* __restrict__ out, int m, int w_words,
                                 int n, int k_total) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                  threadIdx.x;
  if (idx >= static_cast<long long>(m) * n) return;
  int col = static_cast<int>(idx % n);
  int row = static_cast<int>(idx / n);
  const uint32_t* arow = a + static_cast<long long>(row) * w_words;
  int acc = 0;
  for (int w = 0; w < w_words; ++w) {
    acc += __popc(arow[w] ^ bt[static_cast<long long>(w) * n + col]);
  }
  // Same arithmetic and order as binary_gemm.py:50-51 and :117-119; the
  // _rn intrinsics keep nvcc from contracting into an FMA.
  int k_padded = w_words * 32;
  float r = __fmul_rn(__fmul_rn(static_cast<float>(k_padded - 2 * acc),
                                vx[row]), vw[col]);
  if (k_padded != k_total) {
    r = __fsub_rn(r, __fmul_rn(static_cast<float>(k_padded - k_total),
                               __fmul_rn(vx[row], vw[col])));
  }
  out[idx] = r;
}

template <typename OutT>
__device__ __forceinline__ void store_epilogue(OutT* out, float r,
                                               const OutT* bias);

// float32 out: (dot * (vx*vw)) + bias, each op rounded in float32.
template <>
__device__ __forceinline__ void store_epilogue<float>(float* out, float r,
                                                      const float* bias) {
  *out = bias ? __fadd_rn(r, *bias) : r;
}

// bf16 out: round the scaled dot to bf16 first, then add the bf16 bias
// and round again, as `term.astype(bf16) + bias.astype(bf16)` does.
template <>
__device__ __forceinline__ void store_epilogue<__nv_bfloat16>(
    __nv_bfloat16* out, float r, const __nv_bfloat16* bias) {
  __nv_bfloat16 v = from_float<__nv_bfloat16>(r);
  if (bias) {
    v = from_float<__nv_bfloat16>(__fadd_rn(to_float(v), to_float(*bias)));
  }
  *out = v;
}

template <typename OutT>
__global__ void xnor_conv2d_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ vx, const float* __restrict__ vw,
    const OutT* __restrict__ bias, OutT* __restrict__ out, int n_batch,
    int h, int wd, int wc, int c, int o, int oh, int ow, int kh, int kw,
    int stride, int pad) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                  threadIdx.x;
  long long total = static_cast<long long>(n_batch) * oh * ow * o;
  if (idx >= total) return;
  int oc = static_cast<int>(idx % o);
  long long p = idx / o;
  int ox = static_cast<int>(p % ow);
  p /= ow;
  int oy = static_cast<int>(p % oh);
  int b = static_cast<int>(p / oh);

  // Taps outside the image are skipped: the JAX conv pads the +-1
  // operand with zeros, which no bit can hold. A valid tap adds
  // C - 2*popc(xor); pad bits are set in both operands and XOR to 0.
  int dot = 0;
  for (int i = 0; i < kh; ++i) {
    int iy = oy * stride - pad + i;
    if (iy < 0 || iy >= h) continue;
    for (int j = 0; j < kw; ++j) {
      int ix = ox * stride - pad + j;
      if (ix < 0 || ix >= wd) continue;
      const uint32_t* xp =
          x + ((static_cast<long long>(b) * h + iy) * wd + ix) * wc;
      const uint32_t* wp =
          w + static_cast<long long>(i * kw + j) * wc * o + oc;
      int pc = 0;
      for (int q = 0; q < wc; ++q) {
        pc += __popc(xp[q] ^ wp[static_cast<long long>(q) * o]);
      }
      dot += c - 2 * pc;
    }
  }
  float r = __fmul_rn(static_cast<float>(dot), __fmul_rn(vx[b], vw[oc]));
  store_epilogue<OutT>(out + idx, r, bias ? bias + oc : nullptr);
}

template <typename T>
__global__ void pack_threshold_signs_kernel(const T* __restrict__ x,
                                            const float* __restrict__ thresh,
                                            const float* __restrict__ flip,
                                            uint32_t* __restrict__ out,
                                            long long pixels, int c, int wc) {
  long long gtid = blockIdx.x * static_cast<long long>(blockDim.x) +
                   threadIdx.x;
  long long word = gtid >> 5;
  int lane = threadIdx.x & 31;
  // blockDim is a multiple of 32, so a warp leaves together and the
  // ballot below always sees all 32 lanes.
  if (word >= pixels * wc) return;
  long long pix = word / wc;
  int ch = static_cast<int>(word % wc) * 32 + lane;
  bool bit = true;  // pad channels are set
  if (ch < c) {
    // The threshold is rounded to x's dtype first (thresh.astype(x.dtype)
    // in binary_infer.py:180); the sign of x - t survives the rounding of
    // the difference, so comparing the float32 difference is exact.
    float u = __fsub_rn(to_float(x[pix * c + ch]), round_to<T>(thresh[ch]));
    bit = (u >= 0.0f) != (flip[ch] < 0.0f);
  }
  unsigned bits = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[word] = bits;
}

template <typename OutT>
int launch_conv(const void* x, const void* w, const void* vx, const void* vw,
                const void* bias, void* out, int n, int h, int wd, int wc,
                int c, int o, int oh, int ow, int kh, int kw, int stride,
                int pad, void* stream) {
  long long total = static_cast<long long>(n) * oh * ow * o;
  if (total > 0) {
    xnor_conv2d_kernel<OutT>
        <<<qtt::blocks_for(total), qtt::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
            static_cast<const float*>(vx), static_cast<const float*>(vw),
            static_cast<const OutT*>(bias), static_cast<OutT*>(out), n, h, wd,
            wc, c, o, oh, ow, kh, kw, stride, pad);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack(const void* x, const void* thresh, const void* flip,
                void* out, long long pixels, int c, int wc, void* stream) {
  long long threads = pixels * wc * 32;
  if (threads > 0) {
    pack_threshold_signs_kernel<T>
        <<<qtt::blocks_for(threads), qtt::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const float*>(thresh),
            static_cast<const float*>(flip), static_cast<uint32_t*>(out),
            pixels, c, wc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qtt_xnor_gemm(const void* a, const void* bt, const void* vx,
                             const void* vw, void* out, int m, int w_words,
                             int n, int k_total, void* stream) {
  long long total = static_cast<long long>(m) * n;
  if (total > 0) {
    xnor_gemm_kernel<<<qtt::blocks_for(total), qtt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(bt),
        static_cast<const float*>(vx), static_cast<const float*>(vw),
        static_cast<float*>(out), m, w_words, n, k_total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qtt_xnor_conv2d_f32(const void* x, const void* w,
                                   const void* vx, const void* vw,
                                   const void* bias, void* out, int n, int h,
                                   int wd, int wc, int c, int o, int oh,
                                   int ow, int kh, int kw, int stride,
                                   int pad, void* stream) {
  return launch_conv<float>(x, w, vx, vw, bias, out, n, h, wd, wc, c, o, oh,
                            ow, kh, kw, stride, pad, stream);
}

extern "C" int qtt_xnor_conv2d_bf16(const void* x, const void* w,
                                    const void* vx, const void* vw,
                                    const void* bias, void* out, int n, int h,
                                    int wd, int wc, int c, int o, int oh,
                                    int ow, int kh, int kw, int stride,
                                    int pad, void* stream) {
  return launch_conv<__nv_bfloat16>(x, w, vx, vw, bias, out, n, h, wd, wc, c,
                                    o, oh, ow, kh, kw, stride, pad, stream);
}

extern "C" int qtt_pack_threshold_signs_f32(const void* x, const void* thresh,
                                            const void* flip, void* out,
                                            long long pixels, int c, int wc,
                                            void* stream) {
  return launch_pack<float>(x, thresh, flip, out, pixels, c, wc, stream);
}

extern "C" int qtt_pack_threshold_signs_bf16(const void* x,
                                             const void* thresh,
                                             const void* flip, void* out,
                                             long long pixels, int c, int wc,
                                             void* stream) {
  return launch_pack<__nv_bfloat16>(x, thresh, flip, out, pixels, c, wc,
                                    stream);
}
