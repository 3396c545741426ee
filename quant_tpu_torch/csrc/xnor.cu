// Binary (+-1) contractions over packed sign words (bit j of word w is the
// sign of element 32w+j, set for >= 0; pad bits past the last channel are
// set by the packers: xnor_gemm relies on that, as the TPU kernel does,
// the conv does not).
//
// qtt_xnor_gemm -- replaces quant_tpu/ops/binary_gemm.py `_xnor_kernel`
//   (via `xnor_gemm`), same signature and result, pad correction included.
//   Off every path. Bound on an H100: operations (2*M*N*K int8 tensor-core
//   ops against 1/8 of that many bytes of packed words).
//   Design: the wgmma core of wgmma_core.cuh (128x128 block tile, two
//   consumer warpgroups, s8 wgmma summing in int32), fed by a loader that
//   expands bits into bytes instead of copying them. Two producer
//   warpgroups take every other stage; each of a producer's 128 threads
//   owns one row of A (M, W) and one column of Bt (W, N) in the tile,
//   and brings their 4 words of a stage (128 channels) into the
//   producer's ring of packed words in shared memory with 4-byte
//   cp.async, three of its stages ahead (a ragged W leaves A's rows off
//   16 bytes, so neither wider copies nor TMA, whose rows must be 16-byte
//   multiples, take them). It writes them as +-16 bytes into K-major
//   tiles with the 128-byte swizzle, the same channel order in A and in B
//   (expand32), so Bt's word-major layout needs no transpose. A set bit
//   is -16, a clear one +16, so every byte product is 256 times the +-1
//   product and the dot is the accumulator >> 8, exactly (|dot| * 256 <
//   2^31 for K < 2^23). The
//   expanded tiles are generic-proxy writes that wgmma reads through the
//   async proxy: fence.proxy.async, then an arrive (128 a stage).
//   K tails: words past W, rows past M and columns past N expand to 0
//   bytes, not to the +-1 of a zero word (an all-clear word is 32 x -1 and
//   would add 32 to every dot). Pad bits are set in both operands, so
//   over whole words the dot is K_pad - 2 * popc(a ^ b), the integer of
//   the TPU kernel, and the epilogue corrects by K_pad - K in JAX's order.
//
// qtt_xnor_conv2d_* -- the same TPU kernel in the form the serving path
//   runs it: the binary conv (any kh x kw, equal stride and padding) over
//   packed NHWC activation words and packed (kh, kw, Wc, O) weights, i.e.
//   JAX's s8 x s8 -> s32 sign-plane conv (quant_tpu/ops/binary_infer.py
//   `binary_conv_int8`, :96-106) with the epilogue of its int8 branch
//   (:312-323).
//   Bound on an H100: operations. The operands are 1 bit, so a batch-128
//   forward moves ~0.4 GB but does 2*sum(MACs) int8 tensor-core ops.
//   Design: an implicit GEMM on the int8 tensor cores. Rows are output
//   pixels (M = N*OH*OW), columns output channels, K walks tap by tap and
//   then by 32-channel words: one packed word is one k-step of
//   mma.sync.m16n8k32.s8.s8.s32. A 128-thread block owns a 128x64 tile
//   (2x2 warps of 64x32, 16 MMAs per warp and word); a 4-stage cp.async
//   ring brings 8 words a stage of packed A (gathered per tap, each row's
//   pieces as wide as Wc and the base allow: 16, 8 or 4 bytes) and packed
//   B into shared memory, so the ring moves 1/8 of the bytes an int8 tile
//   would. Each lane expands its fragments in registers (expand_word): a
//   shift, an AND and a multiply-add per register, the A fragment serving
//   the warp's four N tiles and the B fragment its four M tiles. What
//   bounds this form is the instruction stream, not the tensor cores: per
//   warp and word the SASS of one unrolled stage holds 147 instructions,
//   16 of them MMAs and most of the rest integer (LOP3, IMAD, SHF) and
//   shared-memory loads, and 150 registers leave 3 blocks (12 warps) an
//   SM.
//   Zero operands: JAX pads the +-1 image with zeros, and a word holds no
//   zero (an all-clear word is 32 x -1), so cp.async's zero fill does not
//   pad. The loader keeps, per row and stage, a bit per word that is set
//   only for a tap inside the image (and k and the row inside the GEMM);
//   a clear bit expands the A word to 0 bytes. Pad channels of the last
//   word of each tap are masked to 0 bytes in B, so stray pad bits in
//   either operand add nothing. With both masks no K correction is
//   needed; ragged M, O (odd included) and K are masked, not refused.
//   Row bands: `pad_top` is the H padding above row 0 (`pad` pads W, and
//   H by default). A rank of an H-banded model (parallel/spatial.py) runs
//   the conv on its band with the halo rows it received from its
//   neighbours: pad_top = 0 where a halo sits above (those rows are real,
//   not padding), and the rows past the band's end are padding only where
//   no bottom halo was received (the valid test iy < h does that, with
//   `oh` as the caller passes it).
//   Epilogue as the JAX int8 branch, bit-exact (_rn intrinsics):
//   float(dot) * (vx[n] * vw[o]) in f32, rounded to bf16 (nearest even)
//   or kept f32, then + bias in the out dtype. Each warp stages a 16x32
//   piece of outputs in the then idle ring and stores it in 16-byte
//   chunks, a row's 64 (bf16) or 128 (f32) bytes at a time.
//   The block's tail (ops/binary_infer.py `Tail`), where one is given,
//   is applied to each chunk as it is stored: a PReLU, the residual add
//   (the residual read in the same 16-byte chunks, optionally through the
//   shortcut's eval BN: ((float(c) - mean) * mul) + bias, rounded to the
//   out dtype), a PReLU; each op rounded where PyTorch's eager ops round
//   (_rn intrinsics, no FMA), so the result equals the eager chain bit
//   for bit, NaN, +-inf and -0.0 included. The PReLU slopes are read from
//   their float32 parameters on the card and rounded to the out dtype, as
//   `.to(x.dtype)` does. The tail is a template parameter: a launch
//   without one runs the instance that has no tail code at all.
//
// qtt_xnor_conv2d_planes_* -- the conv's multi-plane form: JAX's int8
//   pass loop (binary_infer.py:280-324, fused=False) over k_a activation
//   and k_w weight planes (ls-2, ls-T, gf-k), bit for bit. Planes that
//   share a scale form a group (ls-T's two, whose JAX operand is b1 + b2;
//   ls-T weights with w_planes_share_scale). Bound by operations: 2 *
//   MACs per pair of scale groups on the int8 tensor cores. A kernel of
//   its own beside the ls-1 conv's, sharing its gather loader, valid
//   bits, B loader, pad mask, expansion and epilogue helpers. Design:
//   (1) a group's two planes come into the ring under one valid mask and
//   expand as one operand (expand_pair: +32, 0 or -32 a byte), so one MMA
//   a k-step serves the group, as JAX's b1 + b2 does; (2) one walk over
//   K serves up to 3 activation groups: each stage gathers every group's
//   A rows (they share the taps), its B words are expanded once into
//   shared memory for all warps (expand_b; the ls-1 conv's warps expand
//   their own B fragments), and each k-step issues every group's MMAs
//   into its own accumulators against the same B fragments; the warp
//   tile shrinks with the group count (PlanesTile) so the accumulators
//   stay at the ls-1 conv's 64 a thread; weight groups (and activation
//   groups past 3) are further passes; (3) the running sum
//   of the terms, each rounded to the out dtype and added in JAX's order,
//   stays in registers within a pass and in shared memory between passes,
//   and `out` is written once, with the bias and the tail (as the ls-1
//   conv's). One launch, not k_a * k_w launches and an add: the host's
//   launch time already shows at batch 128.
//
// qtt_pack_sign_planes_* -- the producer, no TPU kernel (XLA fused
//   binary_infer.py:149-206 with packing.py:27-43): one pass over the
//   raw block input x writes k planes of packed sign words, (k, pixels,
//   Wc); ls-1 is k = 1. Folded (thresh and flip given) it is
//   threshold_sign_planes: u = x - t, p_1 = sign(u), p_{i+1} = sign(u -
//   resid), resid += va_i * p_i, every op rounded to x's dtype; bit = p
//   XOR (flip < 0). Unfolded it is activation_sign_planes (:109-146) on
//   clamp(x) with per-sample scales, and a float32 scale times a bf16
//   sign promotes the chain to float32. NaN packs as +1 (binary_sign's),
//   pad bits are set. Bound by bytes: it reads x once and writes k/16 of
//   it (bf16). Design: when C % 8 == 0 and x sits on 16 bytes, each lane
//   owns 8 fixed channels (thresholds and flips loaded once) and walks
//   pixels grid-stride with one 16-byte load (bf16; two for f32),
//   neighbouring lanes on neighbouring addresses; per plane it builds 8
//   bits and the 4 lanes of a word OR theirs with two shuffles. Pad
//   groups of the last word are all-set lanes that load nothing. Any
//   other C or base takes the scalar path: one warp per word, one
//   __ballot_sync a plane.

#include "common.cuh"
#include "wgmma_core.cuh"

namespace {

using qtt::from_float;
using qtt::round_to;
using qtt::to_float;

namespace wg = qtt::wg;

constexpr int kGemmStages = 4;
constexpr int kGemmWords = wg::kRowBytes / 32;  // packed words per stage
constexpr int kGemmProducers = 2;  // expanding warpgroups
constexpr int kWordStages = 4;     // a producer's stages of words in flight
// A producer's word ring: per slot, word j of its thread t at j * 128 + t.
constexpr int kWordSmem = kWordStages * 2 * kGemmWords * 128 * 4;

// One packed word as 32 bytes, +-16 (set bit -16), in two 16-byte
// chunks: byte i of lo's register r is bit r + 8i, of hi's bit r + 4 + 8i
// (the conv's expand_word, for the four lanes of a quad at once).
__device__ __forceinline__ void expand32(uint32_t w, uint4& lo, uint4& hi) {
  const uint32_t base = 0x10101010u;
  lo = make_uint4((w & 0x01010101u) * 0xE0u + base,
                  ((w >> 1) & 0x01010101u) * 0xE0u + base,
                  ((w >> 2) & 0x01010101u) * 0xE0u + base,
                  ((w >> 3) & 0x01010101u) * 0xE0u + base);
  hi = make_uint4((w & 0x10101010u) * 0x0Eu + base,
                  ((w >> 1) & 0x10101010u) * 0x0Eu + base,
                  ((w >> 2) & 0x10101010u) * 0x0Eu + base,
                  ((w >> 3) & 0x10101010u) * 0x0Eu + base);
}

// Row `row` of a K-major tile from a stage's words: word j fills chunks
// 2j and 2j + 1, placed by the 128-byte swizzle; a word whose bit in
// `live` is clear (past W, M or N) becomes 0 bytes.
__device__ __forceinline__ void write_row(uint32_t tile, int row,
                                          const uint32_t* words,
                                          unsigned live) {
  const uint32_t at = tile + row * wg::kRowBytes;
#pragma unroll
  for (int j = 0; j < kGemmWords; ++j) {
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if ((live >> j) & 1u) expand32(words[j], lo, hi);
    wg::st_shared(at + (((2 * j) ^ (row & 7)) << 4), lo);
    wg::st_shared(at + (((2 * j + 1) ^ (row & 7)) << 4), hi);
  }
}

__global__ void __launch_bounds__(wg::threads(kGemmProducers), 1)
    xnor_gemm_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ bt,
                     const float* __restrict__ vx,
                     const float* __restrict__ vw, float* __restrict__ out,
                     int m, int w_words, int n, int k_total) {
  extern __shared__ unsigned char smem[];
  using Ring = wg::Ring<kGemmStages>;
  const Ring ring(smem, kGemmProducers * kWordSmem);
  const int m0 = blockIdx.y * wg::kBM;
  const int n0 = blockIdx.x * wg::kBN;
  const int k_tiles = (w_words + kGemmWords - 1) / kGemmWords;
  wg::gemm_block<int, kGemmStages, kGemmProducers, 56>(
      ring, k_tiles, 128,
      [&](const Ring& r, int p) {
        const int t = threadIdx.x % 128;
        const bool row_ok = m0 + t < m;
        const bool col_ok = n0 + t < n;
        const uint32_t* arow = a + static_cast<long long>(m0 + t) * w_words;
        const uint32_t* bcol = bt + n0 + t;
        // Producer p takes stages kt = p + 2u (u its own count). Bit j
        // (A) and kGemmWords + j (B): word j of stage kt exists.
        auto stage = [&](int u) { return p + kGemmProducers * u; };
        auto live = [&](int kt) {
          unsigned bits = 0;
#pragma unroll
          for (int j = 0; j < kGemmWords; ++j) {
            const bool in_k = kt * kGemmWords + j < w_words;
            bits |= (row_ok && in_k ? 1u : 0u) << j;
            bits |= (col_ok && in_k ? 1u : 0u) << (kGemmWords + j);
          }
          return bits;
        };
        // Word j of this thread in slot `slot` of its producer's word
        // ring (A: j < 4).
        auto word_at = [&](int slot, int j) {
          return r.scratch + p * kWordSmem +
                 ((slot * 2 * kGemmWords + j) * 128 + t) * 4;
        };
        auto fetch = [&](int u) {
          const int kt = stage(u);
          const unsigned bits = live(kt);
          const int slot = u % kWordStages;
#pragma unroll
          for (int j = 0; j < kGemmWords; ++j) {
            const long long w = kt * kGemmWords + j;
            if ((bits >> j) & 1u) wg::cp_async4(word_at(slot, j), arow + w);
            if ((bits >> (kGemmWords + j)) & 1u)
              wg::cp_async4(word_at(slot, kGemmWords + j), bcol + w * n);
          }
        };
#pragma unroll
        for (int u = 0; u < kWordStages - 1; ++u) {
          if (stage(u) < k_tiles) fetch(u);
          wg::cp_async_commit();
        }
        for (int u = 0, kt = p; kt < k_tiles; ++u, kt += kGemmProducers) {
          // Slot (u - 1) % kWordStages was read by this thread in step
          // u - 1; it takes the words of its stage u + kWordStages - 1.
          const int ahead = u + kWordStages - 1;
          if (stage(ahead) < k_tiles) fetch(ahead);
          wg::cp_async_commit();
          wg::cp_async_wait<kWordStages - 1>();  // stage kt's words landed
          uint32_t ca[kGemmWords], cb[kGemmWords];
#pragma unroll
          for (int j = 0; j < kGemmWords; ++j) {
            ca[j] = wg::ld_shared(word_at(u % kWordStages, j));
            cb[j] = wg::ld_shared(word_at(u % kWordStages, kGemmWords + j));
          }
          const unsigned bits = live(kt);
          const int s = kt % kGemmStages;
          wg::wait_empty(r, kt);
          write_row(r.a(s), t, ca, bits);
          write_row(r.b(s), t, cb, bits >> kGemmWords);
          wg::fence_proxy_async();
          wg::mbar_arrive(r.full(s));
        }
      },
      [&](const int* d, int ci) {
        // Same arithmetic and order as binary_gemm.py:50-51 and :117-119;
        // the _rn intrinsics keep nvcc from contracting into an FMA.
        const int k_padded = w_words * 32;
        auto value = [&](int acc, float sx, float sw) {
          float v = __fmul_rn(__fmul_rn(static_cast<float>(acc >> 8), sx),
                              sw);
          if (k_padded != k_total) {
            v = __fsub_rn(v, __fmul_rn(static_cast<float>(k_padded - k_total),
                                       __fmul_rn(sx, sw)));
          }
          return v;
        };
        const bool pairs = n % 2 == 0;  // a pair then lies on 8 bytes
        wg::for_each_pair(d, ci, [&](int row, int col, int v0, int v1) {
          const int gr = m0 + row, gc = n0 + col;
          if (gr >= m || gc >= n) return;
          const float sx = vx[gr];
          float* o = out + static_cast<long long>(gr) * n + gc;
          const float r0 = value(v0, sx, vw[gc]);
          if (gc + 1 >= n) {
            o[0] = r0;
            return;
          }
          const float r1 = value(v1, sx, vw[gc + 1]);
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(r0, r1);
          } else {
            o[0] = r0;
            o[1] = r1;
          }
        });
      });
}

// ------------------------------------------------------------------ conv

// The epilogue value: float32 out is (dot * (vx*vw)) + bias, each op
// rounded in float32; bf16 out rounds the scaled dot to bf16 first, then
// adds the bf16 bias and rounds again, as `term.astype(bf16) +
// bias.astype(bf16)` does.
template <typename OutT>
__device__ __forceinline__ OutT epilogue(float r, bool has_bias, float b);

template <>
__device__ __forceinline__ float epilogue<float>(float r, bool has_bias,
                                                 float b) {
  return has_bias ? __fadd_rn(r, b) : r;
}

template <>
__device__ __forceinline__ __nv_bfloat16 epilogue<__nv_bfloat16>(
    float r, bool has_bias, float b) {
  __nv_bfloat16 v = from_float<__nv_bfloat16>(r);
  if (has_bias) v = from_float<__nv_bfloat16>(__fadd_rn(to_float(v), b));
  return v;
}

// One group pair's term before its rounding to the out dtype: float(dot)
// * (vx * vw), each product rounded in float32 (binary_infer.py:313-317).
// The accumulator is 256 times the dot (see expand_word).
__device__ __forceinline__ float scaled(int acc, float sx, float sw) {
  return __fmul_rn(static_cast<float>(acc >> 8), __fmul_rn(sx, sw));
}

// a + b rounded to T, as `acc + term` in T does.
__device__ __forceinline__ float add_round(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 add_round(__nv_bfloat16 a,
                                                   __nv_bfloat16 b) {
  return from_float<__nv_bfloat16>(__fadd_rn(to_float(a), to_float(b)));
}

// Two neighbouring outputs in one store (dst is aligned to the pair).
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst,
                                           __nv_bfloat16 a,
                                           __nv_bfloat16 b) {
  __nv_bfloat162 p;
  p.x = a;
  p.y = b;
  *reinterpret_cast<__nv_bfloat162*>(dst) = p;
}

// A block's tail (ops/binary_infer.py `Tail`): the residual (M, O) in
// the out dtype, the shortcut BN's float32 (O,) mean, mul and bias, and
// the PReLU slopes (one float32 each); null pointers leave a step out
// (mean, mul and add are all set or all null, and only with res).
struct Tail {
  const void* res;
  const float *mean, *mul, *add;
  const float *slope_a, *slope_b;
  bool any() const {
    return res != nullptr || slope_a != nullptr || slope_b != nullptr;
  }
};

// PReLU of v with slope s (already rounded to OutT): v >= 0 ? v :
// round(s * v), as torch.where(x >= 0, x, s * x) (NaN takes s * v).
template <typename OutT>
__device__ __forceinline__ OutT prelu(OutT v, float s) {
  const float f = to_float(v);
  return f >= 0.0f ? v : from_float<OutT>(__fmul_rn(s, f));
}

// The tail of one output value v at channel oc, r its residual; sa and
// sb are the slopes rounded to OutT.
template <typename OutT>
__device__ __forceinline__ OutT tail_value(OutT v, OutT r, int oc,
                                           const Tail& t, float sa,
                                           float sb) {
  if (t.slope_a != nullptr) v = prelu(v, sa);
  if (t.res != nullptr) {
    float rf = to_float(r);
    if (t.mean != nullptr) {
      rf = round_to<OutT>(__fadd_rn(
          __fmul_rn(__fsub_rn(rf, __ldg(t.mean + oc)), __ldg(t.mul + oc)),
          __ldg(t.add + oc)));
    }
    v = from_float<OutT>(__fadd_rn(to_float(v), rf));
  }
  if (t.slope_b != nullptr) v = prelu(v, sb);
  return v;
}

// The slopes of a tail rounded to OutT, as `slope.to(x.dtype)` does.
template <typename OutT>
__device__ __forceinline__ void tail_slopes(const Tail& t, float& sa,
                                            float& sb) {
  sa = t.slope_a != nullptr ? round_to<OutT>(__ldg(t.slope_a)) : 0.0f;
  sb = t.slope_b != nullptr ? round_to<OutT>(__ldg(t.slope_b)) : 0.0f;
}

// The tail of one 16-byte chunk u of outputs at channels oc.., r its
// residual chunk: tail_value on each value.
template <typename OutT>
__device__ __forceinline__ void tail_chunk(uint4& u, const uint4& r, int oc,
                                           const Tail& t, float sa,
                                           float sb) {
  OutT* v = reinterpret_cast<OutT*>(&u);
  const OutT* rv = reinterpret_cast<const OutT*>(&r);
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(OutT)); ++e)
    v[e] = tail_value(v[e], rv[e], oc + e, t, sa, sb);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// PReLU of a register of two bf16 values with the slope pair s2: the
// product with one mul.rn.bf16x2 (two bf16 values multiply exactly in
// float32, so its one rounding is the float32 product's rounding to
// bf16), the value kept where it is >= 0 (set.ge's mask; NaN takes the
// product).
__device__ __forceinline__ uint32_t prelu2(uint32_t v, __nv_bfloat162 s2) {
  const uint32_t ge = __hge2_mask(as_bf2(v), __float2bfloat162_rn(0.0f));
  return (v & ge) | (as_u32(__hmul2(s2, as_bf2(v))) & ~ge);
}

// bf16 out: tail_value two values a register, in bf16x2 instructions.
// The PReLUs as prelu2; the add as one add.rn.bf16x2, whose one rounding
// equals the float32 sum's rounding to bf16 (float32's 24 bits are more
// than twice bf16's 8 plus two, so rounding twice changes nothing); the
// residual's BN in float32 as tail_value's.
template <>
__device__ __forceinline__ void tail_chunk<__nv_bfloat16>(
    uint4& u, const uint4& r, int oc, const Tail& t, float sa, float sb) {
  uint32_t v[4] = {u.x, u.y, u.z, u.w};
  uint32_t rr[4] = {r.x, r.y, r.z, r.w};
  const __nv_bfloat162 sa2 = __float2bfloat162_rn(sa);
  const __nv_bfloat162 sb2 = __float2bfloat162_rn(sb);
  auto bn = [&](float x, int c) {
    return __fadd_rn(
        __fmul_rn(__fsub_rn(x, __ldg(t.mean + c)), __ldg(t.mul + c)),
        __ldg(t.add + c));
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t.mean != nullptr) {
      const int c = oc + 2 * i;  // the low half's channel
      rr[i] = as_u32(__floats2bfloat162_rn(
          bn(__uint_as_float(rr[i] << 16), c),
          bn(__uint_as_float(rr[i] & 0xFFFF0000u), c + 1)));
    }
    if (t.slope_a != nullptr) v[i] = prelu2(v[i], sa2);
    if (t.res != nullptr) v[i] = as_u32(__hadd2(as_bf2(v[i]), as_bf2(rr[i])));
    if (t.slope_b != nullptr) v[i] = prelu2(v[i], sb2);
  }
  u = make_uint4(v[0], v[1], v[2], v[3]);
}

constexpr int kConvBM = 128;     // block tile: output pixels
constexpr int kConvBN = 64;      // block tile: output channels
constexpr int kConvThreads = 128;
constexpr int kConvWarpsN = 2;   // 2x2 warps of 64 pixels x 32 channels
constexpr int kConvMT = 4;       // m16 tiles per warp
constexpr int kConvNT = 4;       // n8 tiles per warp
constexpr int kKS = 8;           // packed words (k-steps of 32) per stage
constexpr int kConvStages = 4;
static_assert(kConvThreads == kConvBM, "the A loader takes one row a thread");

struct ConvShape {
  long long m;            // N*OH*OW, the GEMM's rows
  int h, w, wc, o, oh, ow, kh, kw, stride, pad, pad_top;  // pad: W
  int ktot;               // kh*kw*Wc, the GEMM's depth in words
  int cr;                 // channels in the last word of a tap (1..32)
  int va, vb;             // cp.async width in words for A and for B
};

// cp.async of 1, 2 or 4 words; the source is aligned to its width.
__device__ __forceinline__ void cp_async_words(uint32_t* smem,
                                               const uint32_t* gmem,
                                               int words) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (words == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else if (words == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Which channel a fragment byte holds is free, as long as A and B agree:
// byte i of lane t's low register is channel t + 8i of the word, of its
// high register channel t + 4 + 8i. With v = word >> t, the low
// register's bits sit on the byte LSBs of v and the high register's on
// bit 4 of each byte. A byte is -16 (0xF0) for a set bit and +16 (0x10)
// for a clear one, so every product is 256 times the +-1 product and the
// dot is the accumulator >> 8, exactly. One AND (with keep, 0 or ~0,
// folded in) and one multiply-add make a register: 0x10 + 0x01 * 0xE0 =
// 0xF0 and 0x10 + 0x10 * 0x0E = 0xF0, and no byte carries into the next;
// keep = 0 gives 0, a zero operand.
__device__ __forceinline__ void expand_word(uint32_t word, int t,
                                            uint32_t keep, uint32_t& lo,
                                            uint32_t& hi) {
  uint32_t v = word >> t;
  uint32_t base = 0x10101010u & keep;
  lo = (v & 0x01010101u & keep) * 0xE0u + base;
  hi = (v & 0x10101010u & keep) * 0x0Eu + base;
}

// Two planes that share a scale as one operand, their bytes added: 16 *
// (s_a + s_b) with s = +1 for a clear bit and -1 for a set one, i.e. +32
// (0x20, both clear), 0 (one of each) or -32 (0xE0, both set); channels
// as in expand_word. Against a +-16 or merged byte every product is
// still 256 times the product of the merged operands, so the dot stays
// the accumulator >> 8 (|acc| <= 1024 * 32 * K words < 2^31 for K < 2^16
// words). Both-set and both-clear are exclusive, so each multiply puts at
// most 0xE0 in a byte and nothing carries; keep = 0 gives 0.
__device__ __forceinline__ void expand_pair(uint32_t wa, uint32_t wb, int t,
                                            uint32_t keep, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t a = wa >> t, b = wb >> t;
  const uint32_t mlo = 0x01010101u & keep, mhi = 0x10101010u & keep;
  lo = (a & b & mlo) * 0xE0u + (~(a | b) & mlo) * 0x20u;
  hi = (a & b & mhi) * 0x0Eu + (~(a | b) & mhi) * 0x02u;
}

// P planes' words of one row or column as one operand: word 0 at p[0],
// word 1 (P = 2) a plane further, `plane` words on.
template <int P>
__device__ __forceinline__ void expand_planes(const uint32_t* p, int plane,
                                              int t, uint32_t keep,
                                              uint32_t& lo, uint32_t& hi) {
  if constexpr (P == 1) {
    expand_word(p[0], t, keep, lo, hi);
  } else {
    expand_pair(p[0], p[plane], t, keep, lo, hi);
  }
}

// All ones where bit kk of a row's valid bits is set, else 0.
__device__ __forceinline__ uint32_t keep_bit(uint32_t valid, int kk) {
  return static_cast<uint32_t>(static_cast<int>(valid << (31 - kk)) >> 31);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A word slot in a stage's A tile. Bit 2 of the word index is flipped for
// rows 4-7 of every 8, so the 8 rows a warp reads at once fall on 8
// distinct banks; a 1-, 2- or 4-word piece stays contiguous.
__device__ __forceinline__ int a_slot(int row, int kk) {
  return row * kKS + (kk ^ (((row >> 2) & 1) << 2));
}

// The A loader's row: its image (as its first pixel), its top-left input
// pixel and a cursor (tap ti, tj; word kq; depth kidx) that walks K in
// the order the stages are loaded. A row that is not `live` loads
// nothing.
struct RowCursor {
  long long img;
  int iy0, ix0;
  bool ok;
  int ti, tj, kq, kidx;
};

__device__ __forceinline__ RowCursor row_cursor(long long m, bool live,
                                                const ConvShape& s) {
  RowCursor c{0, 0, 0, live && m < s.m, 0, 0, 0, 0};
  if (c.ok) {
    int ox = static_cast<int>(m % s.ow);
    long long r = m / s.ow;
    int oy = static_cast<int>(r % s.oh);
    c.img = (r / s.oh) * s.h * s.w;
    c.iy0 = oy * s.stride - s.pad_top;
    c.ix0 = ox * s.stride - s.pad;
  }
  return c;
}

// The next stage of row `row` of the A tile: kKS words of each of P
// planes (plane p's from src + p * src_plane into dst + p * dst_plane),
// gathered tap by tap in pieces of s.va words. Returns the row's valid
// bits, one per word, set only for a tap inside the image (and k and the
// row inside the GEMM): a clear bit expands every plane's word to 0
// bytes, since the +-1 image is padded with zeros and a word holds none
// (an all-clear word is 32 x -1), so cp.async's zero fill does not pad.
template <int P>
__device__ __forceinline__ uint32_t gather_row(RowCursor& c,
                                               const ConvShape& s,
                                               uint32_t* dst, int dst_plane,
                                               const uint32_t* src,
                                               long long src_plane,
                                               int row) {
  uint32_t valid = 0;
  for (int j = 0; j < kKS; j += s.va) {
    int iy = c.iy0 + c.ti, ix = c.ix0 + c.tj;
    if (c.ok && c.kidx < s.ktot && iy >= 0 && iy < s.h && ix >= 0 &&
        ix < s.w) {
      const long long at =
          (c.img + static_cast<long long>(iy) * s.w + ix) * s.wc + c.kq;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cp_async_words(dst + p * dst_plane + a_slot(row, j),
                       src + p * src_plane + at, s.va);
      }
      valid |= ((1u << s.va) - 1u) << j;
    }
    c.kidx += s.va;
    c.kq += s.va;
    if (c.kq == s.wc) {
      c.kq = 0;
      if (++c.tj == s.kw) {
        c.tj = 0;
        ++c.ti;
      }
    }
  }
  return valid;
}

// Words k0.. (kKS rows) of the block's kConvBN columns of B into a
// stage, each row in pieces of 2^b_lg words (2^b_row_lg pieces a row).
// Rows past K and columns past O stay unloaded: a stage's k-steps stop at
// K, and columns past O are never stored.
__device__ __forceinline__ void load_b(uint32_t* dst, const uint32_t* w,
                                       int k0, int n0, const ConvShape& s,
                                       int b_lg, int b_row_lg, int tid) {
  for (int p = tid; p < (kKS << b_row_lg); p += kConvThreads) {
    int kr = p >> b_row_lg;
    int col = (p & ((1 << b_row_lg) - 1)) << b_lg;
    if (k0 + kr < s.ktot && n0 + col < s.o) {
      cp_async_words(dst + kr * kConvBN + col,
                     w + static_cast<long long>(k0 + kr) * s.o + n0 + col,
                     s.vb);
    }
  }
}

// Pad channels of a tap's last word: bytes of channels >= cr are zeroed
// in B (see expand_word for the channel each byte holds), so stray pad
// bits in either operand add nothing.
__device__ __forceinline__ void pad_masks(int cr, int t, uint32_t& lo,
                                          uint32_t& hi) {
  lo = hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t + 8 * i < cr) lo |= 0xFFu << (8 * i);
    if (t + 4 + 8 * i < cr) hi |= 0xFFu << (8 * i);
  }
}

// Bit kk set where word kt * kKS + kk is the last of its tap.
__device__ __forceinline__ uint32_t last_words(const ConvShape& s, int kt) {
  uint32_t last = 0;
  if (s.cr < 32) {
    for (int j = s.wc - 1 - (kt * kKS) % s.wc; j < kKS; j += s.wc)
      last |= 1u << j;
  }
  return last;
}

// A lane's share of the tail of one staged 16 x kCols piece of outputs
// (store_staged): the residual chunks it stores, loaded by `load` before
// the epilogue computes the piece, so that their latency overlaps that
// arithmetic. The lane's chunk q is chunk lane + 32 q of the piece, kRow
// chunks a row; none is loaded past M or O, nor where O leaves chunks off
// 16 bytes, nor where a lane stores more than 4 chunks (float32 out of
// the multi-plane conv's 64-column pieces, whose 32 registers would
// spill): store_staged then reads the residual as it stores.
template <typename OutT, int kCols>
struct TailPiece {
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(OutT));
  static constexpr int kRow = kCols / kChunk;
  static constexpr int kChunks = 16 * kRow / 32;
  static constexpr bool kAhead = kChunks <= 4;
  uint4 res[kChunks];

  __device__ __forceinline__ void load(const Tail& t, long long mt0, int col0,
                                       const ConvShape& s, int lane) {
    if constexpr (!kAhead) return;
    const OutT* r = static_cast<const OutT*>(t.res);
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = lane + 32 * q;
      const long long m = mt0 + c / kRow;
      const int col = col0 + (c % kRow) * kChunk;
      res[q] = make_uint4(0, 0, 0, 0);
      if (r != nullptr && s.o % kChunk == 0 && m < s.m && col < s.o)
        res[q] = __ldg(reinterpret_cast<const uint4*>(r + m * s.o + col));
    }
  }
};

// Stores a warp's staged 16 x kCols piece of outputs (row pitch kCols
// plus one 16-byte chunk, so the pair writes meet no bank conflict) at
// rows mt0.. and columns col0.. of out, in 16-byte chunks where O keeps
// them on 16 bytes; rows past M and columns past O are not stored. With
// kTail, each value takes the tail (tail_chunk, tail_value) on its way
// out, its residual from `piece`, or read as it is stored where `piece`
// holds none.
template <typename OutT, int kCols, bool kTail>
__device__ __forceinline__ void store_staged(
    const OutT* tile, OutT* out, long long mt0, int col0, const ConvShape& s,
    int lane, const Tail& tail, const TailPiece<OutT, kCols>& piece,
    float sa, float sb) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(OutT));
  constexpr int kPitch = kCols + kChunk;
  constexpr int kRow = kCols / kChunk;  // chunks a row
  const bool vec = s.o % kChunk == 0;   // whole chunks lie on 16 B
  const OutT* res = static_cast<const OutT*>(tail.res);
  // Chunk c of the piece, the lane's chunk q.
  auto store = [&](int c, int q) {
    int r = c / kRow;
    int cc = (c % kRow) * kChunk;
    long long m = mt0 + r;
    if (m >= s.m || col0 + cc >= s.o) return;
    const OutT* src = tile + r * kPitch + cc;
    const long long at = m * s.o + col0 + cc;
    OutT* o = out + at;
    if (vec) {
      uint4 u = *reinterpret_cast<const uint4*>(src);
      if constexpr (kTail) {
        uint4 rc = make_uint4(0, 0, 0, 0);
        if constexpr (TailPiece<OutT, kCols>::kAhead) {
          rc = piece.res[q];
        } else if (res != nullptr) {
          rc = __ldg(reinterpret_cast<const uint4*>(res + at));
        }
        tail_chunk<OutT>(u, rc, col0 + cc, tail, sa, sb);
      }
      *reinterpret_cast<uint4*>(o) = u;
    } else {
      for (int e = 0; e < kChunk && col0 + cc + e < s.o; ++e) {
        OutT v = src[e];
        if constexpr (kTail) {
          v = tail_value(v, res != nullptr ? res[at + e] : v, col0 + cc + e,
                         tail, sa, sb);
        }
        o[e] = v;
      }
    }
  };
  if constexpr (kTail) {
#pragma unroll
    for (int q = 0; q < TailPiece<OutT, kCols>::kChunks; ++q)
      store(lane + 32 * q, q);
  } else {
    for (int c = lane; c < 16 * kRow; c += 32) store(c, 0);
  }
}

// The serving path's ls-1 conv: one activation plane against one weight
// plane; with kTail, the tail applied as the outputs are stored.
template <typename OutT, bool kTail>
__global__ void __launch_bounds__(kConvThreads)
    xnor_conv2d_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ wt,
                       const float* __restrict__ vx,
                       const float* __restrict__ vw,
                       const OutT* __restrict__ bias, OutT* __restrict__ out,
                       ConvShape s, Tail tail) {
  __shared__ __align__(16) uint32_t sa[kConvStages][kConvBM * kKS];
  __shared__ __align__(16) uint32_t sb[kConvStages][kKS * kConvBN];
  __shared__ uint32_t sv[kConvStages][kConvBM];  // valid bit per row, word

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row / column group
  const int t = lane & 3;         // k-byte group
  const int wm = (tid >> 5) / kConvWarpsN;
  const int wn = (tid >> 5) % kConvWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.x) * kConvBM;
  const int n0 = blockIdx.y * kConvBN;

  RowCursor cur = row_cursor(m0 + tid, true, s);  // this thread's A row
  const int b_lg = s.vb == 4 ? 2 : s.vb - 1;       // log2 of vb
  const int b_row_lg = 6 - b_lg;                   // pieces per B row
  static_assert(kConvBN == 64, "b_row_lg assumes 64 columns");
  uint32_t pad_lo, pad_hi;
  pad_masks(s.cr, t, pad_lo, pad_hi);
  const int swz = ((g >> 2) & 1) << 2;  // a_slot's flip for this lane's rows

  auto load_stage = [&](int slot, int st) {
    sv[slot][tid] = gather_row<1>(cur, s, sa[slot], 0, x, 0, tid);
    load_b(sb[slot], wt, st * kKS, n0, s, b_lg, b_row_lg, tid);
  };

  int acc[kConvMT][kConvNT][4];
#pragma unroll
  for (int i = 0; i < kConvMT; ++i)
#pragma unroll
    for (int j = 0; j < kConvNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int stages = (s.ktot + kKS - 1) / kKS;
#pragma unroll
  for (int st = 0; st < kConvStages - 1; ++st) {
    if (st < stages) load_stage(st, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < stages; ++kt) {
    // Stage kt has landed; every warp is done with stage kt - 1, whose
    // buffers the next load reuses.
    cp_async_wait<kConvStages - 2>();
    __syncthreads();
    int next = kt + kConvStages - 1;
    if (next < stages) load_stage(next % kConvStages, next);
    cp_async_commit();

    const int slot = kt % kConvStages;
    const uint32_t* A = sa[slot];
    const uint32_t* B = sb[slot] + wn * 32 + g;
    uint32_t vm[kConvMT][2];
#pragma unroll
    for (int i = 0; i < kConvMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        vm[i][hh] = sv[slot][wm * 64 + i * 16 + hh * 8 + g];
    const uint32_t last = last_words(s, kt);
    const int depth = min(kKS, s.ktot - kt * kKS);  // k-steps in the stage
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      if (kk >= depth) break;
      uint32_t bf[kConvNT][2];
#pragma unroll
      for (int j = 0; j < kConvNT; ++j) {
        expand_word(B[kk * kConvBN + j * 8], t, ~0u, bf[j][0], bf[j][1]);
      }
      if ((last >> kk) & 1u) {
#pragma unroll
        for (int j = 0; j < kConvNT; ++j) {
          bf[j][0] &= pad_lo;
          bf[j][1] &= pad_hi;
        }
      }
#pragma unroll
      for (int i = 0; i < kConvMT; ++i) {
        uint32_t af[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          int row = wm * 64 + i * 16 + hh * 8 + g;
          // All ones if the word is a valid tap of a valid row, else 0.
          uint32_t keep = keep_bit(vm[i][hh], kk);
          expand_word(A[row * kKS + (kk ^ swz)], t, keep, af[hh],
                      af[2 + hh]);
        }
#pragma unroll
        for (int j = 0; j < kConvNT; ++j) mma_s8(acc[i][j], af, bf[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it stages the epilogue

  // Epilogue: c[0], c[1] are row g, columns 2t, 2t+1; c[2], c[3] row
  // g+8. Each warp writes one 16x32 m-tile of outputs to shared memory,
  // then stores it row by row in 16-byte chunks.
  const bool has_bias = bias != nullptr;
  float cw[kConvNT][2], cb[kConvNT][2];  // this lane's columns, loaded once
#pragma unroll
  for (int j = 0; j < kConvNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int oc = n0 + wn * 32 + j * 8 + 2 * t + e;
      cw[j][e] = oc < s.o ? vw[oc] : 0.0f;
      cb[j][e] = oc < s.o && has_bias ? to_float(bias[oc]) : 0.0f;
    }
  }
  constexpr int kPitch = 32 + 16 / static_cast<int>(sizeof(OutT));
  static_assert(4 * 16 * kPitch * sizeof(OutT) <= sizeof(sa), "staging");
  OutT* tile = reinterpret_cast<OutT*>(&sa[0][0]) + (tid >> 5) * 16 * kPitch;
  const long long pix = static_cast<long long>(s.oh) * s.ow;
  const bool narrow = s.m <= 0xFFFFFFFFLL;  // 32-bit division suffices
  const int col0 = n0 + wn * 32;
  float slope_a = 0.0f, slope_b = 0.0f;
  if constexpr (kTail) tail_slopes<OutT>(tail, slope_a, slope_b);
#pragma unroll
  for (int i = 0; i < kConvMT; ++i) {
    const long long mt0 = m0 + wm * 64 + i * 16;
    TailPiece<OutT, 32> piece;
    if constexpr (kTail) piece.load(tail, mt0, col0, s, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      long long m = mt0 + hh * 8 + g;
      if (m >= s.m) m = s.m - 1;  // any image: the row is not stored
      float sx = vx[narrow ? static_cast<unsigned>(m) /
                                 static_cast<unsigned>(pix)
                           : m / pix];
#pragma unroll
      for (int j = 0; j < kConvNT; ++j) {
        store_pair(tile + (hh * 8 + g) * kPitch + j * 8 + 2 * t,
                   epilogue<OutT>(scaled(acc[i][j][2 * hh], sx, cw[j][0]),
                                  has_bias, cb[j][0]),
                   epilogue<OutT>(scaled(acc[i][j][2 * hh + 1], sx, cw[j][1]),
                                  has_bias, cb[j][1]));
      }
    }
    __syncwarp();
    store_staged<OutT, 32, kTail>(tile, out, mt0, col0, s, lane, tail,
                                  piece, slope_a, slope_b);
    __syncwarp();
  }
}

// The multi-plane form's extra shape: ga activation groups of pa planes
// and gw weight groups of pw planes (pa, pw = 2 where a scale covers two
// planes, as ls-T's), the planes' strides in words, and the batch.
struct PlaneShape {
  int ga, pa, gw, pw, n;
  long long x_plane, w_plane;
};

// The multi-plane conv's tile for GA activation groups a pass. Each warp
// holds kMT m16 tiles of every group against kNT n8 tiles: GA * kMT * kNT
// MMAs a k-step against one set of expanded B fragments, and 64
// accumulators a thread (48 at GA = 3), as many as the ls-1 conv's. At GA
// <= 2 a warp spans all 64 columns (4 x 1 warps), so each A fragment is
// expanded by one warp only; B comes expanded (expand_b).
template <int GA>
struct PlanesTile {
  static constexpr int kMT = GA == 1 ? 2 : 1;
  static constexpr int kNT = GA == 3 ? 4 : 8;
  static constexpr int kWN = kConvBN / (8 * kNT);  // warps across N
  static constexpr int kWM = 4 / kWN;              // warps across M
  static constexpr int kBM = kWM * 16 * kMT;       // pixels a block
  static constexpr int kRows = GA * kBM;           // A tile rows: group-major
  static constexpr int kAcc = kMT * kNT * 4;       // accumulators a group
  static_assert(kRows <= kConvThreads, "one A row a thread");
};

// Blocks an SM the multi-plane kernel's registers must allow (ptxas caps
// them at 168 a thread), as the ls-1 conv's 150 do.
constexpr int kPlanesBlocks = 3;

// Dynamic shared memory of a multi-plane block: the ring, each stage PA
// A planes (kConvThreads rows of kKS words), PW B planes and the rows'
// valid bits; the stage's B expanded (kEB words: 32 bytes a word, see
// expand_b); then, where the block runs more than one pass, the running
// sum (kAcc floats a thread).
template <int GA, int PA, int PW>
struct PlanesSmem {
  static constexpr int kA = kConvThreads * kKS;  // words of an A plane
  static constexpr int kB = kKS * kConvBN;       // words of a B plane
  static constexpr int kStage = PA * kA + PW * kB + kConvThreads;
  static constexpr int kEB = kB * 8;             // words of expanded B
  static constexpr int kRing = (kConvStages * kStage + kEB) * 4;  // bytes
  static constexpr int kSum = PlanesTile<GA>::kAcc * kConvThreads * 4;
};

// A stage's B words (PW planes, merged) expanded once for every warp:
// word (kk, col) becomes the 32 bytes at (kk * kConvBN + col) * 32, lane
// t's two fragment registers (expand_word's lo, hi) at byte 8t, so a
// lane reads its pair with one 8-byte load and a warp's 32 loads of an
// n8 tile are 256 contiguous bytes. Pad channels of a tap's last word
// are zeroed here. Each thread expands kB / kConvThreads words.
template <int PW>
__device__ __forceinline__ void expand_b(uint4* eb, const uint32_t* b,
                                         int plane, uint32_t last,
                                         const ConvShape& s, int tid) {
#pragma unroll
  for (int q = 0; q < kKS * kConvBN / kConvThreads; ++q) {
    const int w = q * kConvThreads + tid;  // kk * kConvBN + col
    uint32_t r[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      expand_planes<PW>(b + w, plane, t, ~0u, r[2 * t], r[2 * t + 1]);
    }
    if ((last >> (w / kConvBN)) & 1u) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t lo, hi;
        pad_masks(s.cr, t, lo, hi);
        r[2 * t] &= lo;
        r[2 * t + 1] &= hi;
      }
    }
    eb[2 * w] = make_uint4(r[0], r[1], r[2], r[3]);
    eb[2 * w + 1] = make_uint4(r[4], r[5], r[6], r[7]);
  }
}

// JAX's int8 pass loop (weight groups outer, activation groups inner)
// over plane groups, in passes: a pass takes weight group gj against GA
// activation groups at once (ga0..ga0 + gn - 1), one walk over K. Planes
// that share a scale come in as one merged operand (expand_pair). Each
// stage gathers the A rows of every group, which share the tap geometry
// and the valid bits, and its B is expanded once into shared memory for
// every warp and group (expand_b): a warp loads each B fragment with one
// 8-byte load and expands only its A fragments. The epilogue adds the
// pass's terms, each rounded to OutT, to the running sum in JAX's order,
// rounded after every add; the sum stays in registers within a pass and
// in shared memory between passes, and `out` is stored once, with the
// bias (and with kTail the tail), after the last.
template <typename OutT, int GA, int PA, int PW, bool kTail>
__global__ void __launch_bounds__(kConvThreads, kPlanesBlocks)
    xnor_conv2d_planes_kernel(const uint32_t* __restrict__ x,
                              const uint32_t* __restrict__ wt,
                              const float* __restrict__ vx,
                              const float* __restrict__ vw,
                              const OutT* __restrict__ bias,
                              OutT* __restrict__ out, ConvShape s,
                              PlaneShape pl, Tail tail) {
  using T = PlanesTile<GA>;
  using S = PlanesSmem<GA, PA, PW>;
  extern __shared__ __align__(16) uint32_t planes_smem[];
  uint32_t* const smem = planes_smem;
  uint4* const eb = reinterpret_cast<uint4*>(smem + kConvStages * S::kStage);
  float* sum = reinterpret_cast<float*>(smem) + S::kRing / 4;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row / column group
  const int t = lane & 3;         // k-byte group
  const int wm = (tid >> 5) / T::kWN;
  const int wn = (tid >> 5) % T::kWN;
  const long long m0 = static_cast<long long>(blockIdx.x) * T::kBM;
  const int n0 = blockIdx.y * kConvBN;
  const int grp = tid / T::kBM;   // this thread's A row: group grp's pixel
  const long long my_m = m0 + tid % T::kBM;

  const int b_lg = s.vb == 4 ? 2 : s.vb - 1;
  const int b_row_lg = 6 - b_lg;
  const int swz = ((g >> 2) & 1) << 2;
  const int stages = (s.ktot + kKS - 1) / kKS;
  const int chunks = (pl.ga + GA - 1) / GA;
  const int passes = chunks * pl.gw;
  auto ring = [&](int slot) { return smem + slot * S::kStage; };

  for (int pass = 0; pass < passes; ++pass) {
    const int gj = pass / chunks;            // weight group
    const int ga0 = (pass % chunks) * GA;    // first activation group
    const int gn = min(GA, pl.ga - ga0);     // groups live in this pass
    RowCursor cur = row_cursor(my_m, tid < T::kRows && grp < gn, s);
    const uint32_t* xp = x + static_cast<long long>(ga0 + grp) * PA *
                                 pl.x_plane;
    const uint32_t* wp = wt + static_cast<long long>(gj) * PW * pl.w_plane;

    auto load_stage = [&](int slot, int st) {
      uint32_t* base = ring(slot);
      base[PA * S::kA + PW * S::kB + tid] =
          gather_row<PA>(cur, s, base, S::kA, xp, pl.x_plane, tid);
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        load_b(base + PA * S::kA + q * S::kB, wp + q * pl.w_plane,
               st * kKS, n0, s, b_lg, b_row_lg, tid);
      }
    };

    int acc[GA][T::kMT][T::kNT][4];
#pragma unroll
    for (int a = 0; a < GA; ++a)
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < T::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][i][j][e] = 0;

#pragma unroll
    for (int st = 0; st < kConvStages - 1; ++st) {
      if (st < stages) load_stage(st, st);
      cp_async_commit();
    }

    for (int kt = 0; kt < stages; ++kt) {
      // Stage kt has landed; every warp is done with stage kt - 1 and
      // with the expanded B, which stage kt's now replaces.
      cp_async_wait<kConvStages - 2>();
      __syncthreads();
      int next = kt + kConvStages - 1;
      if (next < stages) load_stage(next % kConvStages, next);
      cp_async_commit();

      const uint32_t* A = ring(kt % kConvStages);
      expand_b<PW>(eb, A + PA * S::kA, S::kB, last_words(s, kt), s, tid);
      __syncthreads();
      const uint2* B = reinterpret_cast<const uint2*>(eb) +
                       (wn * (8 * T::kNT) + g) * 4 + t;
      const uint32_t* V = A + PA * S::kA + PW * S::kB;
      uint32_t vm[GA][T::kMT][2];
#pragma unroll
      for (int a = 0; a < GA; ++a)
#pragma unroll
        for (int i = 0; i < T::kMT; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            vm[a][i][hh] =
                V[a * T::kBM + (wm * T::kMT + i) * 16 + hh * 8 + g];
      const int depth = min(kKS, s.ktot - kt * kKS);
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        if (kk >= depth) break;
        uint32_t bf[T::kNT][2];
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) {
          const uint2 v = B[(kk * kConvBN + j * 8) * 4];
          bf[j][0] = v.x;
          bf[j][1] = v.y;
        }
#pragma unroll
        for (int a = 0; a < GA; ++a) {
#pragma unroll
          for (int i = 0; i < T::kMT; ++i) {
            uint32_t af[4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              int row = a * T::kBM + (wm * T::kMT + i) * 16 + hh * 8 + g;
              expand_planes<PA>(A + row * kKS + (kk ^ swz), S::kA, t,
                                keep_bit(vm[a][i][hh], kk), af[hh],
                                af[2 + hh]);
            }
#pragma unroll
            for (int j = 0; j < T::kNT; ++j)
              mma_s8(acc[a][i][j], af, bf[j]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it stages the epilogue

    // This pass's terms into the running sum, as in the ls-1 epilogue:
    // c[0], c[1] are row g, columns 2t, 2t+1; c[2], c[3] row g+8.
    const bool first = pass == 0, final_pass = pass == passes - 1;
    float cw[T::kNT][2];  // vw of weight group gj at this lane's columns
    OutT cb[T::kNT][2];   // the bias, added after the last term
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int oc = n0 + wn * (8 * T::kNT) + j * 8 + 2 * t + e;
        cw[j][e] = oc < s.o ? vw[static_cast<long long>(gj) * s.o + oc]
                            : 0.0f;
        cb[j][e] = oc < s.o && bias != nullptr ? bias[oc]
                                               : from_float<OutT>(0.0f);
      }
    }
    float slope_a = 0.0f, slope_b = 0.0f;
    if constexpr (kTail) {
      if (final_pass) tail_slopes<OutT>(tail, slope_a, slope_b);
    }
    constexpr int kCols = 8 * T::kNT;
    constexpr int kPitch = kCols + 16 / static_cast<int>(sizeof(OutT));
    static_assert(4 * 16 * kPitch * sizeof(OutT) <= S::kRing, "staging");
    OutT* tile = reinterpret_cast<OutT*>(smem) + (tid >> 5) * 16 * kPitch;
    const long long pix = static_cast<long long>(s.oh) * s.ow;
    const bool narrow = s.m <= 0xFFFFFFFFLL;
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
      const long long mt0 = m0 + (wm * T::kMT + i) * 16;
      TailPiece<OutT, kCols> piece;
      if constexpr (kTail) {
        if (final_pass) piece.load(tail, mt0, n0 + wn * kCols, s, lane);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        long long m = mt0 + hh * 8 + g;
        if (m >= s.m) m = s.m - 1;  // any image: the row is not stored
        const long long img = narrow ? static_cast<unsigned>(m) /
                                           static_cast<unsigned>(pix)
                                     : m / pix;
        float sx[GA];
#pragma unroll
        for (int a = 0; a < GA; ++a)
          sx[a] = a < gn ? vx[static_cast<long long>(ga0 + a) * pl.n + img]
                         : 0.0f;
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) {
          OutT v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* held = sum + (((i * T::kNT + j) * 2 + hh) * 2 + e) *
                                    kConvThreads + tid;
            OutT r = from_float<OutT>(
                scaled(acc[0][i][j][2 * hh + e], sx[0], cw[j][e]));
            if (!first) r = add_round(from_float<OutT>(*held), r);
#pragma unroll
            for (int a = 1; a < GA; ++a) {
              if (a < gn) {
                r = add_round(r, from_float<OutT>(scaled(
                                     acc[a][i][j][2 * hh + e], sx[a],
                                     cw[j][e])));
              }
            }
            if (!final_pass) {
              *held = to_float(r);
            } else if (bias != nullptr) {
              r = add_round(r, cb[j][e]);
            }
            v[e] = r;
          }
          if (final_pass)
            store_pair(tile + (hh * 8 + g) * kPitch + j * 8 + 2 * t, v[0],
                       v[1]);
        }
      }
      if (final_pass) {
        __syncwarp();
        store_staged<OutT, kCols, kTail>(tile, out, mt0, n0 + wn * kCols, s,
                                         lane, tail, piece, slope_a,
                                         slope_b);
        __syncwarp();
      }
    }
    __syncthreads();  // the staging is the next pass's ring
  }
}

// -------------------------------------------------------------- producer

// Eight channels of x from one 16-byte-aligned address, as float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The producer's chain, for one channel of one pixel: u is the compared
// value (x - t rounded to T when Folded, else clamp(x)), r the residual
// sum so far (0 for the first plane, which compares u itself). Plane i's
// sign is that of u - r (a float32 difference has the sign of the one
// rounded to T); then r += s_i * p_i, rounded to T when Folded
// (threshold_sign_planes runs in x's dtype) and to float32 when not
// (activation_sign_planes promotes to float32). The bit is set where
// p_i = +1: u - r >= 0, or NaN (binary_sign(NaN) is +1).
template <typename T, bool Folded>
__device__ __forceinline__ bool plane_bit(float u, float& r, float s,
                                          bool first, bool more) {
  // NaN is +1, as sign's.
  const bool pos = !((first ? u : __fsub_rn(u, r)) < 0.0f);
  if (more) {
    const float sum = __fadd_rn(r, pos ? s : -s);
    r = Folded ? round_to<T>(sum) : sum;
  }
  return pos;
}

// The scale of plane i for one channel (Folded: va[i][ch], rounded to T
// as va[i].astype(x.dtype)) or one image (vs[i][img]).
template <typename T, bool Folded>
__device__ __forceinline__ float plane_scale(const float* scales, int i,
                                             int ch, int c, long long img,
                                             long long images) {
  return Folded ? round_to<T>(__ldg(scales + static_cast<long long>(i) * c +
                                    ch))
                : __ldg(scales + i * images + img);
}

// C % 8 == 0 and x on 16 bytes. Thread gtid owns 8-channel group
// j = gtid % (4 * wc) of pixels gtid / (4 * wc) + i * pix_step; groups
// j >= C / 8 are pad (all bits set). 4 * wc and blockDim are multiples of
// 4, so a word's four lanes are one aligned quad that leaves together.
// Each pixel's k planes come from one load of x. K is k fixed at compile
// time (0: k as given), so the plane loop unrolls. K = 1 (ls-1) has a
// body of its own, the single-plane loop: on an H100 the general body at
// k = 1 took 1.47x its time with k counted at run time, 1.056x with k
// fixed.
template <typename T, bool Folded, int K>
__global__ void pack_sign_planes_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ thresh,
    const float* __restrict__ flip, const float* __restrict__ scales,
    uint32_t* __restrict__ out, long long pixels, int c, int wc, int k_arg,
    long long hw, long long pix_step) {
  const int k = K > 0 ? K : k_arg;
  long long gtid = blockIdx.x * static_cast<long long>(blockDim.x) +
                   threadIdx.x;
  const int groups = 4 * wc;
  const long long p0 = gtid / groups;
  if (p0 >= pix_step) return;
  const int j = static_cast<int>(gtid % groups);
  const int ch0 = 8 * j;
  const bool live = ch0 < c;
  float tr[8];
  uint32_t neg = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tr[i] = Folded && live ? round_to<T>(thresh[ch0 + i]) : 0.0f;
    neg |= (Folded && live && flip[ch0 + i] < 0.0f ? 1u : 0u) << i;
  }
  const unsigned quad = 0xFu << (threadIdx.x & 28);
  const int shift = 8 * (j & 3);
  if constexpr (K == 1) {
    // The sign of x - t (t = 0 unfolded), which the rounding to T keeps:
    // no rounding, no chain.
    for (long long p = p0; p < pixels; p += pix_step) {
      uint32_t bits = 0xFFu;  // pad channels are set
      if (live) {
        float v[8];
        load8(x + p * c + ch0, v);
        bits = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          bits |= (__fsub_rn(v[i], tr[i]) < 0.0f ? 0u : 1u) << i;
        bits ^= neg;
      }
      uint32_t word = bits << shift;
      word |= __shfl_xor_sync(quad, word, 1);
      word |= __shfl_xor_sync(quad, word, 2);
      if ((j & 3) == 0) out[p * wc + (j >> 2)] = word;
    }
    return;
  }
  const long long images = Folded ? 0 : pixels / hw;
  const long long plane_words = pixels * wc;
  for (long long p = p0; p < pixels; p += pix_step) {
    float u[8], r[8];
    if (live) {
      load8(x + p * c + ch0, u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (Folded) u[i] = round_to<T>(__fsub_rn(u[i], tr[i]));
        r[i] = 0.0f;
      }
    }
    const long long img = Folded ? 0 : p / hw;
    uint32_t* o = out + p * wc + (j >> 2);
#pragma unroll
    for (int q = 0; q < k; ++q) {
      uint32_t bits = 0xFFu;  // pad channels are set
      if (live) {
        bits = 0;
        const bool more = q + 1 < k;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float s = more ? plane_scale<T, Folded>(scales, q, ch0 + i,
                                                        c, img, images)
                               : 0.0f;
          bits |= (plane_bit<T, Folded>(u[i], r[i], s, q == 0, more) ? 1u
                                                                   : 0u)
                  << i;
        }
        bits ^= neg;
      }
      uint32_t word = bits << shift;
      word |= __shfl_xor_sync(quad, word, 1);
      word |= __shfl_xor_sync(quad, word, 2);
      if ((j & 3) == 0) o[q * plane_words] = word;
    }
  }
}

// Any C and base: one warp per output word, lane j on channel 32w+j,
// one ballot per plane.
template <typename T, bool Folded>
__global__ void pack_sign_planes_kernel(
    const T* __restrict__ x, const float* __restrict__ thresh,
    const float* __restrict__ flip, const float* __restrict__ scales,
    uint32_t* __restrict__ out, long long pixels, int c, int wc, int k,
    long long hw) {
  long long gtid = blockIdx.x * static_cast<long long>(blockDim.x) +
                   threadIdx.x;
  long long word = gtid >> 5;
  int lane = threadIdx.x & 31;
  // blockDim is a multiple of 32, so a warp leaves together and every
  // ballot sees all 32 lanes.
  if (word >= pixels * wc) return;
  long long pix = word / wc;
  int ch = static_cast<int>(word % wc) * 32 + lane;
  const bool live = ch < c;
  float u = 0.0f, r = 0.0f;
  bool neg = false;
  if (live) {
    u = to_float(x[pix * c + ch]);
    if (Folded) {
      u = round_to<T>(__fsub_rn(u, round_to<T>(thresh[ch])));
      neg = flip[ch] < 0.0f;
    }
  }
  const long long images = pixels / hw;
  const long long img = Folded ? 0 : pix / hw;
  for (int q = 0; q < k; ++q) {
    bool bit = true;  // pad channels are set
    if (live) {
      const bool more = q + 1 < k;
      const float s = more ? plane_scale<T, Folded>(scales, q, ch, c, img,
                                                    images)
                           : 0.0f;
      bit = plane_bit<T, Folded>(u, r, s, q == 0, more) != neg;
    }
    unsigned bits = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) out[q * pixels * wc + word] = bits;
  }
}

// Widest cp.async piece (4, 2 or 1 words) that divides n and the base.
int piece_words(int n, const void* base) {
  auto addr = reinterpret_cast<uintptr_t>(base);
  for (int v = 4; v > 1; v /= 2) {
    if (n % v == 0 && addr % (4 * v) == 0) return v;
  }
  return 1;
}

ConvShape conv_shape(const void* x, const void* w, int n, int h, int wd,
                     int wc, int c, int o, int oh, int ow, int kh, int kw,
                     int stride, int pad, int pad_top) {
  ConvShape s;
  s.m = static_cast<long long>(n) * oh * ow;
  s.h = h; s.w = wd; s.wc = wc; s.o = o; s.oh = oh; s.ow = ow;
  s.kh = kh; s.kw = kw; s.stride = stride; s.pad = pad;
  s.pad_top = pad_top;
  s.ktot = kh * kw * wc;
  s.cr = c - (wc - 1) * 32;
  s.va = piece_words(wc, x);
  s.vb = piece_words(o, w);
  return s;
}

template <typename OutT, bool kTail>
void launch_conv_instance(const void* x, const void* w, const void* vx,
                          const void* vw, const void* bias, void* out,
                          const Tail& tail, const ConvShape& s,
                          cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((s.m + kConvBM - 1) / kConvBM),
            static_cast<unsigned>((s.o + kConvBN - 1) / kConvBN));
  xnor_conv2d_kernel<OutT, kTail><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(vx), static_cast<const float*>(vw),
      static_cast<const OutT*>(bias), static_cast<OutT*>(out), s, tail);
}

template <typename OutT>
int launch_conv(const void* x, const void* w, const void* vx, const void* vw,
                const void* bias, void* out, const Tail& tail,
                const ConvShape& s, void* stream) {
  if (s.m > 0 && s.o > 0) {
    auto st = static_cast<cudaStream_t>(stream);
    if (tail.any()) {
      launch_conv_instance<OutT, true>(x, w, vx, vw, bias, out, tail, s, st);
    } else {
      launch_conv_instance<OutT, false>(x, w, vx, vw, bias, out, tail, s,
                                        st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// A multi-plane conv call: its operands and shapes, or (regs set) a query
// of the instance it would launch: registers a thread, blocks an SM. With
// `tailed` the instance with the tail (set where `tail` has any part).
struct PlanesCall {
  const void *x, *w, *vx, *vw, *bias;
  void* out;
  Tail tail;
  bool tailed;
  ConvShape s;
  PlaneShape pl;
  cudaStream_t stream;
  int *regs, *blocks;
};

// Registers and blocks an SM of `kernel` at `smem` bytes of dynamic
// shared memory.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int smem, int* regs, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kConvThreads, smem);
}

// One instance: its dynamic shared memory is the ring, plus the running
// sum where a block runs more than one pass.
template <typename OutT, int GA, int PA, int PW, bool kTail>
cudaError_t planes_instance(const PlanesCall& c) {
  using S = PlanesSmem<GA, PA, PW>;
  const int passes = c.pl.gw * ((c.pl.ga + GA - 1) / GA);
  const int smem = S::kRing + (passes > 1 ? S::kSum : 0);
  auto kernel = xnor_conv2d_planes_kernel<OutT, GA, PA, PW, kTail>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (c.regs != nullptr) return occupancy(kernel, smem, c.regs, c.blocks);
  if (c.s.m > 0 && c.s.o > 0) {
    constexpr int kBM = PlanesTile<GA>::kBM;
    dim3 grid(static_cast<unsigned>((c.s.m + kBM - 1) / kBM),
              static_cast<unsigned>((c.s.o + kConvBN - 1) / kConvBN));
    kernel<<<grid, kConvThreads, smem, c.stream>>>(
        static_cast<const uint32_t*>(c.x), static_cast<const uint32_t*>(c.w),
        static_cast<const float*>(c.vx), static_cast<const float*>(c.vw),
        static_cast<const OutT*>(c.bias), static_cast<OutT*>(c.out), c.s,
        c.pl, c.tail);
  }
  return cudaGetLastError();
}

// The instance for a plane layout: merged activation planes (pa = 2) one
// group a pass; single planes all ga groups in one pass up to 3, beyond
// that 2 or 3 a pass (2 where ga is even).
template <typename OutT, int PW, bool kTail>
cudaError_t planes_by_groups(const PlanesCall& c) {
  if (c.pl.pa == 2) return planes_instance<OutT, 1, 2, PW, kTail>(c);
  const int ga = c.pl.ga;
  switch (ga <= 3 ? ga : (ga % 2 == 0 ? 2 : 3)) {
    case 1:
      return planes_instance<OutT, 1, 1, PW, kTail>(c);
    case 2:
      return planes_instance<OutT, 2, 1, PW, kTail>(c);
    default:
      return planes_instance<OutT, 3, 1, PW, kTail>(c);
  }
}

template <typename OutT, bool kTail>
cudaError_t planes_by_weights(const PlanesCall& c) {
  return c.pl.pw == 2 ? planes_by_groups<OutT, 2, kTail>(c)
                      : planes_by_groups<OutT, 1, kTail>(c);
}

template <typename OutT>
int planes_call(const PlanesCall& c) {
  return static_cast<int>(c.tailed ? planes_by_weights<OutT, true>(c)
                                   : planes_by_weights<OutT, false>(c));
}

// Pixels one grid-stride step of a wide producer covers: enough threads
// (4 * wc a pixel) to fill every SM twice (2048 a SM, 8 blocks of 256).
long long wide_step(long long pixels, int wc) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = 4LL * wc;
  const long long cap = 2LL * (sms > 0 ? sms : 1) * 2048;
  const long long step = cap / groups > 0 ? cap / groups : 1;
  return step < pixels ? step : pixels;
}

// The producer: the wide kernel where C and x's base allow, else the
// scalar one; hw is pixels an image (the per-sample scale's index is
// pixel / hw).
template <typename T, bool Folded>
void launch_planes(const T* x, const float* th, const float* fl,
                   const float* sc, uint32_t* o, long long pixels, int c,
                   int wc, int k, long long hw, cudaStream_t st) {
  if (c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const long long step = wide_step(pixels, wc);
    const unsigned blocks = qtt::blocks_for(step * 4 * wc);
    switch (k) {
      case 1:
        pack_sign_planes_wide_kernel<T, Folded, 1>
            <<<blocks, qtt::kThreads, 0, st>>>(x, th, fl, sc, o, pixels, c,
                                               wc, k, hw, step);
        break;
      case 2:
        pack_sign_planes_wide_kernel<T, Folded, 2>
            <<<blocks, qtt::kThreads, 0, st>>>(x, th, fl, sc, o, pixels, c,
                                               wc, k, hw, step);
        break;
      case 3:
        pack_sign_planes_wide_kernel<T, Folded, 3>
            <<<blocks, qtt::kThreads, 0, st>>>(x, th, fl, sc, o, pixels, c,
                                               wc, k, hw, step);
        break;
      default:
        pack_sign_planes_wide_kernel<T, Folded, 0>
            <<<blocks, qtt::kThreads, 0, st>>>(x, th, fl, sc, o, pixels, c,
                                               wc, k, hw, step);
    }
  } else {
    pack_sign_planes_kernel<T, Folded>
        <<<qtt::blocks_for(pixels * wc * 32), qtt::kThreads, 0, st>>>(
            x, th, fl, sc, o, pixels, c, wc, k, hw);
  }
}

template <typename T>
int launch_pack_planes(const void* x, const void* thresh, const void* flip,
                       const void* scales, void* out, long long pixels,
                       int c, int wc, int k, long long hw, void* stream) {
  if (pixels <= 0 || k <= 0 || hw <= 0)
    return static_cast<int>(cudaGetLastError());
  auto xs = static_cast<const T*>(x);
  auto th = static_cast<const float*>(thresh);
  auto fl = static_cast<const float*>(flip);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (th != nullptr) {
    launch_planes<T, true>(xs, th, fl, sc, o, pixels, c, wc, k, hw, st);
  } else {
    launch_planes<T, false>(xs, th, fl, sc, o, pixels, c, wc, k, hw, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qtt_xnor_gemm(const void* a, const void* bt, const void* vx,
                             const void* vw, void* out, int m, int w_words,
                             int n, int k_total, void* stream) {
  if (m <= 0 || n <= 0 || w_words <= 0)
    return static_cast<int>(cudaGetLastError());
  const int smem =
      wg::Ring<kGemmStages>::smem_bytes(kGemmProducers * kWordSmem);
  cudaError_t e = cudaFuncSetAttribute(
      xnor_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + wg::kBN - 1) / wg::kBN, (m + wg::kBM - 1) / wg::kBM);
  xnor_gemm_kernel<<<grid, wg::threads(kGemmProducers), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(bt),
      static_cast<const float*>(vx), static_cast<const float*>(vw),
      static_cast<float*>(out), m, w_words, n, k_total);
  return static_cast<int>(cudaGetLastError());
}

// The tail's pointers (ops/binary_infer.py `_tail_ptrs`), null where a
// step is left out.
inline Tail make_tail(const void* res, const void* mean, const void* mul,
                      const void* add, const void* slope_a,
                      const void* slope_b) {
  return Tail{res,
              static_cast<const float*>(mean),
              static_cast<const float*>(mul),
              static_cast<const float*>(add),
              static_cast<const float*>(slope_a),
              static_cast<const float*>(slope_b)};
}

#define QTT_CONV(SUFFIX, OUT_T)                                               \
  extern "C" int qtt_xnor_conv2d_##SUFFIX(                                     \
      const void* x, const void* w, const void* vx, const void* vw,          \
      const void* bias, void* out, const void* res, const void* mean,        \
      const void* mul, const void* add, const void* slope_a,                 \
      const void* slope_b, int n, int h, int wd, int wc, int c, int o,       \
      int oh, int ow, int kh, int kw, int stride, int pad, int pad_top,      \
      void* stream) {                                                        \
    return launch_conv<OUT_T>(                                               \
        x, w, vx, vw, bias, out,                                             \
        make_tail(res, mean, mul, add, slope_a, slope_b),                    \
        conv_shape(x, w, n, h, wd, wc, c, o, oh, ow, kh, kw, stride, pad,    \
                   pad_top),                                                 \
        stream);                                                             \
  }
QTT_CONV(f32, float)
QTT_CONV(bf16, __nv_bfloat16)

#define QTT_CONV_PLANES(SUFFIX, OUT_T)                                        \
  extern "C" int qtt_xnor_conv2d_planes_##SUFFIX(                              \
      const void* x, const void* w, const void* vx, const void* vw,          \
      const void* bias, void* out, const void* res, const void* mean,        \
      const void* mul, const void* add, const void* slope_a,                 \
      const void* slope_b, int n, int h, int wd, int wc, int c, int o,       \
      int oh, int ow, int kh, int kw, int stride, int pad, int pad_top,      \
      int ga, int pa, int gw, int pw, void* stream) {                        \
    PlaneShape pl{ga, pa, gw, pw, n, static_cast<long long>(n) * h * wd * wc,  \
                  static_cast<long long>(kh) * kw * wc * o};                 \
    const Tail tail = make_tail(res, mean, mul, add, slope_a, slope_b);      \
    return planes_call<OUT_T>(PlanesCall{                                    \
        x, w, vx, vw, bias, out, tail, tail.any(),                           \
        conv_shape(x, w, n, h, wd, wc, c, o, oh, ow, kh, kw, stride, pad,    \
                   pad_top),                                                 \
        pl, static_cast<cudaStream_t>(stream), nullptr, nullptr});           \
  }
QTT_CONV_PLANES(f32, float)
QTT_CONV_PLANES(bf16, __nv_bfloat16)

template <typename OutT>
cudaError_t conv_occupancy(bool tail, int* regs, int* blocks) {
  return tail ? occupancy(xnor_conv2d_kernel<OutT, true>, 0, regs, blocks)
              : occupancy(xnor_conv2d_kernel<OutT, false>, 0, regs, blocks);
}

// Registers a thread and blocks an SM of the conv kernel a launch with
// these plane groups takes (ga = pa = gw = pw = 1: the ls-1 conv), with
// f32 (f32 != 0) or bf16 out, with a tail (tail != 0) or without.
extern "C" int qtt_xnor_conv2d_occupancy(int f32, int ga, int pa, int gw,
                                         int pw, int tail, int* regs,
                                         int* blocks) {
  if (ga == 1 && pa == 1 && gw == 1 && pw == 1) {
    return static_cast<int>(
        f32 ? conv_occupancy<float>(tail != 0, regs, blocks)
            : conv_occupancy<__nv_bfloat16>(tail != 0, regs, blocks));
  }
  PlanesCall c{};
  c.tailed = tail != 0;
  c.pl = PlaneShape{ga, pa, gw, pw, 0, 0, 0};
  c.regs = regs;
  c.blocks = blocks;
  return f32 ? planes_call<float>(c) : planes_call<__nv_bfloat16>(c);
}

// thresh and flip null: the unfolded mode (scales per sample).
#define QTT_PACK_PLANES(SUFFIX, T)                                            \
  extern "C" int qtt_pack_sign_planes_##SUFFIX(                                \
      const void* x, const void* thresh, const void* flip,                   \
      const void* scales, void* out, long long pixels, int c, int wc, int k, \
      long long hw, void* stream) {                                          \
    return launch_pack_planes<T>(x, thresh, flip, scales, out, pixels, c,    \
                                 wc, k, hw, stream);                         \
  }
QTT_PACK_PLANES(f32, float)
QTT_PACK_PLANES(bf16, __nv_bfloat16)
