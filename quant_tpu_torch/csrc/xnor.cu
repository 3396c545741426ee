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
//   Epilogue as the JAX int8 branch, bit-exact (_rn intrinsics):
//   float(dot) * (vx[n] * vw[o]) in f32, rounded to bf16 (nearest even)
//   or kept f32, then + bias in the out dtype. Each warp stages a 16x32
//   piece of outputs in the then idle ring and stores it in 16-byte
//   chunks, a row's 64 (bf16) or 128 (f32) bytes at a time.
//
// qtt_xnor_conv2d_planes_* -- the conv's multi-plane form: JAX's int8
//   pass loop (binary_infer.py:280-324, fused=False) over k_a activation
//   and k_w weight planes (ls-2, ls-T, gf-k), bit for bit. Planes that
//   share a scale form a group (ls-T's two, whose JAX operand is b1 + b2;
//   ls-T weights with w_planes_share_scale). Bound by operations, as the
//   ls-1 conv, times the plane pairs. Design: the ls-1 kernel's template
//   with Multi = true. One CTA loops over the group pairs (weight groups
//   outer); a group pair's plane pairs run through the same pipeline as
//   more K, each padded to whole stages and its cursor rewound, so their
//   integer dots add in the accumulators (the registers of the ls-1
//   tile). Each group pair's term is rounded to the out dtype, added to
//   the running sum that the same thread stored in `out` for the group
//   before (rounded again), and the bias follows the last. One launch,
//   not k_a * k_w launches and an add: the host's launch time already
//   shows at batch 128.
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
  int h, w, wc, o, oh, ow, kh, kw, stride, pad;
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

// The multi-plane form's extra shape: ga activation groups of pa planes
// and gw weight groups of pw planes (pa, pw = 2 where a scale covers two
// planes, as ls-T's), the planes' strides in words, and the batch.
struct PlaneShape {
  int ga, pa, gw, pw, n;
  long long x_plane, w_plane;
};

// a + b rounded to T, as `acc + term` in T does.
__device__ __forceinline__ float add_round(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 add_round(__nv_bfloat16 a,
                                                   __nv_bfloat16 b) {
  return from_float<__nv_bfloat16>(__fadd_rn(to_float(a), to_float(b)));
}

// Multi = false: one activation plane against one weight plane, the
// serving path's ls-1 conv. Multi = true: JAX's int8 pass loop over
// plane groups (weight groups outer, activation groups inner). Each group
// pair runs the whole pipeline with its plane pairs as more K (plane p's
// words against weight plane q's, K padded to whole stages per pair),
// so the integer dots of planes that share a scale add before the
// epilogue; then its term is rounded to OutT and, from the second group
// pair on, added to the partial sum in `out` in OutT's rounding (each
// thread reads back only what it stored itself), the bias after the last.
template <typename OutT, bool Multi>
__global__ void __launch_bounds__(kConvThreads)
    xnor_conv2d_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ wt,
                       const float* __restrict__ vx,
                       const float* __restrict__ vw,
                       const OutT* __restrict__ bias, OutT* __restrict__ out,
                       ConvShape s, PlaneShape pl) {
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

  // The A loader's row (one per thread): its image, its top-left input
  // pixel and a cursor (tap ti, tj; word kq; depth kidx) that walks K in
  // the order the stages are loaded.
  const long long my_m = m0 + tid;
  const bool row_ok = my_m < s.m;
  int iy0 = 0, ix0 = 0;
  long long img = 0;
  if (row_ok) {
    int ox = static_cast<int>(my_m % s.ow);
    long long r = my_m / s.ow;
    int oy = static_cast<int>(r % s.oh);
    img = (r / s.oh) * s.h * s.w;
    iy0 = oy * s.stride - s.pad;
    ix0 = ox * s.stride - s.pad;
  }
  const int b_lg = s.vb == 4 ? 2 : s.vb - 1;       // log2 of vb
  const int b_row_lg = 6 - b_lg;                   // pieces per B row
  static_assert(kConvBN == 64, "b_row_lg assumes 64 columns");
  const int spp = (s.ktot + kKS - 1) / kKS;  // stages per plane pair
  const int groups = Multi ? pl.ga * pl.gw : 1;

  // Pad channels of a tap's last word: bytes of channels >= cr are zeroed
  // in B (see expand_word for the channel each byte holds).
  uint32_t pad_lo = 0, pad_hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t + 8 * i < s.cr) pad_lo |= 0xFFu << (8 * i);
    if (t + 4 + 8 * i < s.cr) pad_hi |= 0xFFu << (8 * i);
  }
  const int swz = ((g >> 2) & 1) << 2;  // a_slot's flip for this lane's rows

  for (int gp = 0; gp < groups; ++gp) {
    const int gi = Multi ? gp % pl.ga : 0;  // activation group
    const int gj = Multi ? gp / pl.ga : 0;  // weight group
    int ti = 0, tj = 0, kq = 0, kidx = 0;
    const uint32_t* xp = x;
    const uint32_t* wp = wt;

    // Stage st of this group pair: words k0.. of its plane pair.
    auto load_stage = [&](int slot, int st) {
      int k0 = st * kKS;
      if constexpr (Multi) {
        const int pair = st / spp, ls = st - pair * spp;
        if (ls == 0) {  // a new plane pair: rewind the cursor
          ti = tj = kq = kidx = 0;
          xp = x + (gi * pl.pa + pair % pl.pa) * pl.x_plane;
          wp = wt + (gj * pl.pw + pair / pl.pa) * pl.w_plane;
        }
        k0 = ls * kKS;
      }
      uint32_t valid = 0;
      for (int j = 0; j < kKS; j += s.va) {
        int iy = iy0 + ti, ix = ix0 + tj;
        if (row_ok && kidx < s.ktot && iy >= 0 && iy < s.h && ix >= 0 &&
            ix < s.w) {
          cp_async_words(sa[slot] + a_slot(tid, j),
                         xp + (img + static_cast<long long>(iy) * s.w + ix) *
                                  s.wc + kq,
                         s.va);
          valid |= ((1u << s.va) - 1u) << j;
        }
        kidx += s.va;
        kq += s.va;
        if (kq == s.wc) {
          kq = 0;
          if (++tj == s.kw) {
            tj = 0;
            ++ti;
          }
        }
      }
      sv[slot][tid] = valid;
      for (int p = tid; p < (kKS << b_row_lg); p += kConvThreads) {
        int kr = p >> b_row_lg;
        int col = (p & ((1 << b_row_lg) - 1)) << b_lg;
        if (k0 + kr < s.ktot && n0 + col < s.o) {
          cp_async_words(sb[slot] + kr * kConvBN + col,
                         wp + static_cast<long long>(k0 + kr) * s.o + n0 +
                             col,
                         s.vb);
        }
      }
    };

    int acc[kConvMT][kConvNT][4];
#pragma unroll
    for (int i = 0; i < kConvMT; ++i)
#pragma unroll
      for (int j = 0; j < kConvNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    const int stages = Multi ? spp * pl.pa * pl.pw : spp;
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
      const int ls = Multi ? kt % spp : kt;  // the stage within its pair
      const uint32_t* A = sa[slot];
      const uint32_t* B = sb[slot] + wn * 32 + g;
      uint32_t vm[kConvMT][2];
#pragma unroll
      for (int i = 0; i < kConvMT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          vm[i][hh] = sv[slot][wm * 64 + i * 16 + hh * 8 + g];
      // Bit kk set where word ls*kKS + kk is the last of its tap.
      uint32_t last = 0;
      if (s.cr < 32) {
        for (int j = s.wc - 1 - (ls * kKS) % s.wc; j < kKS; j += s.wc)
          last |= 1u << j;
      }
      const int depth = min(kKS, s.ktot - ls * kKS);  // k-steps in the stage
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
            uint32_t keep = static_cast<uint32_t>(
                static_cast<int>(vm[i][hh] << (31 - kk)) >> 31);
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
    const float* vxg = vx + (Multi ? static_cast<long long>(gi) * pl.n : 0);
    const float* vwg = vw + (Multi ? static_cast<long long>(gj) * s.o : 0);
    const bool has_bias = !Multi && bias != nullptr;  // Multi: at the store
    float cw[kConvNT][2], cb[kConvNT][2];  // this lane's columns, loaded once
#pragma unroll
    for (int j = 0; j < kConvNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int oc = n0 + wn * 32 + j * 8 + 2 * t + e;
        cw[j][e] = oc < s.o ? vwg[oc] : 0.0f;
        cb[j][e] = oc < s.o && has_bias ? to_float(bias[oc]) : 0.0f;
      }
    }
    constexpr int kChunk = 16 / static_cast<int>(sizeof(OutT));  // per 16 B
    constexpr int kPitch = 32 + kChunk;  // staged row: 16 B aligned, no bank
                                         // conflicts for the pair writes
    static_assert(4 * 16 * kPitch * sizeof(OutT) <= sizeof(sa), "staging");
    OutT* tile = reinterpret_cast<OutT*>(&sa[0][0]) + (tid >> 5) * 16 * kPitch;
    const long long pix = static_cast<long long>(s.oh) * s.ow;
    const bool narrow = s.m <= 0xFFFFFFFFLL;  // 32-bit division suffices
    const bool vec = s.o % kChunk == 0;       // whole chunks lie on 16 B
    const int col0 = n0 + wn * 32;
    const bool first = gp == 0, final_term = gp == groups - 1;
#pragma unroll
    for (int i = 0; i < kConvMT; ++i) {
      const long long mt0 = m0 + wm * 64 + i * 16;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        long long m = mt0 + hh * 8 + g;
        if (m >= s.m) m = s.m - 1;  // any image: the row is not stored
        float sx = vxg[narrow ? static_cast<unsigned>(m) /
                                    static_cast<unsigned>(pix)
                              : m / pix];
#pragma unroll
        for (int j = 0; j < kConvNT; ++j) {
          store_pair(tile + (hh * 8 + g) * kPitch + j * 8 + 2 * t,
                     epilogue<OutT>(
                         __fmul_rn(static_cast<float>(acc[i][j][2 * hh] >> 8),
                                   __fmul_rn(sx, cw[j][0])),
                         has_bias, cb[j][0]),
                     epilogue<OutT>(
                         __fmul_rn(
                             static_cast<float>(acc[i][j][2 * hh + 1] >> 8),
                             __fmul_rn(sx, cw[j][1])),
                         has_bias, cb[j][1]));
        }
      }
      __syncwarp();
      for (int c = lane; c < 16 * (32 / kChunk); c += 32) {
        int r = c / (32 / kChunk);
        int cc = (c % (32 / kChunk)) * kChunk;
        long long m = mt0 + r;
        if (m >= s.m || col0 + cc >= s.o) continue;
        const OutT* src = tile + r * kPitch + cc;
        OutT* o = out + m * s.o + col0 + cc;
        if constexpr (Multi) {
          // The running sum in OutT: out holds the earlier terms, stored
          // by this thread; the bias joins after the last term.
          const int cnt = vec ? kChunk : min(kChunk, s.o - col0 - cc);
          alignas(16) OutT v[kChunk];
          if (vec) {
            *reinterpret_cast<uint4*>(v) =
                *reinterpret_cast<const uint4*>(src);
            if (!first) {
              alignas(16) OutT prev[kChunk];
              *reinterpret_cast<uint4*>(prev) =
                  *reinterpret_cast<const uint4*>(o);
#pragma unroll
              for (int e = 0; e < kChunk; ++e) v[e] = add_round(prev[e], v[e]);
            }
          } else {
            for (int e = 0; e < cnt; ++e)
              v[e] = first ? src[e] : add_round(o[e], src[e]);
          }
          if (final_term && bias != nullptr) {
            for (int e = 0; e < cnt; ++e)
              v[e] = add_round(v[e], bias[col0 + cc + e]);
          }
          if (vec) {
            *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
          } else {
            for (int e = 0; e < cnt; ++e) o[e] = v[e];
          }
        } else if (vec) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kChunk && col0 + cc + e < s.o; ++e) o[e] = src[e];
        }
      }
      __syncwarp();
    }
    if (Multi) __syncthreads();  // the staging is the next group's ring
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

template <typename OutT, bool Multi = false>
int launch_conv(const void* x, const void* w, const void* vx, const void* vw,
                const void* bias, void* out, int n, int h, int wd, int wc,
                int c, int o, int oh, int ow, int kh, int kw, int stride,
                int pad, void* stream, PlaneShape pl = PlaneShape{}) {
  ConvShape s;
  s.m = static_cast<long long>(n) * oh * ow;
  s.h = h; s.w = wd; s.wc = wc; s.o = o; s.oh = oh; s.ow = ow;
  s.kh = kh; s.kw = kw; s.stride = stride; s.pad = pad;
  s.ktot = kh * kw * wc;
  s.cr = c - (wc - 1) * 32;
  s.va = piece_words(wc, x);
  s.vb = piece_words(o, w);
  if (s.m > 0 && o > 0) {
    dim3 grid(static_cast<unsigned>((s.m + kConvBM - 1) / kConvBM),
              static_cast<unsigned>((o + kConvBN - 1) / kConvBN));
    pl.n = n;
    pl.x_plane = static_cast<long long>(n) * h * wd * wc;
    pl.w_plane = static_cast<long long>(kh) * kw * wc * o;
    xnor_conv2d_kernel<OutT, Multi>
        <<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
            static_cast<const float*>(vx), static_cast<const float*>(vw),
            static_cast<const OutT*>(bias), static_cast<OutT*>(out), s, pl);
  }
  return static_cast<int>(cudaGetLastError());
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

#define QTT_CONV_PLANES(SUFFIX, OUT_T)                                        \
  extern "C" int qtt_xnor_conv2d_planes_##SUFFIX(                              \
      const void* x, const void* w, const void* vx, const void* vw,          \
      const void* bias, void* out, int n, int h, int wd, int wc, int c,      \
      int o, int oh, int ow, int kh, int kw, int stride, int pad, int ga,    \
      int pa, int gw, int pw, void* stream) {                                \
    PlaneShape pl{};                                                         \
    pl.ga = ga;                                                              \
    pl.pa = pa;                                                              \
    pl.gw = gw;                                                              \
    pl.pw = pw;                                                              \
    return launch_conv<OUT_T, true>(x, w, vx, vw, bias, out, n, h, wd, wc,  \
                                    c, o, oh, ow, kh, kw, stride, pad,       \
                                    stream, pl);                             \
  }
QTT_CONV_PLANES(f32, float)
QTT_CONV_PLANES(bf16, __nv_bfloat16)

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
