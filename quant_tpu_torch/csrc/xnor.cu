// Binary (+-1) contractions over packed sign words (bit j of word w is the
// sign of element 32w+j, set for >= 0; pad bits past the last channel are
// set by the packers: xnor_gemm relies on that, as the TPU kernel does,
// the conv does not).
//
// qtt_xnor_gemm -- replaces quant_tpu/ops/binary_gemm.py `_xnor_kernel`
//   (via `xnor_gemm`), same signature and result, pad correction included.
//   Off every path; one thread per output element runs XOR + POPC + ADD
//   per 32 MACs on the CUDA cores. Moving it onto the conv's mma core is
//   queued.
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
// qtt_pack_threshold_signs_* -- the producer, no TPU kernel (XLA fused
//   binary_infer.py:179-184 with packing.py:27-43): raw block input ->
//   packed words, bit = (x - round_to_T(t) >= 0) XOR (flip < 0), pad bits
//   set. Bound by bytes: it reads x once and writes 1/16 (bf16) of it.
//   Design: when C % 8 == 0 and x sits on 16 bytes, each lane owns 8
//   fixed channels (thresholds and flips loaded once) and walks pixels
//   grid-stride with one 16-byte load (bf16; two for f32), neighbouring
//   lanes on neighbouring addresses; it builds 8 bits and the 4 lanes of
//   a word OR theirs with two shuffles. Pad groups of the last word are
//   all-set lanes that load nothing. Any other C or base takes the scalar
//   path: one warp per word, __ballot_sync.

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

template <typename OutT>
__global__ void __launch_bounds__(kConvThreads)
    xnor_conv2d_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ wt,
                       const float* __restrict__ vx,
                       const float* __restrict__ vw,
                       const OutT* __restrict__ bias, OutT* __restrict__ out,
                       ConvShape s) {
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
  int ti = 0, tj = 0, kq = 0, kidx = 0;
  const int b_lg = s.vb == 4 ? 2 : s.vb - 1;       // log2 of vb
  const int b_row_lg = 6 - b_lg;                   // pieces per B row
  static_assert(kConvBN == 64, "b_row_lg assumes 64 columns");

  auto load_stage = [&](int slot, int k0) {
    uint32_t valid = 0;
    for (int j = 0; j < kKS; j += s.va) {
      int iy = iy0 + ti, ix = ix0 + tj;
      if (row_ok && kidx < s.ktot && iy >= 0 && iy < s.h && ix >= 0 &&
          ix < s.w) {
        cp_async_words(sa[slot] + a_slot(tid, j),
                       x + (img + static_cast<long long>(iy) * s.w + ix) *
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
                       wt + static_cast<long long>(k0 + kr) * s.o + n0 + col,
                       s.vb);
      }
    }
  };

  // Pad channels of a tap's last word: bytes of channels >= cr are zeroed
  // in B (see expand_word for the channel each byte holds).
  uint32_t pad_lo = 0, pad_hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t + 8 * i < s.cr) pad_lo |= 0xFFu << (8 * i);
    if (t + 4 + 8 * i < s.cr) pad_hi |= 0xFFu << (8 * i);
  }
  const int swz = ((g >> 2) & 1) << 2;  // a_slot's flip for this lane's rows

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
    if (st < stages) load_stage(st, st * kKS);
    cp_async_commit();
  }

  for (int kt = 0; kt < stages; ++kt) {
    // Stage kt has landed; every warp is done with stage kt - 1, whose
    // buffers the next load reuses.
    cp_async_wait<kConvStages - 2>();
    __syncthreads();
    int next = kt + kConvStages - 1;
    if (next < stages) load_stage(next % kConvStages, next * kKS);
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
    // Bit kk set where word kt*kKS + kk is the last of its tap.
    uint32_t last = 0;
    if (s.cr < 32) {
      for (int j = s.wc - 1 - (kt * kKS) % s.wc; j < kKS; j += s.wc)
        last |= 1u << j;
    }
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

  // Epilogue: c[0], c[1] are row g, columns 2t, 2t+1; c[2], c[3] row g+8.
  // Each warp writes one 16x32 m-tile of outputs to shared memory, then
  // stores it row by row in 16-byte chunks.
  float cw[kConvNT][2], cb[kConvNT][2];  // this lane's columns, loaded once
#pragma unroll
  for (int j = 0; j < kConvNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int oc = n0 + wn * 32 + j * 8 + 2 * t + e;
      cw[j][e] = oc < s.o ? vw[oc] : 0.0f;
      cb[j][e] = oc < s.o && bias ? to_float(bias[oc]) : 0.0f;
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
#pragma unroll
  for (int i = 0; i < kConvMT; ++i) {
    const long long mt0 = m0 + wm * 64 + i * 16;
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
                   epilogue<OutT>(
                       __fmul_rn(static_cast<float>(acc[i][j][2 * hh] >> 8),
                                 __fmul_rn(sx, cw[j][0])),
                       bias != nullptr, cb[j][0]),
                   epilogue<OutT>(
                       __fmul_rn(
                           static_cast<float>(acc[i][j][2 * hh + 1] >> 8),
                           __fmul_rn(sx, cw[j][1])),
                       bias != nullptr, cb[j][1]));
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
      if (vec) {
        *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < kChunk && col0 + cc + e < s.o; ++e) o[e] = src[e];
      }
    }
    __syncwarp();
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

// C % 8 == 0 and x on 16 bytes. Thread gtid owns 8-channel group
// j = gtid % (4 * wc) of pixels gtid / (4 * wc) + i * pix_step; groups
// j >= C / 8 are pad (all bits set). 4 * wc and blockDim are multiples of
// 4, so a word's four lanes are one aligned quad that leaves together.
template <typename T>
__global__ void pack_threshold_signs_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ thresh,
    const float* __restrict__ flip, uint32_t* __restrict__ out,
    long long pixels, int c, int wc, long long pix_step) {
  long long gtid = blockIdx.x * static_cast<long long>(blockDim.x) +
                   threadIdx.x;
  const int groups = 4 * wc;
  const long long p0 = gtid / groups;
  if (p0 >= pix_step) return;
  const int j = static_cast<int>(gtid % groups);
  const int ch0 = 8 * j;
  const bool live = ch0 < c;
  // The threshold is rounded to x's dtype first (thresh.astype(x.dtype)
  // in binary_infer.py:180); the sign of x - t survives the rounding of
  // the difference, so comparing the float32 difference is exact.
  float tr[8];
  uint32_t neg = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tr[i] = live ? round_to<T>(thresh[ch0 + i]) : 0.0f;
    neg |= (live && flip[ch0 + i] < 0.0f ? 1u : 0u) << i;
  }
  const unsigned quad = 0xFu << (threadIdx.x & 28);
  const int shift = 8 * (j & 3);
  for (long long p = p0; p < pixels; p += pix_step) {
    uint32_t bits = 0xFFu;  // pad channels are set
    if (live) {
      float v[8];
      load8(x + p * c + ch0, v);
      bits = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        bits |= (__fsub_rn(v[i], tr[i]) >= 0.0f ? 1u : 0u) << i;
      bits ^= neg;
    }
    uint32_t word = bits << shift;
    word |= __shfl_xor_sync(quad, word, 1);
    word |= __shfl_xor_sync(quad, word, 2);
    if ((j & 3) == 0) out[p * wc + (j >> 2)] = word;
  }
}

// Any C and base: one warp per output word, lane j reads channel 32w+j.
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
    float u = __fsub_rn(to_float(x[pix * c + ch]), round_to<T>(thresh[ch]));
    bit = (u >= 0.0f) != (flip[ch] < 0.0f);
  }
  unsigned bits = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[word] = bits;
}

// Widest cp.async piece (4, 2 or 1 words) that divides n and the base.
int piece_words(int n, const void* base) {
  auto addr = reinterpret_cast<uintptr_t>(base);
  for (int v = 4; v > 1; v /= 2) {
    if (n % v == 0 && addr % (4 * v) == 0) return v;
  }
  return 1;
}

template <typename OutT>
int launch_conv(const void* x, const void* w, const void* vx, const void* vw,
                const void* bias, void* out, int n, int h, int wd, int wc,
                int c, int o, int oh, int ow, int kh, int kw, int stride,
                int pad, void* stream) {
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
    xnor_conv2d_kernel<OutT>
        <<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
            static_cast<const float*>(vx), static_cast<const float*>(vw),
            static_cast<const OutT*>(bias), static_cast<OutT*>(out), s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack(const void* x, const void* thresh, const void* flip,
                void* out, long long pixels, int c, int wc, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto xs = static_cast<const T*>(x);
  auto th = static_cast<const float*>(thresh);
  auto fl = static_cast<const float*>(flip);
  auto o = static_cast<uint32_t*>(out);
  if (pixels <= 0) return static_cast<int>(cudaGetLastError());
  if (c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    // Enough threads to fill every SM twice (2048 a SM, 8 blocks of 256);
    // each walks pixels grid-stride.
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long groups = 4LL * wc;
    const long long cap = 2LL * (sms > 0 ? sms : 1) * 2048;
    long long step = cap / groups > 0 ? cap / groups : 1;
    if (step > pixels) step = pixels;
    pack_threshold_signs_wide_kernel<T>
        <<<qtt::blocks_for(step * groups), qtt::kThreads, 0, st>>>(
            xs, th, fl, o, pixels, c, wc, step);
  } else {
    pack_threshold_signs_kernel<T>
        <<<qtt::blocks_for(pixels * wc * 32), qtt::kThreads, 0, st>>>(
            xs, th, fl, o, pixels, c, wc);
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
