// Kernels of the chip probes: an elementwise float32 add and a tiled
// tensor-core matmul.
//
// Replaces the TPU kernels of tools/probe_r2.py and tools/probe_r3.py:
//
//   qtt_add_f32              `kernel` in `pallas_add` (probe_r2.py:412):
//                            o = x + y over any contiguous f32 shape;
//   qtt_tiled_matmul_bf16    `kernel` in `pallas_matmul_bf16`
//                            (probe_r2.py:438) and in `_pallas_mm`
//                            (probe_r3.py:311) for bf16: row-major
//                            A (M,K) @ B (K,N), summed in float32,
//                            rounded to bf16 (nearest even);
//   qtt_tiled_matmul_s8      `kernel` in `_pallas_mm` for int8: summed in
//                            int32, written as int8 by the two's-
//                            complement wrap of XLA's convert.
//
// What bounds them on an H100. The add reads two f32 arrays and writes
// one: bytes (805 MB at (16384, 4096), 0.240 ms at 3.35 TB/s; at the
// probe's (1024, 256), 3 MB, the time of a launch sets it). One launch:
// a block for every tile of kAddVecs * kAddThreads vectors, each thread
// issuing its kAddVecs 16-byte loads of x and of y before its first add
// (4-byte loads unless all three pointers start on 16 bytes); the last n
// % 4 elements go to the first threads of the same launch; streaming
// cache hints (__ldcs/__stcs) below kHintBytes. Measured on the H100
// (probes/xnor_variants.py): at (16384, 4096) one or four waves of
// resident blocks walking the tiles grid-stride cost 3-6%, the hints
// 2-4%; at (1024, 256) the hints save ~8%; 2 or 4 vectors a thread and
// 128-thread blocks move either under 1-3%. The matmul at
// 4096^3 does 2*4096^3 operations on 100 MB (bf16): operations, on the
// tensor cores (989 TFLOP/s bf16, 1,979 TOP/s int8), as the TPU kernels
// ran on the MXU.
//
// Matmul design: the wgmma core of wgmma_core.cuh. A block of three
// warpgroups owns a 128x128 output tile; the producer warpgroup fills a
// ring of 128-byte-deep K slices (64 bf16 or 128 int8 values) and the two
// consumer warpgroups each run wgmma on 64 rows of it, summing in
// registers. The TPU kernels' k grid axis with its scratch accumulator is
// the ring's walk over K inside the block.
//   bf16: one producer thread issues TMA loads (tensor maps encoded on the
//     host per call, 128-byte swizzle) of A's 128x64 box and B's two 64x64
//     boxes, five stages in flight. B lands MN-major, as the row-major
//     (K, N) input lies, and wgmma reads it so through the transpose bit.
//     K = 32 (half a slice) works: TMA fills the box past K with zeros.
//   int8: wgmma reads s8 operands K-major only, and the probes pass B
//     row-major (K, N), N-major. Route (a): two producer warpgroups take
//     every other stage; TMA lands each 128x128 B tile as it lies in one
//     of the producer's two staging buffers, a tile ahead of the one
//     being transposed, and the producer's 128 threads transpose it into
//     the K-major swizzled tile of the stage, 4x4 byte blocks with eight
//     byte permutes each, lanes placed so that neither the reads nor the
//     writes meet a bank conflict; then fence.proxy.async and an arrive
//     on the stage's barrier (129 arrivals: the TMA of A's tile and the
//     128 transposing threads). Four stages. A is loaded as for bf16.
// Epilogue: each consumer thread writes its accumulator pairs straight
// from registers, bf16 rounded to nearest even or int8 wrapped.
// M and N must be multiples of 128 and K of 32 (bf16) or 64 (int8); the
// wrapper raises otherwise, as the TPU kernels' `n // tile` grids assumed.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "wgmma_core.cuh"

namespace {

// ---------------------------------------------------------------- add

constexpr int kAddThreads = 256;
constexpr int kAddVecs = 1;   // vectors of x and of y a thread loads at once
// The grid: 0 gives a block to every tile; k > 0 at most k waves of the
// blocks the SMs hold at once, each walking tiles grid-stride.
constexpr int kAddWaves = 0;
// Streaming cache hints (evict first) while x, y and out together fit
// the 50 MB L2: measured faster at 3 MB, slower at 805 MB; the sizes
// between were not measured.
constexpr long long kHintBytes = 50LL << 20;

template <bool kHint, typename V>
__device__ __forceinline__ V load_once(const V* p) {
  if constexpr (kHint) return __ldcs(p);
  return *p;
}
template <bool kHint, typename V>
__device__ __forceinline__ void store_once(V* p, V v) {
  if constexpr (kHint) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float plus(float a, float b) { return a + b; }

// out = x + y over n floats, as n / (sizeof(V) / 4) vectors V, then the
// floats past the last whole vector. A block takes tiles of kAddVecs *
// kAddThreads vectors, grid-stride; thread t loads vectors t, t +
// kAddThreads, ... of a tile, so each of its loads is coalesced.
template <typename V, bool kHint>
__global__ void __launch_bounds__(kAddThreads)
    add_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, long long n) {
  constexpr int kPer = sizeof(V) / sizeof(float);
  constexpr long long kTile = static_cast<long long>(kAddVecs) * kAddThreads;
  const long long nv = n / kPer;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* yv = reinterpret_cast<const V*>(y);
  V* ov = reinterpret_cast<V*>(out);
  for (long long i = blockIdx.x * kTile + threadIdx.x; i < nv;
       i += gridDim.x * kTile) {
    V a[kAddVecs], b[kAddVecs];
#pragma unroll
    for (int j = 0; j < kAddVecs; ++j) {
      if (i + j * kAddThreads < nv) {
        a[j] = load_once<kHint>(xv + i + j * kAddThreads);
        b[j] = load_once<kHint>(yv + i + j * kAddThreads);
      }
    }
#pragma unroll
    for (int j = 0; j < kAddVecs; ++j) {
      if (i + j * kAddThreads < nv)
        store_once<kHint>(ov + i + j * kAddThreads, plus(a[j], b[j]));
    }
  }
  const long long tail =
      nv * kPer + blockIdx.x * static_cast<long long>(blockDim.x) +
      threadIdx.x;
  if (tail < n) out[tail] = x[tail] + y[tail];
}

// A block for each tile of kAddVecs * kAddThreads vectors, or at most
// kAddWaves waves of the blocks the SMs hold at once.
template <typename V, bool kHint>
unsigned add_grid(long long nv) {
  const long long tiles =
      (nv + kAddThreads * kAddVecs - 1) / (kAddThreads * kAddVecs);
  if (kAddWaves == 0) return static_cast<unsigned>(tiles < 1 ? 1 : tiles);
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, add_f32_kernel<V, kHint>, kAddThreads, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap =
      static_cast<long long>(kAddWaves) * per_sm * (sms > 0 ? sms : 1);
  return static_cast<unsigned>(tiles < 1 ? 1 : (tiles < cap ? tiles : cap));
}

template <typename V, bool kHint>
void launch_add(const float* x, const float* y, float* out, long long n,
                cudaStream_t s) {
  add_f32_kernel<V, kHint>
      <<<add_grid<V, kHint>(n / (sizeof(V) / sizeof(float))), kAddThreads, 0,
         s>>>(x, y, out, n);
}

// -------------------------------------------------------------- matmul

namespace wg = qtt::wg;

constexpr int kBf16Stages = 5;
constexpr int kS8Stages = 4;
constexpr int kS8Producers = 2;        // transposing warpgroups
constexpr int kS8Staging = 4;          // B tiles as they land, N-major:
                                       // two per producer
constexpr int kBf16Slice = 64;         // K values per stage
constexpr int kS8Slice = 128;

// One 128x128 int8 B tile from `src` (as TMA landed it: row k holds 128
// bytes of n, chunk c at c ^ (k % 8)) into `dst` (K-major: row n holds
// 128 bytes of k, chunk c at c ^ (n % 8)), by the 128 producer threads.
// The tile is 32x32 blocks of 4x4 bytes: n-quad q, k-quad kq. Thread t
// takes 8 of them; its lane bits l0..l4 fix q's bits 0-3 and kq's bits
// 0-3 (XORed with the block index) so that, for each of the four rows
// one load or store instruction touches, the warp's 32 words fall on 32
// distinct banks both in `src` and in `dst`.
__device__ __forceinline__ void transpose_tile(uint32_t src, uint32_t dst,
                                               int t) {
  const int l = t % 32;
  const int l0 = l & 1, l1 = (l >> 1) & 1, l2 = (l >> 2) & 1;
  const int l3 = (l >> 3) & 1, l4 = l >> 4;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int s = (t / 32) * 8 + it;  // 0..31: which (q, kq) class
    const int q = l0 | l1 << 1 | l3 << 2 | l4 << 3 | (s & 1) << 4;
    const int kq = l2 | (l1 ^ ((s >> 1) & 1)) << 1 |
                   (l3 ^ ((s >> 2) & 1)) << 2 | (l4 ^ ((s >> 3) & 1)) << 3 |
                   ((s >> 4) & 1) << 4;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kq + i;
      r[i] = wg::ld_shared(src + k * wg::kRowBytes +
                       (((q >> 2) ^ (k & 7)) << 4) + (q & 3) * 4);
    }
    // r[i] byte j is B[k + i][4q + j]; o[j] byte i must be the same.
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = 4 * q + j;
      wg::st_shared(dst + nn * wg::kRowBytes + (((kq >> 2) ^ (nn & 7)) << 4) +
                    (kq & 3) * 4,
                o[j]);
    }
  }
}

__global__ void __launch_bounds__(wg::threads(1), 1)
    tiled_matmul_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b,
                             __nv_bfloat16* __restrict__ out, int n, int k) {
  extern __shared__ unsigned char smem[];
  using Ring = wg::Ring<kBf16Stages>;
  const Ring ring(smem, 0);
  const int m0 = blockIdx.y * wg::kBM;
  const int n0 = blockIdx.x * wg::kBN;
  const int k_tiles = (k + kBf16Slice - 1) / kBf16Slice;
  wg::gemm_block<float, kBf16Stages, 1, 40>(
      ring, k_tiles, 1,
      [&](const Ring& r, int) {
        if (threadIdx.x != 0) return;
        for (int kt = 0; kt < k_tiles; ++kt) {
          const int s = kt % kBf16Stages;
          const int k0 = kt * kBf16Slice;
          wg::wait_empty(r, kt);
          wg::mbar_arrive_tx(r.full(s), wg::kStageBytes);
          wg::tma_load_2d(r.a(s), &map_a, r.full(s), k0, m0);
          wg::tma_load_2d(r.b(s), &map_b, r.full(s), n0, k0);
          wg::tma_load_2d(r.b(s) + wg::kTileBytes / 2, &map_b, r.full(s),
                          n0 + 64, k0);
        }
      },
      [&](const float* d, int ci) {
        wg::for_each_pair(d, ci, [&](int row, int col, float v0, float v1) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(m0 + row) * n + n0 + col) =
              __floats2bfloat162_rn(v0, v1);
        });
      });
}

__global__ void __launch_bounds__(wg::threads(kS8Producers), 1)
    tiled_matmul_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           signed char* __restrict__ out, int n, int k) {
  extern __shared__ unsigned char smem[];
  using Ring = wg::Ring<kS8Stages>;
  const Ring ring(smem, kS8Staging * wg::kTileBytes);
  const int m0 = blockIdx.y * wg::kBM;
  const int n0 = blockIdx.x * wg::kBN;
  const int k_tiles = (k + kS8Slice - 1) / kS8Slice;
  wg::gemm_block<int, kS8Stages, kS8Producers, 112>(
      ring, k_tiles, 1 + 128,
      [&](const Ring& r, int p) {
        const int t = threadIdx.x % 128;
        // Producer p takes tiles kt = p + 2u. B tile u of its own lands
        // in its staging buffer u % 2, on the spare barrier of that
        // number, one own tile (two stages) ahead of its transpose.
        auto buffer = [&](int u) { return 2 * p + u % 2; };
        auto land = [&](int u) {
          const int i = buffer(u);
          wg::mbar_arrive_tx(r.spare(i), wg::kTileBytes);
          wg::tma_load_2d(r.scratch + i * wg::kTileBytes, &map_b, r.spare(i),
                          n0, (p + kS8Producers * u) * kS8Slice);
        };
        if (t == 0 && p < k_tiles) land(0);
        for (int u = 0, kt = p; kt < k_tiles; ++u, kt += kS8Producers) {
          const int s = kt % kS8Stages;
          wg::wait_empty(r, kt);
          if (t == 0) {
            wg::mbar_arrive_tx(r.full(s), wg::kTileBytes);
            wg::tma_load_2d(r.a(s), &map_a, r.full(s), kt * kS8Slice, m0);
            // That buffer was last read in step u - 1, which every
            // thread of this producer has left (the sync below).
            if (kt + kS8Producers < k_tiles) land(u + 1);
          }
          const int i = buffer(u);
          wg::mbar_wait(r.spare(i), (u / 2) & 1);
          transpose_tile(r.scratch + i * wg::kTileBytes, r.b(s), t);
          wg::fence_proxy_async();
          wg::mbar_arrive(r.full(s));
          wg::producer_sync(p);
        }
      },
      [&](const int* d, int ci) {
        wg::for_each_pair(d, ci, [&](int row, int col, int v0, int v1) {
          *reinterpret_cast<uint16_t*>(
              out + static_cast<long long>(m0 + row) * n + n0 + col) =
              static_cast<uint16_t>((v0 & 0xff) | (v1 & 0xff) << 8);
        });
      });
}

// cuTensorMapEncodeTiled lives in libcuda, not the runtime; the runtime
// hands out its entry point, so the library needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A row-major (outer, inner) matrix of 1- or 2-byte values, read in boxes
// of (box_outer, box_inner) with the 128-byte swizzle (box_inner * size
// must be 128 bytes), zeros past its edges.
int encode_map(CUtensorMap* map, const void* base, bool two_bytes,
               int inner, int outer, int box_inner, int box_outer) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int size = two_bytes ? 2 : 1;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * size};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                       static_cast<cuuint32_t>(box_outer)};
  cuuint32_t steps[2] = {1, 1};
  CUresult r = encode(
      map,
      two_bytes ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename Kernel>
int launch_matmul(Kernel kernel, int threads, int smem_bytes, int slice,
                  int box_b_n,
                  int box_b_k, int k_multiple, const void* a, const void* b,
                  void* out, int m, int n, int k, void* stream) {
  if (m % wg::kBM || n % wg::kBN || k % k_multiple || m <= 0 || n <= 0 ||
      k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = sizeof(T) == 2;
  CUtensorMap map_a, map_b;
  int e = encode_map(&map_a, a, two, k, m, slice, wg::kBM);
  if (e) return e;
  e = encode_map(&map_b, b, two, n, k, box_b_n, box_b_k);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / wg::kBN, m / wg::kBM);
  kernel<<<grid, threads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(map_a, map_b,
                                                static_cast<T*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qtt_add_f32(const void* x, const void* y, void* out,
                           long long n, int vec4, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<const float*>(y);
  auto os = static_cast<float*>(out);
  const bool hint = 12 * n <= kHintBytes;  // x, y and out, 4 bytes each
  if (vec4 && hint) {
    launch_add<float4, true>(xs, ys, os, n, s);
  } else if (vec4) {
    launch_add<float4, false>(xs, ys, os, n, s);
  } else if (hint) {
    launch_add<float, true>(xs, ys, os, n, s);
  } else {
    launch_add<float, false>(xs, ys, os, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qtt_tiled_matmul_bf16(const void* a, const void* b, void* out,
                                     int m, int n, int k, void* stream) {
  return launch_matmul<__nv_bfloat16>(
      tiled_matmul_bf16_kernel, wg::threads(1),
      wg::Ring<kBf16Stages>::smem_bytes(0),
      kBf16Slice, 64, kBf16Slice, 32, a, b, out, m, n, k, stream);
}

extern "C" int qtt_tiled_matmul_s8(const void* a, const void* b, void* out,
                                   int m, int n, int k, void* stream) {
  return launch_matmul<signed char>(
      tiled_matmul_s8_kernel, wg::threads(kS8Producers),
      wg::Ring<kS8Stages>::smem_bytes(kS8Staging * wg::kTileBytes),
      kS8Slice, kS8Slice, kS8Slice, 64, a, b, out, m, n, k, stream);
}
