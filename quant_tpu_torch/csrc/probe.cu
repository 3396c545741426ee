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
// one: bytes. Each thread walks the array grid-stride with 16-byte loads
// when all three pointers allow it (scalar otherwise). The matmul at
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

__global__ void add_f32_vec4_kernel(const float4* __restrict__ x,
                                    const float4* __restrict__ y,
                                    float4* __restrict__ out, long long n4) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 a = x[i], b = y[i];
    out[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

__global__ void add_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               float* __restrict__ out, long long begin,
                               long long n) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = begin + blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = x[i] + y[i];
  }
}

// Enough blocks to fill the card several times over; the loops stride.
unsigned grid_for(long long n) {
  long long blocks = (n + qtt::kThreads - 1) / qtt::kThreads;
  return static_cast<unsigned>(blocks < 4096 ? (blocks > 0 ? blocks : 1)
                                             : 4096);
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
  auto s = static_cast<cudaStream_t>(stream);
  long long n4 = vec4 ? n / 4 : 0;
  if (n4 > 0) {
    add_f32_vec4_kernel<<<grid_for(n4), qtt::kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(y),
        static_cast<float4*>(out), n4);
  }
  if (4 * n4 < n) {
    add_f32_kernel<<<grid_for(n - 4 * n4), qtt::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<float*>(out), 4 * n4, n);
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
