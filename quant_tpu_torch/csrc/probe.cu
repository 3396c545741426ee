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
// tensor cores, as the TPU kernels ran on the MXU.
//
// Matmul design (a simple one that is right; wgmma, TMA and a deeper
// ring are later work). A block of 8 warps owns a 128x128 output tile;
// each warp a 64x32 piece of it, as 4x2 WMMA 16x16x16 fragments (bf16 or
// s8 in, f32 or s32 accumulators in registers). The TPU kernels' k grid
// axis with its scratch accumulator becomes a loop over K inside the
// block: 64-byte-deep slices of A and B (32 bf16 or 64 int8 values) move
// to shared memory with cp.async, three slices in flight. Shared memory
// holds each operand as 16-column chunks, so every fragment starts on a
// 32-byte boundary (WMMA requires it; an int8 fragment 16 values into a
// row would not), and the 16-byte rows of an int8 chunk, or the 48-byte
// padded rows of a bf16 chunk, give conflict-free fragment loads. The
// epilogue stages each fragment through 1 KB of shared memory per warp,
// converts it to the output type and stores 8 values per lane.
// M and N must be multiples of 128 and K of the slice depth; the wrapper
// raises otherwise, as the TPU kernels' `n // tile` grids assumed.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

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

constexpr int kBM = 128;       // block tile rows
constexpr int kBN = 128;       // block tile columns
constexpr int kWarpsM = 2;     // warps along M (64 rows each)
constexpr int kWarpsN = 4;     // warps along N (32 columns each)
constexpr int kFragsM = 4;     // 16-row fragments per warp
constexpr int kFragsN = 2;     // 16-column fragments per warp
constexpr int kMmThreads = 32 * kWarpsM * kWarpsN;
constexpr int kStages = 3;     // K slices in flight
constexpr int kSliceBytes = 64;  // bytes of K per slice and row

template <typename T>
struct MmTraits;

template <>
struct MmTraits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kLd = 24;  // chunk row pitch: 48 bytes
  // 8 accumulators -> 8 bf16 (round to nearest even), one 16-byte store.
  __device__ static void store8(__nv_bfloat16* dst, const float* s) {
    uint4 u;
    __nv_bfloat162 h;
    h = __floats2bfloat162_rn(s[0], s[1]);
    u.x = *reinterpret_cast<unsigned*>(&h);
    h = __floats2bfloat162_rn(s[2], s[3]);
    u.y = *reinterpret_cast<unsigned*>(&h);
    h = __floats2bfloat162_rn(s[4], s[5]);
    u.z = *reinterpret_cast<unsigned*>(&h);
    h = __floats2bfloat162_rn(s[6], s[7]);
    u.w = *reinterpret_cast<unsigned*>(&h);
    *reinterpret_cast<uint4*>(dst) = u;
  }
};

template <>
struct MmTraits<signed char> {
  using Acc = int;
  static constexpr int kLd = 16;  // chunk row pitch: 16 bytes
  // 8 accumulators -> their low bytes (the int32 -> int8 wrap).
  __device__ static void store8(signed char* dst, const int* s) {
    unsigned lo = (s[0] & 0xff) | (s[1] & 0xff) << 8 | (s[2] & 0xff) << 16 |
                  static_cast<unsigned>(s[3] & 0xff) << 24;
    unsigned hi = (s[4] & 0xff) | (s[5] & 0xff) << 8 | (s[6] & 0xff) << 16 |
                  static_cast<unsigned>(s[7] & 0xff) << 24;
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
};

template <typename T>
struct MmTile {
  static constexpr int kBK = kSliceBytes / static_cast<int>(sizeof(T));
  static constexpr int kLd = MmTraits<T>::kLd;
  // Elements per 16-byte cp.async.
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  // A slice: kBK/16 chunks of (kBM rows x 16 columns of K), pitch kLd.
  static constexpr int kAChunk = kBM * kLd;
  static constexpr int kAElems = (kBK / 16) * kAChunk;
  // B slice: kBN/16 chunks of (kBK rows of K x 16 columns of N).
  static constexpr int kBChunk = kBK * kLd;
  static constexpr int kBElems = (kBN / 16) * kBChunk;
  static constexpr int kStageBytes =
      (kAElems + kBElems) * static_cast<int>(sizeof(T));
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ void load_slice(T* sa, T* sb,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b, int n,
                                           int k, int m0, int n0, int k0) {
  using Tile = MmTile<T>;
  constexpr int kAPerRow = Tile::kBK / Tile::kVec;  // 16-byte pieces
  constexpr int kAPieces = kBM * kAPerRow;
  constexpr int kBPerRow = kBN / Tile::kVec;
  constexpr int kBPieces = Tile::kBK * kBPerRow;
  for (int p = threadIdx.x; p < kAPieces; p += kMmThreads) {
    int row = p / kAPerRow;
    int kc = (p % kAPerRow) * Tile::kVec;
    cp_async16(sa + (kc / 16) * Tile::kAChunk + row * Tile::kLd + kc % 16,
               a + static_cast<long long>(m0 + row) * k + k0 + kc);
  }
  for (int p = threadIdx.x; p < kBPieces; p += kMmThreads) {
    int krow = p / kBPerRow;
    int nc = (p % kBPerRow) * Tile::kVec;
    cp_async16(sb + (nc / 16) * Tile::kBChunk + krow * Tile::kLd + nc % 16,
               b + static_cast<long long>(k0 + krow) * n + n0 + nc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMmThreads)
    tiled_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        T* __restrict__ out, int n, int k) {
  using Tile = MmTile<T>;
  using Acc = typename MmTraits<T>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN;  // 64-row band of the block tile
  const int wn = warp % kWarpsN;  // 32-column band
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[kFragsM][kFragsN];
#pragma unroll
  for (int i = 0; i < kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0);

  auto stage_a = [&](int s) {
    return reinterpret_cast<T*>(smem + s * Tile::kStageBytes);
  };
  auto stage_b = [&](int s) { return stage_a(s) + Tile::kAElems; };

  const int slices = k / Tile::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices)
      load_slice(stage_a(s), stage_b(s), a, b, n, k, m0, n0, s * Tile::kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < slices; ++kt) {
    // Slice kt has landed; every warp is done with slice kt - 1, whose
    // buffer the next load reuses.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    int next = kt + kStages - 1;
    if (next < slices)
      load_slice(stage_a(next % kStages), stage_b(next % kStages), a, b, n,
                 k, m0, n0, next * Tile::kBK);
    cp_async_commit();

    const T* sa = stage_a(kt % kStages);
    const T* sb = stage_b(kt % kStages);
#pragma unroll
    for (int kk = 0; kk < Tile::kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
          fa[kFragsM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>
          fb[kFragsN];
#pragma unroll
      for (int i = 0; i < kFragsM; ++i)
        wmma::load_matrix_sync(
            fa[i], sa + kk * Tile::kAChunk + (wm * 64 + i * 16) * Tile::kLd,
            Tile::kLd);
#pragma unroll
      for (int j = 0; j < kFragsN; ++j)
        wmma::load_matrix_sync(
            fb[j],
            sb + (wn * kFragsN + j) * Tile::kBChunk + kk * 16 * Tile::kLd,
            Tile::kLd);
#pragma unroll
      for (int i = 0; i < kFragsM; ++i)
#pragma unroll
        for (int j = 0; j < kFragsN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Epilogue: the pipeline buffers are free once every warp is past its
  // last slice; each warp then owns 256 accumulators' worth of them.
  cp_async_wait<0>();
  __syncthreads();
  Acc* scratch = reinterpret_cast<Acc*>(smem) + warp * 256;
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFragsM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      long long row = m0 + wm * 64 + i * 16 + r;
      int col = n0 + wn * 32 + j * 16 + c0;
      MmTraits<T>::store8(out + row * n + col, scratch + r * 16 + c0);
      __syncwarp();
    }
  }
}

template <typename T>
int launch_matmul(const void* a, const void* b, void* out, int m, int n,
                  int k, void* stream) {
  using Tile = MmTile<T>;
  if (m % kBM || n % kBN || k % Tile::kBK || m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of dynamic shared memory needs the opt-in (bf16: 72 KB).
  cudaError_t e = cudaFuncSetAttribute(
      tiled_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n / kBN, m / kBM);
  tiled_matmul_kernel<T><<<grid, kMmThreads, Tile::kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
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
  return launch_matmul<__nv_bfloat16>(a, b, out, m, n, k, stream);
}

extern "C" int qtt_tiled_matmul_s8(const void* a, const void* b, void* out,
                                   int m, int n, int k, void* stream) {
  return launch_matmul<signed char>(a, b, out, m, n, k, stream);
}
