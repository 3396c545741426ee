// A warp-specialised wgmma GEMM core for Hopper (sm_90a), shared by
// probe.cu (tiled_matmul, bf16 and int8, tiles brought in by TMA) and
// xnor.cu (xnor_gemm, tiles expanded from packed sign words).
//
// A block of P + 2 warpgroups owns a kBM x kBN = 128 x 128 output tile:
//
//   warpgroups 0..P-1  the producers (P = 1 or 2): the client's loader
//                    fills a ring of `Stages` shared-memory stages, each
//                    one 128-byte-deep K slice of A (128 rows) and of B
//                    (128 columns), and completes the stage's `full`
//                    mbarrier; with two, each takes every other stage. A
//                    loader that issues TMA needs one producer, one that
//                    expands or transposes tiles with its threads takes
//                    two, for twice the warps to hide their latencies.
//                    They lower their registers with setmaxnreg.dec and
//                    the consumers raise theirs by as many.
//   the last two     the consumers: each waits on a stage's `full`
//                    barrier, runs four wgmma.mma_async on its 64-row half
//                    of the tile (m64n128, K 32 bytes each) and, once the
//                    next stage's are issued, waits for them and arrives
//                    on the stage's `empty` barrier, so the producer may
//                    refill it. The sums stay in registers
//                    (64 a thread) until the client's epilogue writes
//                    them out.
//
// Shared memory (dynamic, rounded up to 1024 bytes, which the 128-byte
// swizzle's atom needs): `Stages` x (A tile, B tile) of 16 KB each, then
// the client's own scratch, then the barriers.
//
// Tile layouts. Both A tiles and the int8 B tiles are K-major: row r (an
// output row of A, or an output column of B) holds 128 bytes of K, and
// its 16-byte chunk c sits at chunk c ^ (r % 8) of the row (TMA's
// SWIZZLE_128B, which the loaders that write tiles themselves repeat).
// The bf16 B tile is MN-major, as B (K, N) row-major lands: two 8 KB
// halves of 64 columns each, one row of 128 bytes (64 columns) per k,
// swizzled the same way by k % 8. wgmma reads s8 operands K-major only,
// which is why the int8 and xnor loaders write B K-major themselves.

#pragma once

#include <stdint.h>

namespace qtt {
namespace wg {

constexpr int kBM = 128;              // tile rows (two 64-row consumers)
constexpr int kBN = 128;              // tile columns
constexpr int kRowBytes = 128;        // K bytes of one tile row per stage
constexpr int kTileBytes = 128 * kRowBytes;   // one operand, one stage
constexpr int kStageBytes = 2 * kTileBytes;   // A then B
constexpr int kConsumers = 2;
// Threads of a block with `producers` producer warpgroups (1 or 2).
__host__ __device__ constexpr int threads(int producers) {
  return 128 * (kConsumers + producers);
}
// Registers a thread of such a block starts with: the register file
// split evenly (the launch bound's minimum of one block an SM), in
// multiples of 8.
__host__ __device__ constexpr int start_regs(int producers) {
  return 65536 / threads(producers) / 8 * 8;
}
// What a consumer thread may take once the producers have lowered theirs
// to `producer_regs`: all they gave up, split between the consumers.
__host__ __device__ constexpr int consumer_regs(int producers,
                                               int producer_regs) {
  return (start_regs(producers) +
          producers * (start_regs(producers) - producer_regs) / kConsumers) /
         8 * 8;
}
constexpr int kAcc = 64;              // accumulators a consumer thread holds

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory loads and stores by shared address (a loader's tiles).
__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive, and add `bytes` to what the barrier's phase waits for (TMA).
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. On a fresh
// barrier parity 1 passes at once (the phase before the first counts as
// done), which is how a producer's first pass over empty stages goes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory (a loader's st.shared) made
// visible to the async proxy that wgmma and TMA read through. Without it
// a consumer may read a stale tile, and only sometimes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over producer warpgroup p alone (named barrier 1 + p).
__device__ __forceinline__ void producer_sync(int p) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + p) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ------------------------------------------------------------------ TMA

// A 2-D box of `map` at (inner c0, outer c1) into shared memory at dst;
// completes its bytes on `bar`. Parts of the box past the tensor's edge
// arrive as zeros and still count as bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ------------------------------------------------------------- cp.async

// 4 bytes from global to shared memory, completed by cp_async_wait.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- wgmma

// The shared-memory matrix descriptor, the one place it is built.
//   bits  0-13  start address >> 4. A K step moves it by 32 bytes inside
//               the 128-byte swizzled row (K-major) or by 16 rows of 128
//               bytes (MN-major); the hardware swizzles the address it
//               forms, so the tile base must sit on 1024 bytes.
//   bits 16-29  leading byte offset >> 4. K-major with a 128-byte swizzle:
//               unused (the K of one wgmma, 32 bytes, lies inside a row),
//               set to 1. MN-major (bf16 B): the step from the first 64
//               columns to the next 64, one 8 KB half, 8192.
//   bits 32-45  stride byte offset >> 4: the step between groups of 8
//               rows. K-major: 8 rows of 128 bytes (8 M or N rows), 1024.
//               MN-major: 8 k rows of 128 bytes, 1024.
//   bits 49-51  base offset: 0, the tiles sit on 1024 bytes.
//   bits 62-63  layout: 1, the 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
constexpr uint32_t kSbo = 1024;
constexpr uint32_t kLboKMajor = 16;
constexpr uint32_t kLboMnMajor = kTileBytes / 2;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pins the accumulators in place around the asynchronous wgmma, so the
// compiler moves no read or copy of them across the issue and the wait.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define QTT_ACC8(C, i)                                                   \
  "+" C(d[i]), "+" C(d[i + 1]), "+" C(d[i + 2]), "+" C(d[i + 3]),        \
      "+" C(d[i + 4]), "+" C(d[i + 5]), "+" C(d[i + 6]), "+" C(d[i + 7])
#define QTT_ACC64(C)                                                     \
  QTT_ACC8(C, 0), QTT_ACC8(C, 8), QTT_ACC8(C, 16), QTT_ACC8(C, 24),      \
      QTT_ACC8(C, 32), QTT_ACC8(C, 40), QTT_ACC8(C, 48), QTT_ACC8(C, 56)
#define QTT_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// scale-d is a predicate operand, set from a register (1: D += A * B).
//
// d (64 rows x 128 columns, f32) += A (64 x 16 bf16, K-major)
//                                 * B (16 x 128 bf16, MN-major: tnspB=1).
__device__ __forceinline__ void mma_bf16(float* d, uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QTT_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : QTT_ACC64("f")
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, s32) += A (64 x 32 s8, K-major) * B (32 x 128 s8, K-major).
__device__ __forceinline__ void mma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " QTT_D64
      ", %64, %65, p;\n}\n"
      : QTT_ACC64("r")
      : "l"(da), "l"(db), "r"(1));
}

#undef QTT_ACC8
#undef QTT_ACC64
#undef QTT_D64

// One stage's four wgmma for a consumer: rows 64*ci.. of the A tile
// against the whole B tile, K 128 bytes in four steps of 32.
__device__ __forceinline__ void stage_mma(float* d, uint32_t a, uint32_t b,
                                          int ci) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_bf16(d, make_desc(a + ci * 64 * kRowBytes + kk * 32, kLboKMajor,
                          kSbo),
             make_desc(b + kk * 16 * kRowBytes, kLboMnMajor, kSbo));
}
__device__ __forceinline__ void stage_mma(int* d, uint32_t a, uint32_t b,
                                          int ci) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_s8(d, make_desc(a + ci * 64 * kRowBytes + kk * 32, kLboKMajor, kSbo),
           make_desc(b + kk * 32, kLboKMajor, kSbo));
}

// ----------------------------------------------------------------- ring

// The stages, their barriers and the client's scratch, carved out of
// dynamic shared memory.
template <int Stages>
struct Ring {
  static constexpr int kBarrierBytes = 2 * Stages * 8 + 64;
  // Dynamic shared memory a launch asks for: the alignment slack, the
  // stages, `scratch` bytes of the client's, the barriers.
  static constexpr int smem_bytes(int scratch) {
    return 1024 + Stages * kStageBytes + scratch + kBarrierBytes;
  }

  uint32_t base;     // stage 0's A tile, on 1024 bytes
  uint32_t scratch;  // the client's scratch, on 1024 bytes
  uint32_t bars;     // full[Stages], empty[Stages], then 8 spare barriers

  __device__ Ring(unsigned char* raw, int scratch_bytes) {
    base = (smem_u32(raw) + 1023u) & ~1023u;
    scratch = base + Stages * kStageBytes;
    bars = scratch + scratch_bytes;
  }
  __device__ uint32_t a(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t b(int s) const { return a(s) + kTileBytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (Stages + s); }
  // Spare barrier i (0-7) for the client.
  __device__ uint32_t spare(int i) const {
    return bars + 8 * (2 * Stages + i);
  }
};

// The producer's walk over the K tiles: stage and phase of tile kt.
template <int Stages>
__device__ __forceinline__ void wait_empty(const Ring<Stages>& r, int kt) {
  mbar_wait(r.empty(kt % Stages), ((kt / Stages) & 1) ^ 1);
}

// The block's work: barriers, then producer warpgroup p (of Producers)
// runs `produce(ring, p)`, which fills the K tiles kt = p, p +
// Producers, ... in order and completes each one's full barrier
// (`full_count` arrivals a phase), and each consumer warpgroup
// accumulates its 64 rows and calls `epilogue(d, ci)` with its
// accumulators. The producers lower their registers to ProducerRegs and
// the consumers raise theirs by what that frees (the kernel's launch
// bound must be threads(Producers) with one block an SM).
//
// Accumulator layout (PTX m64nN): consumer thread t = 32 * w + l holds,
// for each 8-column block j, d[4j], d[4j+1] at row 16w + l/4 and columns
// 8j + 2(l%4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below.
template <typename Acc, int Stages, int Producers, int ProducerRegs,
          typename Produce, typename Epilogue>
__device__ __forceinline__ void gemm_block(const Ring<Stages>& ring,
                                           int k_tiles, uint32_t full_count,
                                           Produce produce,
                                           Epilogue epilogue) {
  const int wg_idx = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(ring.full(s), full_count);
      mbar_init(ring.empty(s), kConsumers);
    }
    for (int i = 0; i < 8; ++i) mbar_init(ring.spare(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg_idx < Producers) {
    setmaxnreg_dec<ProducerRegs>();
    produce(ring, wg_idx);
  } else {
    setmaxnreg_inc<consumer_regs(Producers, ProducerRegs)>();
    const int ci = wg_idx - Producers;
    Acc d[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = 0;
    // One stage's wgmma stay in flight while the next stage's are
    // issued: a stage is released once the group after it is queued.
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % Stages;
      mbar_wait(ring.full(s), (kt / Stages) & 1);
      fence_acc(d);
      wgmma_fence();
      stage_mma(d, ring.a(s), ring.b(s), ci);
      wgmma_commit();
      wgmma_wait_one();
      fence_acc(d);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(ring.empty((kt - 1) % Stages));
    }
    wgmma_wait_all();
    fence_acc(d);
    epilogue(d, ci);
  }
}

// Calls fn(row, col, v0, v1) for each pair of neighbouring accumulators
// of consumer ci, in tile coordinates (v1 at col + 1).
template <typename Acc, typename Fn>
__device__ __forceinline__ void for_each_pair(const Acc* d, int ci, Fn fn) {
  const int t = threadIdx.x % 128;
  const int row = 64 * ci + 16 * (t / 32) + (t % 32) / 4;
  const int col = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    fn(row, 8 * j + col, d[4 * j], d[4 * j + 1]);
    fn(row + 8, 8 * j + col, d[4 * j + 2], d[4 * j + 3]);
  }
}

}  // namespace wg
}  // namespace qtt
