// The ls-2 / ls-T 'lloyd' solve of every row of a (R, N) matrix in one
// launch: v1 by 1-D 2-means on |x[::skip]| (ops/optimal.py
// `_opt_v1_lloyd`), and for ls-2 also v2 = mean |x - v1 * sign(x)| over
// the whole row (ops/quantize.py `_solve_ls_2`), into a (2, R) or (R,)
// float32 output. The rows are the samples of an activation (NHWC order)
// or the out-channels of a weight, in bf16 or float32.
//
// Replaces no TPU kernel: the JAX package leaves the solve to XLA
// (quant_tpu/ops/optimal.py). In the port it ran as eager PyTorch, about
// 17 launches a Lloyd iteration over (R, 3, M) temporaries, so the host's
// launches set its pace; this kernel is added to take that off the path.
//
// The arithmetic is the plain path's, op for op in float32 with no fused
// multiply-add: three starts scale * (0.5 mean, mean, 0.5 (mean + max)),
// scale 0.5 for ternary; 12 iterations of c2 = s2 / max(n2, 1) and c1 =
// (total - s2) / max(m - n2, 1), moved only where 0 < n2 < m (2-bit), or
// v = c2 / 2 where n2 > 0 (ternary); the final a <= v split, the closed-form
// cost (`_candidate_costs`) and the first minimum of the three costs, a
// NaN cost winning as torch.argmin does. Counts are exact integers. Only
// the order of the float32 sums differs from PyTorch's, so v1 agrees with
// the plain path to a few ulps where the cost is not flat.
//
// Every sum runs in one fixed order that depends on N, skip and the dtype
// alone, so a row gives the same bits in every call, whatever R and however
// many blocks share the row. A row is worked by kLanes logical lanes:
//   - samples come in units of 16 bytes (8 bf16 or 4 float32 magnitudes);
//     lane l takes unit k * kLanes + l in round k and sums its samples in
//     round order, then unit order;
//   - the lanes' partial sums meet in a butterfly over the lane index,
//     low bits first across warps: within a warp (shuffles), across a
//     block's warps (one warp's shuffles), then across the blocks of a
//     cluster in the same pairwise order (distributed shared memory);
//   - a cluster of C blocks gives block b lanes [b, b + 1) * kLanes / C,
//     so C changes which SM adds, never what is added to what.
//
// What bounds it on an H100: first the bytes. The 16 binary-conv inputs
// of a ResNet-18 sample hold 1,680,896 values; at batch 256 in bf16 a
// forward's solves read 860.6 MB, 0.257 ms at 3.35 TB/s. Then the Lloyd
// loop: 13 passes over the sampled third, a compare and a predicated add
// and count for each of three thresholds, on the CUDA cores. The design:
//   - the row is read from device memory once for the samples, with
//     16-byte loads (skip vectors a unit, every skip-th element kept),
//     and their magnitudes stay in shared memory in the input's dtype
//     (|x| of a bf16 is exact in bf16: the sign bit cleared). The sums,
//     the sum of squares and the max come in that same pass;
//   - the 13 passes run from shared memory and registers: a thread holds
//     (n2, s2) of the three thresholds, and each pass ends in one
//     reduction whose result every thread of the cluster computes alike,
//     so the thresholds never leave registers;
//   - v2 streams the whole row once more (16-byte loads, from L2 where it
//     still sits) and the scales go straight into the output;
//   - a row whose samples do not fit in one block's shared memory (float32
//     rows over about 56 k samples) is spread over a cluster of 2, 4 or 8
//     blocks, each holding its lanes' units; few rows against the SMs
//     (a rank's band of a batch, a calibration batch) are spread the same
//     way, so more SMs share the rows. A row too large for 8 blocks reads
//     its samples from device memory in every pass, in the same order.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 512;     // logical lanes a row, over its cluster
constexpr int kIters = 12;      // Lloyd iterations (ops/optimal.py)
constexpr int kMaxCluster = 8;  // the portable cluster size
// Dynamic shared memory a block may take for its units (of the 227 KB a
// block may use, the rest left to the reduction's static buffers).
constexpr int kUnitBudget = 224 * 1024;

template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using W = uint32_t;
  static constexpr W kAbs = 0x7fffffffu;
};
template <>
struct Raw<__nv_bfloat16> {
  using W = uint16_t;
  static constexpr W kAbs = 0x7fffu;
};

// Samples a 16-byte unit.
template <typename T>
constexpr int kUnit = 16 / static_cast<int>(sizeof(T));

// The unit's values as float32, in element order.
template <typename T>
__device__ __forceinline__ void unit_floats(uint4 v, float (&a)[kUnit<T>]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      a[i] = __uint_as_float(w[i]);
    } else {
      a[2 * i] = __uint_as_float(w[i] << 16);
      a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The magnitudes of samples j0 .. j0 + kUnit - 1 of a row, sample j being
// element j * skip, as raw T words (sign bits cleared); +0 past the row's
// n elements. Skip > 0 fixes the stride at compile time and, where the row
// is 16-byte aligned (vec) and the unit lies inside it, loads Skip whole
// 16-byte vectors; Skip == 0 takes the stride `skip` and loads elements.
template <typename T, int Skip>
__device__ __forceinline__ uint4 load_unit(const T* __restrict__ xr,
                                           long long j0, long long n,
                                           int skip, bool vec) {
  using W = typename Raw<T>::W;
  constexpr int U = kUnit<T>;
  union {
    uint4 v;
    W w[U];
  } out;
  if constexpr (Skip > 0) {
    const long long e0 = j0 * Skip;
    if (vec && e0 + static_cast<long long>(Skip) * U <= n) {
      union {
        uint4 v[Skip];
        W w[Skip * U];
      } in;
      const uint4* p = reinterpret_cast<const uint4*>(xr + e0);
#pragma unroll
      for (int s = 0; s < Skip; ++s) in.v[s] = __ldg(p + s);
#pragma unroll
      for (int g = 0; g < U; ++g) out.w[g] = in.w[g * Skip] & Raw<T>::kAbs;
      return out.v;
    }
  }
  const int sk = Skip > 0 ? Skip : skip;
  const W* xw = reinterpret_cast<const W*>(xr);
#pragma unroll
  for (int g = 0; g < U; ++g) {
    const long long e = (j0 + g) * sk;
    out.w[g] = e < n ? static_cast<W>(__ldg(xw + e) & Raw<T>::kAbs) : W(0);
  }
  return out.v;
}

// A lane's partial sums: three floats and three counts. In the first
// pass the third float is the running max (MaxF2).
struct Part {
  float f[3];
  int n[3];
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <bool MaxF2>
__device__ __forceinline__ void combine(Part& a, const Part& b) {
  a.f[0] = __fadd_rn(a.f[0], b.f[0]);
  a.f[1] = __fadd_rn(a.f[1], b.f[1]);
  a.f[2] = MaxF2 ? max_nan(a.f[2], b.f[2]) : __fadd_rn(a.f[2], b.f[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) a.n[i] += b.n[i];
}

// One butterfly step: lane i and lane i ^ off both end with the sum of
// the two, the same bits in each (float addition commutes).
template <bool MaxF2>
__device__ __forceinline__ void shuffle_combine(Part& p, int off) {
  Part o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.f[i] = __shfl_xor_sync(0xffffffffu, p.f[i], off);
    o.n[i] = __shfl_xor_sync(0xffffffffu, p.n[i], off);
  }
  combine<MaxF2>(p, o);
}

// The pairwise sum of the cluster's block partials [lo, lo + Span), lower
// ranks first, read from each block's shared memory.
template <int Span, bool MaxF2>
__device__ __forceinline__ Part rank_tree(Part* part,
                                          cg::cluster_group& cluster,
                                          int lo) {
  if constexpr (Span == 1) {
    return *cluster.map_shared_rank(part, lo);
  } else {
    Part a = rank_tree<Span / 2, MaxF2>(part, cluster, lo);
    const Part b = rank_tree<Span / 2, MaxF2>(part, cluster, lo + Span / 2);
    combine<MaxF2>(a, b);
    return a;
  }
}

struct Scratch {
  Part warp[kLanes / 32];
  Part block[2];  // by parity: a slow block may still read the last one
};

// The row's sum of every lane's partial, in the fixed order of the header,
// returned to every thread of the cluster. Every thread of the cluster
// calls it the same number of times.
template <bool MaxF2>
__device__ Part reduce_row(Part p, Scratch& s, int& parity,
                           cg::cluster_group& cluster, int blocks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) shuffle_combine<MaxF2>(p, off);
  if (lane == 0) s.warp[warp] = p;
  __syncthreads();
  if (warp == 0) {
    Part w = s.warp[lane < warps ? lane : 0];
    for (int off = 1; off < warps; off <<= 1) shuffle_combine<MaxF2>(w, off);
    if (lane == 0) s.block[parity] = w;
  }
  Part* mine = &s.block[parity];
  parity ^= 1;
  if (blocks == 1) {
    __syncthreads();
    return *mine;
  }
  cluster.sync();
  switch (blocks) {
    case 2:
      return rank_tree<2, MaxF2>(mine, cluster, 0);
    case 4:
      return rank_tree<4, MaxF2>(mine, cluster, 0);
    default:
      return rank_tree<8, MaxF2>(mine, cluster, 0);
  }
}

// The least-squares cost^2 of threshold v (ops/optimal.py
// `_candidate_costs`), op for op.
__device__ __forceinline__ float candidate_cost(float m, float v, float pc,
                                                float ps, float total,
                                                float total_sq,
                                                bool ternary) {
  const float s_r = __fsub_rn(
      __fadd_rn(__fmul_rn(v, __fsub_rn(__fmul_rn(2.0f, pc), m)), total),
      __fmul_rn(2.0f, ps));
  const float mvv = __fmul_rn(__fmul_rn(m, v), v);
  const float s_r2 =
      __fadd_rn(__fsub_rn(total_sq, __fmul_rn(__fmul_rn(2.0f, v), total)),
                mvv);
  if (ternary)
    return __fadd_rn(__fsub_rn(s_r2, __fmul_rn(__fmul_rn(2.0f, v), s_r)),
                     mvv);
  return __fsub_rn(s_r2, __fdiv_rn(__fmul_rn(s_r, s_r), m));
}

// Grid: a cluster of `blocks` blocks a row, kLanes / blocks threads each.
// OnChip: the block's units in dynamic shared memory, rounds * threads of
// 16 bytes.
template <typename T, int Skip, bool OnChip>
__global__ void __launch_bounds__(kLanes)
    lloyd_solve_rows_kernel(const T* __restrict__ x, long long row_stride,
                            int rows, long long n, int skip, int rounds,
                            int ternary, int want_v2, int vec,
                            float* __restrict__ out) {
  extern __shared__ uint4 units[];
  __shared__ Scratch scratch;
  constexpr int U = kUnit<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / blocks;
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = rank * threads + t;
  const T* xr = x + row * row_stride;
  const int sk = Skip > 0 ? Skip : skip;
  const long long m = (n + sk - 1) / sk;  // samples
  const float mf = static_cast<float>(m);
  int parity = 0;

  auto unit = [&](int k) -> uint4 {
    if constexpr (OnChip) {
      return units[k * threads + t];
    } else {
      return load_unit<T, Skip>(
          xr, (static_cast<long long>(k) * kLanes + lane) * U, n, sk, vec);
    }
  };

  // Read the samples once: keep them, and take sum, sum of squares, max.
  Part p = {};
#pragma unroll 2
  for (int k = 0; k < rounds; ++k) {
    const uint4 w = load_unit<T, Skip>(
        xr, (static_cast<long long>(k) * kLanes + lane) * U, n, sk, vec);
    if constexpr (OnChip) units[k * threads + t] = w;
    float a[U];
    unit_floats<T>(w, a);
#pragma unroll
    for (int g = 0; g < U; ++g) {
      p.f[0] = __fadd_rn(p.f[0], a[g]);
      p.f[1] = __fadd_rn(p.f[1], __fmul_rn(a[g], a[g]));
      p.f[2] = max_nan(p.f[2], a[g]);
    }
  }
  p = reduce_row<true>(p, scratch, parity, cluster, blocks);
  const float total = p.f[0], total_sq = p.f[1];
  const float mean = __fdiv_rn(total, mf);
  const float scale = ternary ? 0.5f : 1.0f;
  float v[3] = {
      __fmul_rn(scale, __fmul_rn(0.5f, mean)), __fmul_rn(scale, mean),
      __fmul_rn(scale, __fmul_rn(0.5f, __fadd_rn(mean, p.f[2])))};

  // Units past the row hold +0, which is never above a threshold (v >= 0
  // or NaN): the iterations need no bound.
  for (int it = 0; it < kIters; ++it) {
    Part q = {};
    for (int k = 0; k < rounds; ++k) {
      float a[U];
      unit_floats<T>(unit(k), a);
#pragma unroll
      for (int g = 0; g < U; ++g) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (a[g] > v[i]) {
            q.f[i] = __fadd_rn(q.f[i], a[g]);
            ++q.n[i];
          }
        }
      }
    }
    q = reduce_row<false>(q, scratch, parity, cluster, blocks);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const long long n2 = q.n[i];
      const float n2f = static_cast<float>(n2);
      const float c2 = __fdiv_rn(q.f[i], fmaxf(n2f, 1.0f));
      if (ternary) {
        if (n2 > 0) v[i] = __fmul_rn(0.5f, c2);
      } else {
        const float c1 = __fdiv_rn(__fsub_rn(total, q.f[i]),
                                   fmaxf(__fsub_rn(mf, n2f), 1.0f));
        if (n2 > 0 && n2 < m) v[i] = __fmul_rn(0.5f, __fadd_rn(c1, c2));
      }
    }
  }

  // The final a <= v split; the pads (+0) fall below every v >= 0 and are
  // taken out of the count again.
  Part q = {};
  for (int k = 0; k < rounds; ++k) {
    float a[U];
    unit_floats<T>(unit(k), a);
#pragma unroll
    for (int g = 0; g < U; ++g) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (a[g] <= v[i]) {
          q.f[i] = __fadd_rn(q.f[i], a[g]);
          ++q.n[i];
        }
      }
    }
  }
  q = reduce_row<false>(q, scratch, parity, cluster, blocks);
  const long long pads = static_cast<long long>(rounds) * kLanes * U - m;
  float cost[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const long long n1 = q.n[i] - (0.0f <= v[i] ? pads : 0);
    cost[i] = candidate_cost(mf, v[i], static_cast<float>(n1), q.f[i], total,
                             total_sq, ternary);
  }
  // torch.argmin: the first minimum, the first NaN before any number.
  float v1 = v[0], best = cost[0];
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    if (!isnan(best) && (isnan(cost[i]) || cost[i] < best)) {
      best = cost[i];
      v1 = v[i];
    }
  }

  float v2 = 0.0f;
  if (want_v2) {
    // mean |x - v1 * sign(x)| over the whole row, sign(0) = +1: lane l
    // takes 16-byte vectors l, l + kLanes, ... in order.
    const long long nv = (n + U - 1) / U;
    Part r = {};
#pragma unroll 4
    for (long long vi = lane; vi < nv; vi += kLanes) {
      const long long e0 = vi * U;
      float a[U];
      if (vec && e0 + U <= n) {
        unit_floats<T>(__ldg(reinterpret_cast<const uint4*>(xr + e0)), a);
      } else {
#pragma unroll
        for (int g = 0; g < U; ++g)
          a[g] = e0 + g < n ? qtt::to_float(xr[e0 + g]) : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < U; ++g) {
        if (e0 + g < n)
          r.f[0] = __fadd_rn(
              r.f[0], fabsf(__fsub_rn(a[g], a[g] < 0.0f ? -v1 : v1)));
      }
    }
    r = reduce_row<false>(r, scratch, parity, cluster, blocks);
    v2 = __fdiv_rn(r.f[0], static_cast<float>(n));
  }
  if (rank == 0 && t == 0) {
    out[row] = v1;
    if (want_v2) out[rows + row] = v2;
  }
  // No block leaves while another may still read its shared memory.
  if (blocks > 1) cluster.sync();
}

struct Layout {
  int blocks;   // cluster size
  int threads;  // a block
  int rounds;   // units a lane
  int smem;     // dynamic shared memory a block, bytes
  bool on_chip;
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// How the rows are split, from R, N, skip and the dtype alone: the fewest
// blocks a row whose units fit in shared memory, then more while the rows
// leave SMs idle and each block keeps 4,096 samples or more.
Layout layout(int rows, long long n, int skip, int unit) {
  const long long m = (n + skip - 1) / skip;
  const long long per_round = static_cast<long long>(kLanes) * unit;
  Layout l;
  l.rounds = static_cast<int>((m + per_round - 1) / per_round);
  auto bytes = [&](int c) {
    return static_cast<long long>(l.rounds) * (kLanes / c) * 16;
  };
  l.blocks = 1;
  while (l.blocks < kMaxCluster && bytes(l.blocks) > kUnitBudget)
    l.blocks *= 2;
  l.on_chip = bytes(l.blocks) <= kUnitBudget;
  const long long sms = sm_count();
  while (l.blocks < kMaxCluster &&
         static_cast<long long>(rows) * l.blocks * 2 <= sms &&
         m >= static_cast<long long>(l.blocks) * 2 * 4096)
    l.blocks *= 2;
  l.threads = kLanes / l.blocks;
  l.smem = l.on_chip ? static_cast<int>(bytes(l.blocks)) : 0;
  return l;
}

template <typename T, int Skip, bool OnChip>
cudaError_t launch_as(const Layout& l, const void* x, long long row_stride,
                      int rows, long long n, int skip, int ternary,
                      int want_v2, float* out, cudaStream_t stream,
                      int* regs, int* blocks_per_sm) {
  auto kernel = lloyd_solve_rows_kernel<T, Skip, OnChip>;
  if (OnChip) {
    static bool raised = false;  // the attribute, once an instance
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kUnitBudget);
      if (e != cudaSuccess) return e;
      raised = true;
    }
  }
  if (regs != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    *regs = attr.numRegs;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, l.threads, l.smem);
  }
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (row_stride * static_cast<long long>(sizeof(T))) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * l.blocks);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = l.blocks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), row_stride, rows, n, skip,
      l.rounds, ternary, want_v2, static_cast<int>(vec), out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int Skip>
cudaError_t by_place(const Layout& l, const void* x, long long row_stride,
                     int rows, long long n, int skip, int ternary,
                     int want_v2, float* out, cudaStream_t stream, int* regs,
                     int* blocks_per_sm) {
  if (l.on_chip)
    return launch_as<T, Skip, true>(l, x, row_stride, rows, n, skip,
                                    ternary, want_v2, out, stream, regs,
                                    blocks_per_sm);
  return launch_as<T, Skip, false>(l, x, row_stride, rows, n, skip, ternary,
                                   want_v2, out, stream, regs,
                                   blocks_per_sm);
}

// The stride a compile-time constant where the quantizers take it (3);
// any other stride loads element by element.
template <typename T>
int solve(const void* x, long long row_stride, int rows, long long n,
          int skip, int ternary, int want_v2, void* out, void* stream,
          int* regs = nullptr, int* blocks_per_sm = nullptr,
          int* info = nullptr) {
  if (rows < 0 || n < 1 || n > INT32_MAX || skip < 1 ||
      (rows > 1 && row_stride < n))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(rows, n, skip, kUnit<T>);
  if (info != nullptr) {
    info[0] = l.blocks;
    info[1] = l.threads;
    info[2] = l.rounds;
    info[3] = l.smem;
    info[4] = l.on_chip;
  }
  if (rows == 0 && regs == nullptr) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  if (skip == 3)
    return static_cast<int>(by_place<T, 3>(l, x, row_stride, rows, n, skip,
                                           ternary, want_v2, o, s, regs,
                                           blocks_per_sm));
  return static_cast<int>(by_place<T, 0>(l, x, row_stride, rows, n, skip,
                                         ternary, want_v2, o, s, regs,
                                         blocks_per_sm));
}

}  // namespace

extern "C" int qtt_lloyd_solve_rows_f32(const void* x, long long row_stride,
                                        int rows, long long n, int skip,
                                        int ternary, int want_v2, void* out,
                                        void* stream) {
  return solve<float>(x, row_stride, rows, n, skip, ternary, want_v2, out,
                      stream);
}

extern "C" int qtt_lloyd_solve_rows_bf16(const void* x, long long row_stride,
                                         int rows, long long n, int skip,
                                         int ternary, int want_v2, void* out,
                                         void* stream) {
  return solve<__nv_bfloat16>(x, row_stride, rows, n, skip, ternary,
                              want_v2, out, stream);
}

// The launch a call of these R, N, skip and dtype makes: info = cluster
// size, threads a block, rounds, dynamic shared memory bytes, on chip (1)
// or streamed (0), registers a thread, blocks an SM.
extern "C" int qtt_lloyd_solve_layout(int bf16, int rows, long long n,
                                      int skip, int* info) {
  int regs = 0, blocks = 0;
  const int e =
      bf16 ? solve<__nv_bfloat16>(nullptr, n, rows, n, skip, 0, 0, nullptr,
                                  nullptr, &regs, &blocks, info)
           : solve<float>(nullptr, n, rows, n, skip, 0, 0, nullptr, nullptr,
                          &regs, &blocks, info);
  info[5] = regs;
  info[6] = blocks;
  return e;
}
