// Shared helpers for the quant_tpu_torch kernels (plain C interface,
// built by quant_tpu_torch/_build.py with nvcc for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtt {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long total, int threads = kThreads) {
  return static_cast<unsigned>((total + threads - 1) / threads);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to T's precision and back (exact for T = float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

}  // namespace qtt

extern "C" const char* qtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
