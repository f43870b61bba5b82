// Shared helpers for the hand-written Hopper kernels of multimeditron_torch.
//
// Every kernel is templated on its storage type (float or __nv_bfloat16) and
// computes in float. The C entry points take a dtype code (0 = float32,
// 1 = bfloat16), launch on the caller's stream and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mmt {

constexpr int kWarpSize = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __device__ __forceinline__ int clamp_int(long long x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : static_cast<int>(x));
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

}  // namespace mmt

// Runs the statement with `scalar_t` bound to the storage type named by `dtype`;
// an unknown code returns cudaErrorInvalidValue from the enclosing function.
#define MMT_DISPATCH_DTYPE(dtype, ...)               \
  do {                                               \
    if ((dtype) == 0) {                              \
      using scalar_t = float;                        \
      __VA_ARGS__;                                   \
    } else if ((dtype) == 1) {                       \
      using scalar_t = __nv_bfloat16;                \
      __VA_ARGS__;                                   \
    } else {                                         \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                                \
  } while (0)
