// Helpers shared by the kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element types the kernels read and write; arithmetic is always float.
template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<uint8_t>(uint8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// SiLU with the accurate expf, the same function the plain versions use.
__device__ __forceinline__ float silu_f(float v) { return v / (1.0f + expf(-v)); }

// Dtype codes passed from Python: 0 = float32, 1 = bfloat16, 2 = uint8.
enum { DT_F32 = 0, DT_BF16 = 1, DT_U8 = 2 };
