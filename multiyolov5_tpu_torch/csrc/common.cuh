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

// Tensor-core building blocks of the redesigned kernels (K1's bf16 and
// 3xTF32 forms, K2's, K7's), in their own namespace so that no kernel file's local
// helpers of the same name collide with them.
namespace mk {

// mma.sync m16n8k16, bf16 in, fp32 accumulate: c += a * b.  Not volatile:
// it touches no memory, so the compiler may schedule it between loads.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync m16n8k8, tf32 in, fp32 accumulate: c += a * b.  The fragments
// are float32 bit patterns whose low 13 mantissa bits the tensor core
// ignores: make them zero (tf32_rna) unless the value is exact in tf32.
__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A float32 rounded to tf32, to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Split float32 fragments in place into tf32 hi (in a) and lo parts:
// x = hi + lo + O(2^-22 |x|).
__device__ __forceinline__ void tf32_split(uint32_t (&a)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float x = __uint_as_float(a[q]);
    a[q] = tf32_rna(x);
    lo[q] = tf32_rna(x - __uint_as_float(a[q]));
  }
}

// acc += a * b on one n8 tile in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi
// b_hi, the large term last, in a fresh tensor-core accumulator (it
// truncates its sums toward zero) that acc takes by FADD.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&a)[4],
                                           const uint32_t (&alo)[4], uint32_t b0, uint32_t b1,
                                           uint32_t l0, uint32_t l1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma1688_tf32(t, alo, b0, b1);
  mma1688_tf32(t, a, l0, l1);
  mma1688_tf32(t, a, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += t[q];
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the row address
// of matrix l / 8.  On float32 rows each matrix is 8 rows of 4 floats, and
// lane l receives the float at (row l / 4, column l % 4): a tf32 fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

}  // namespace mk
