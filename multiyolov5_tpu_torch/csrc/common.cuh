// Helpers shared by the kernels of this directory.
#pragma once

#include <cuda.h>
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

// Tensor-core, TMA and mbarrier building blocks of the redesigned kernels
// (K1's bf16 and 3xTF32 forms, K2's, K7's), in their own namespace so that
// no kernel file's local helpers of the same name collide with them.
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

// ------------------------------------------------ TMA and mbarriers (K2, K7)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for a stage's copies.  A copy that never completes (a box the
// tensor map does not describe) traps after ~2^22 polls rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned n = 0; !done; ++n) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (n == (1u << 22)) __trap();
  }
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar)) : "memory");
}

// Byte offset of 16-byte chunk j of smem row r under the TMA swizzle of a
// ROW-byte row (ROW = 32, 64 or 128: CU_TENSOR_MAP_SWIZZLE_32B/64B/128B),
// from a 1024-byte aligned base.
template <int ROW>
__device__ __forceinline__ int swz(int r, int j) {
  return r * ROW + ((j ^ ((r * ROW / 128) & (ROW / 16 - 1))) << 4);
}

// The TMA swizzle that spans a row of `row_bytes` (32, 64 or 128).
inline CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace mk
