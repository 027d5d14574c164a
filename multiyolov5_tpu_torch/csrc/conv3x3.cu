// K2: NHWC 3x3 convolution, stride 1 or 2, dilation d with torch autopad
// (pad = d), fused epilogue: fp32 accumulate + bias (+ SiLU).
//
// Replaces the Pallas kernels conv3x3_silu_pallas / _conv_haloed
// (multiyolov5_tpu/ops/pallas/conv3x3_kernel.py:98, :60),
// conv3x3s2_silu_pallas (same file, :153) and conv3x3_packed_pallas
// (multiyolov5_tpu/ops/pallas/c3_kernel.py:270), which all compute this
// function; the q-column packing of the last one fills the TPU's 128-wide
// matrix unit and has no counterpart here.
//
// Design: implicit GEMM, M = B*Ho*Wo output pixels, N = c_out, K = 9*c_in
// ordered (dy, dx, ci).  The weight comes as OHWI (c_out, 3, 3, c_in), so
// each output channel's K row is contiguous.  A block computes a 64x64
// output tile.  Each K step gathers the input tile (64 pixels x a run of
// channels of one tap, zero outside the image) and the weight tile into
// shared memory; c_in % BK == 0 keeps every K step inside one tap.
//   * bfloat16: 4 warps, each a 32x32 sub-tile of mma.sync m16n8k16
//     (bf16 in, fp32 accumulate) on the tensor cores, BK = 32, or BK = 16
//     where c_in is an odd multiple of 16 (SegMaskLab's 48-channel detail
//     conv).  Tiles move by 16-byte cp.async into a 3-stage ring, so two K
//     steps' loads are in flight while one computes.  Needs c_in % 16 == 0
//     and c_out % 8 == 0.
//   * float32: 256 threads, each a 4x4 register micro-tile on the fp32 CUDA
//     cores, BK = 16; no TF32, so it matches a float32 reference closely.
//
// What bounds it on an H100: at the path's shapes (K = 576..2304,
// N = 64..256, M = 512..8192) the bf16 math is small (0.1-1.2 GFLOP a
// site), so load latency per K step and too few blocks on 132 SMs at the
// 1/32-res sites bound it.  TMA with wgmma, and split-K for the small-M
// sites, are later work.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- float32
namespace f32k {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

__global__ void __launch_bounds__(NT)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y,
            int B, int H, int W, int Ci, int Ho, int Wo, int Co,
            int stride, int dil, int act) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int M = B * Ho * Wo;
  const int K = 9 * Ci;

  // The input rows this thread gathers: tile rows ty + 16*i, channel tx.
  int a_base[4], a_iy[4], a_ix[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / (Ho * Wo);
    const int r = mm - b * Ho * Wo;
    a_base[i] = b * H;
    a_iy[i] = (r / Wo) * stride - dil;
    a_ix[i] = (r % Wo) * stride - dil;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int tap = k0 / Ci;
    const int ci = k0 - tap * Ci + tx;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_iy[i] + dy * dil, ix = a_ix[i] + dx * dil;
      float v = 0.f;
      if (a_ok[i] && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = x[((size_t)(a_base[i] + iy) * W + ix) * Ci + ci];
      As[tx][ty + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // weight tile, coalesced along K
      const int n = n0 + ty + 16 * i;
      Bs[tx][ty + 16 * i] = n < Co ? w[(size_t)n * K + k0 + tx] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Co) continue;
      const float v = acc[i][j] + bias[n];
      y[(size_t)m * Co + n] = act ? silu_f(v) : v;
    }
  }
}

}  // namespace f32k

// --------------------------------------------------------------- bfloat16
namespace bf16k {

constexpr int BM = 64, BN = 64, NT = 128;
constexpr int STAGES = 3;    // cp.async ring: two K steps in flight while one computes

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// `valid` is false (src-size 0 reads nothing; `src` must still be mapped).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
}

// BK 32 or 16 channels a K step.  Shared-memory rows are BK + 8 bf16 long
// (80 or 48 bytes): the fragment loads of a warp hit 32 distinct banks.
template <int BK>
__global__ void __launch_bounds__(NT)
conv3x3_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
             int B, int H, int W, int Ci, int Ho, int Wo, int Co,
             int stride, int dil, int act) {
  constexpr int LD = BK + 8;
  constexpr int CPR = BK / 8;              // 16-byte chunks a tile row
  constexpr int NCP = BM * CPR / NT;       // chunks a thread copies a tile
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][LD];   // [pixel][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BN][LD];   // [c_out][k]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int M = B * Ho * Wo;
  const int K = 9 * Ci;
  const int nk = K / BK;

  // 16-byte copies: tile row = idx / CPR, 8-channel chunk = idx % CPR
  int a_base[NCP], a_iy[NCP], a_ix[NCP];
  bool a_ok[NCP];
#pragma unroll
  for (int i = 0; i < NCP; ++i) {
    const int m = m0 + (tid + i * NT) / CPR;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / (Ho * Wo);
    const int r = mm - b * Ho * Wo;
    a_base[i] = b * H;
    a_iy[i] = (r / Wo) * stride - dil;
    a_ix[i] = (r % Wo) * stride - dil;
  }

  auto load_stage = [&](int st, int k0) {
    const int tap = k0 / Ci;
    const int cb = k0 - tap * Ci;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int i = 0; i < NCP; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / CPR, chunk = idx % CPR;
      const int iy = a_iy[i] + dy * dil, ix = a_ix[i] + dx * dil;
      const bool ok = a_ok[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const __nv_bfloat16* src =
          ok ? x + ((size_t)(a_base[i] + iy) * W + ix) * Ci + cb + chunk * 8 : x;
      cp_async16(&As[st][row][chunk * 8], src, ok);
      const int n = n0 + row;
      const __nv_bfloat16* wsrc = n < Co ? w + (size_t)n * K + k0 + chunk * 8 : w;
      cp_async16(&Bs[st][row][chunk * 8], wsrc, n < Co);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_stage();   // step kt has landed (this thread's copies) ...
    __syncthreads();         // ... everyone's, and step kt-1's buffer is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int c = kk + (lane % 4) * 2;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + lane / 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][c]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][c + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nn = wn + nt * 8 + lane / 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[st][nn][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[st][nn][c + 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + lane / 4 + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + (lane % 4) * 2;
        if (n >= Co) continue;
        float v0 = acc[mt][nt][half * 2] + bias[n];
        float v1 = acc[mt][nt][half * 2 + 1] + bias[n + 1];
        if (act) {
          v0 = silu_f(v0);
          v1 = silu_f(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * Co + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace bf16k

}  // namespace

// x: (B, H, W, Ci) NHWC; w: (Co, 3, 3, Ci) OHWI; bias: (Co,) float32;
// y: (B, Ho, Wo, Co) NHWC.  dtype: DT_F32 or DT_BF16 for x, w and y; the
// wrapper checks c_in % 16, and for bfloat16 c_out % 8.
extern "C" int mk_conv3x3(const void* x, const void* w, const float* bias,
                          void* y, int B, int H, int W, int Ci, int Ho, int Wo,
                          int Co, int stride, int dil, int act, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * Ho * Wo;
  if (dtype == DT_BF16) {
    dim3 grid((M + bf16k::BM - 1) / bf16k::BM, (Co + bf16k::BN - 1) / bf16k::BN);
    auto kernel = Ci % 32 == 0 ? &bf16k::conv3x3_bf16<32> : &bf16k::conv3x3_bf16<16>;
    kernel<<<grid, bf16k::NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        bias, static_cast<__nv_bfloat16*>(y), B, H, W, Ci, Ho, Wo, Co, stride,
        dil, act);
  } else {
    dim3 grid((M + f32k::BM - 1) / f32k::BM, (Co + f32k::BN - 1) / f32k::BN);
    f32k::conv3x3_f32<<<grid, f32k::NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(y), B, H, W, Ci, Ho, Wo, Co, stride, dil, act);
  }
  return static_cast<int>(cudaGetLastError());
}
