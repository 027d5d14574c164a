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
// Design: implicit GEMM, M = output pixels, N = c_out, K = 9*c_in ordered
// (dy, dx, ci).  The weight comes as OHWI (c_out, 3, 3, c_in), so each
// output channel's K row is contiguous.  A CTA computes a tile of output
// pixels x BN channels over a slice of the K steps; c_in % BK == 0 keeps
// every K step inside one tap.
//
// At the neck's 1/16 and 1/32 sites (M 512 and 2048) 64x64 tiles alone give
// 32-64 CTAs for 132 SMs, each walking 36-72 dependent K steps, and a K step
// that gathers its input with 16-byte copies waits on them.  This kernel:
//   * splits K across the CTAs of a thread-block cluster (grid z = cluster
//     z = split, 1-8).  Each CTA accumulates its slice of the K steps in
//     registers, parks the fp32 partial tile in its shared memory, and after
//     a cluster barrier every CTA sums one share of the tile over the
//     cluster's shared memories (distributed shared memory) and writes it
//     with the fused epilogue.  No second pass, no atomics, no workspace.
//     The host planner (ops/kernels/conv3x3.py plan()) picks the tile, BK
//     and the split so that the grid reaches at least one CTA an SM;
//   * bfloat16: a CTA owns an 8 x TW (8 or 16) tile of output pixels of
//     one image.  A K step's input is then a box of the NHWC input: BK
//     channels x TW x 8 pixels at the tap's offset, traversed with the
//     conv's stride.  One thread issues it, and the step's [BN][BK] weight
//     tile, as two TMA copies (cp.async.bulk.tensor) that complete on the
//     stage's mbarrier; coordinates outside the input zero-fill, which is
//     the conv's padding.  A 4-stage ring keeps three steps in flight.  The
//     copies use the 32/64/128-byte swizzle of a BK-channel row, and the
//     ldmatrix addresses apply the same XOR, so the eight rows of an
//     ldmatrix fall in eight bank groups.  mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), two warp groups a CTA, fragments double-buffered in
//     registers across the 16-wide k slices.  Needs c_in % 16 == 0 and
//     c_out % 8 == 0;
//   * float32: the same planner and cluster split over 64 consecutive
//     output pixels; 256 threads, each a 4x4 register micro-tile on the
//     fp32 CUDA cores, BK 16, no TF32, so it matches a float32 reference
//     closely.
//
// What bounds it on an H100: at the path's shapes (K = 576..2304,
// N = 64..256, M = 512..8192) the bf16 work is 0.6 GFLOP a site (4.8 at
// FFM): 0.6-4.9 us on the tensor cores, 1-3 us of bytes.  A launch's fixed
// cost and the chain of dependent K steps of each CTA dominate (PERF.md).
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;

// The conv's geometry: input (B, H, W, Ci), output (B, Ho, Wo, Co).
struct Geo {
  int B, H, W, Ci, Ho, Wo, Co, stride, dil, act;
};

// After the main loop: the CTA's fp32 partial tile `red` (bm x ldr, first
// `bn` columns used) is in its shared memory.  Every CTA of the cluster sums
// its share of the tile over all ranks' `red`, adds the bias, applies SiLU
// and stores; `row_m(row)` gives the output pixel of a tile row (-1 for
// none).  Called by every thread of every CTA of the cluster.
template <typename T, typename RowM>
__device__ void cluster_reduce_store(float* red, int bm, int ldr, int bn, int nt,
                                     const float* __restrict__ bias,
                                     T* __restrict__ y, RowM row_m, int n0, int Co,
                                     int act) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();                       // every rank's partial tile is in place
  const int g4 = bn / 4;
  for (int gi = rank * nt + static_cast<int>(threadIdx.x); gi < bm * g4; gi += S * nt) {
    const int row = gi / g4, c = (gi % g4) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < S; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + row * ldr + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const int m = row_m(row), n = n0 + c;
    if (m < 0) continue;
    float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n + e < Co) {
        const float t = v[e] + bias[n + e];
        y[(size_t)m * Co + n + e] = from_f<T>(act ? silu_f(t) : t);
      }
    }
  }
  cluster.sync();                       // no CTA leaves while others read its tile
}

// ---------------------------------------------------------------- float32
namespace f32k {

constexpr int BN = 64, BK = 16, NT = 256;
constexpr int LDA = BM + 4, LDB = BN + 1, LDR = BN + 4;
constexpr int SMEM = BM * LDR * 4;      // the reduction tile; the K tiles fit inside

__global__ void __launch_bounds__(NT)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y, Geo g) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                     // [BK][LDA]
  float* Bs = smem + BK * LDA;          // [BK][LDB]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int M = g.B * g.Ho * g.Wo;
  const int K = 9 * g.Ci;
  const int nk = K / BK;
  const int kb = blockIdx.z * nk / gridDim.z, ke = (blockIdx.z + 1) * nk / gridDim.z;

  // The input rows this thread gathers: tile rows ty + 16*i, channel tx.
  int a_base[4], a_iy[4], a_ix[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / (g.Ho * g.Wo);
    const int r = mm - b * g.Ho * g.Wo;
    a_base[i] = b * g.H;
    a_iy[i] = (r / g.Wo) * g.stride - g.dil;
    a_ix[i] = (r % g.Wo) * g.stride - g.dil;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = kb; kt < ke; ++kt) {
    const int k0 = kt * BK;
    const int tap = k0 / g.Ci;
    const int ci = k0 - tap * g.Ci + tx;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_iy[i] + dy * g.dil, ix = a_ix[i] + dx * g.dil;
      float v = 0.f;
      if (a_ok[i] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        v = x[((size_t)(a_base[i] + iy) * g.W + ix) * g.Ci + ci];
      As[tx * LDA + ty + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // weight tile, coalesced along K
      const int n = n0 + ty + 16 * i;
      Bs[tx * LDB + ty + 16 * i] = n < g.Co ? w[(size_t)n * K + k0 + tx] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= g.Co) continue;
        const float v = acc[i][j] + bias[n];
        y[(size_t)m * g.Co + n] = g.act ? silu_f(v) : v;
      }
    }
    return;
  }
  float* red = smem;                    // the K tiles are dead (synced above)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ty + 16 * i) * LDR + tx + 16 * j] = acc[i][j];
  cluster_reduce_store<float>(red, BM, LDR, BN, NT, bias, y,
                              [&](int row) { return m0 + row < M ? m0 + row : -1; }, n0,
                              g.Co, g.act);
}

}  // namespace f32k

// --------------------------------------------------------------- bfloat16
namespace tmak {

constexpr int TH = 8;        // output rows a tile
constexpr int NT = 256;      // 8 warps
constexpr int STAGES = 4;    // TMA ring: three steps in flight while one computes

// BK channels a K step, TW output columns a tile, BN output channels.
template <int BK, int TW, int BN>
struct Cfg {
  static constexpr int TM = TH * TW;           // output pixels a tile (64 or 128)
  static constexpr int WMW = TM / 32;          // 8 warps: TM/32 along M ...
  static constexpr int WN = BN / (8 / WMW);    // ... each 32 rows x WN columns
  static constexpr int ROW = BK * 2;           // bytes a smem row = the swizzle span
  static constexpr int A_BYTES = TM * ROW, B_BYTES = BN * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDR = BN + 4;
  static constexpr int RED = TM * LDR * 4;
  static constexpr int SMEM = 1024 + (STAGES * STAGE > RED ? STAGES * STAGE : RED);
};

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
// ROW-byte row (ROW = 32, 64 or 128: CU_TENSOR_MAP_SWIZZLE_32B/64B/128B).
template <int ROW>
__device__ __forceinline__ int swz(int r, int j) {
  return r * ROW + ((j ^ ((r * ROW / 128) & (ROW / 16 - 1))) << 4);
}

// xmap: the input (Ci, W, H, B) with box (BK, TW * stride, 8 * stride, 1)
// traversed with the conv's stride; wmap: the weights (9 * Ci, Co) with
// box (BK, BN).  tiles_y, tiles_x: tiles an image.
template <int BK, int TW, int BN>
__global__ void __launch_bounds__(NT)
conv3x3_tma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Geo g,
            int tiles_y, int tiles_x) {
  using C = Cfg<BK, TW, BN>;
  constexpr int ROW = C::ROW, WN = C::WN, NT8 = WN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = blockIdx.x % tiles_x, rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y, b = rest / tiles_y;
  const int oy0 = ty * TH, ox0 = tx * TW;
  const int n0 = blockIdx.y * BN;
  const int nk = 9 * g.Ci / BK;
  const int kb = blockIdx.z * nk / gridDim.z, ke = (blockIdx.z + 1) * nk / gridDim.z;
  const int steps = ke - kb;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // one thread issues a step's two copies into its ring slot
  auto issue = [&](int step) {
    const int slot = step % STAGES;
    const int k0 = (kb + step) * BK;
    const int tap = k0 / g.Ci, cb = k0 - tap * g.Ci;
    unsigned char* st = ring + slot * C::STAGE;
    mbar_expect_tx(&full[slot], C::STAGE);
    tma_4d(st, &xmap, cb, ox0 * g.stride + ((tap % 3) - 1) * g.dil,
           oy0 * g.stride + ((tap / 3) - 1) * g.dil, b, &full[slot]);
    tma_2d(st + C::A_BYTES, &wmap, k0, n0, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES && s < steps; ++s) issue(s);
  }

  // warp tile: 32 output pixels x WN channels; ldmatrix rows: A, tile row
  // wm + mt*16 + lane%16, k half lane/16; B, weight row wn + np*16 +
  // (lane/16)*8 + lane%8, k half (lane/8)%2
  const int wm = (warp / (BN / WN)) * 32, wn = (warp % (BN / WN)) * WN;
  const int a_row = wm + lane % 16, a_half = lane / 16;
  const int b_row = wn + (lane / 16) * 8 + lane % 8, b_half = (lane / 8) % 2;

  float acc[2][NT8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int slot = step % STAGES;
    mbar_wait(&full[slot], (step / STAGES) & 1);
    const unsigned char* as = ring + slot * C::STAGE;
    const unsigned char* bs = as + C::A_BYTES;
    // fragments double-buffered in registers across the 16-wide k slices
    uint32_t a[2][2][4], bf[2][NT8][2];
    auto load_frags = [&](int buf, int kk) {
      const int j = kk / 8;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mk::ldsm_x4(a[buf][mt], as + swz<ROW>(a_row + mt * 16, j + a_half));
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t r[4];
        mk::ldsm_x4(r, bs + swz<ROW>(b_row + np * 16, j + b_half));
        bf[buf][2 * np][0] = r[0];
        bf[buf][2 * np][1] = r[1];
        bf[buf][2 * np + 1][0] = r[2];
        bf[buf][2 * np + 1][1] = r[3];
      }
    };
    load_frags(0, 0);
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      if (i + 1 < BK / 16) load_frags((i + 1) & 1, (i + 1) * 16);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mk::mma16816(acc[mt][nt], a[i & 1][mt], bf[i & 1][nt][0], bf[i & 1][nt][1]);
    }
    __syncthreads();                   // every warp is done with this slot
    if (tid == 0 && step + STAGES < steps) issue(step + STAGES);
  }

  auto row_m = [&](int o) {
    const int oy = oy0 + o / TW, ox = ox0 + o % TW;
    return oy < g.Ho && ox < g.Wo ? (b * g.Ho + oy) * g.Wo + ox : -1;
  };
  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = row_m(wm + mt * 16 + lane / 4 + half * 8);
        if (m < 0) continue;
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const int n = n0 + wn + nt * 8 + (lane % 4) * 2;
          if (n >= g.Co) continue;
          float v0 = acc[mt][nt][half * 2] + bias[n];
          float v1 = acc[mt][nt][half * 2 + 1] + bias[n + 1];
          if (g.act) {
            v0 = silu_f(v0);
            v1 = silu_f(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * g.Co + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    return;
  }
  float* red = reinterpret_cast<float*>(ring);   // the ring is dead (synced above)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const int r = wm + mt * 16 + lane / 4 + half * 8;
        const int c = wn + nt * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(red + r * C::LDR + c) =
            make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
      }
  cluster_reduce_store<__nv_bfloat16>(red, C::TM, C::LDR, BN, NT, bias, y, row_m, n0,
                                      g.Co, g.act);
}

}  // namespace tmak

template <typename KernelT, typename... Args>
int launch(KernelT kernel, dim3 grid, int nt, int smem, int split, cudaStream_t s,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;     // no cluster without a split
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
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

template <int BK, int TW, int BN>
int launch_tma(const void* x, const void* w, const float* bias, void* y, Geo g, int split,
               cudaStream_t s) {
  using C = tmak::Cfg<BK, TW, BN>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapSwizzle swizzle = BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : BK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)g.Ci, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.B};
  const cuuint64_t xstride[3] = {(cuuint64_t)g.Ci * 2, (cuuint64_t)g.W * g.Ci * 2,
                                 (cuuint64_t)g.H * g.W * g.Ci * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)BK, (cuuint32_t)(TW * g.stride),
                              (cuuint32_t)(tmak::TH * g.stride), 1};
  const cuuint32_t xelem[4] = {1, (cuuint32_t)g.stride, (cuuint32_t)g.stride, 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim,
                      xstride, xbox, xelem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdim[2] = {(cuuint64_t)9 * g.Ci, (cuuint64_t)g.Co};
  const cuuint64_t wstride[1] = {(cuuint64_t)9 * g.Ci * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint32_t welem[2] = {1, 1};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride,
             wbox, welem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_y = (g.Ho + tmak::TH - 1) / tmak::TH, tiles_x = (g.Wo + TW - 1) / TW;
  dim3 grid(g.B * tiles_y * tiles_x, (g.Co + BN - 1) / BN, split);
  return launch(&tmak::conv3x3_tma<BK, TW, BN>, grid, tmak::NT, C::SMEM, split, s, xmap, wmap,
                bias, static_cast<__nv_bfloat16*>(y), g, tiles_y, tiles_x);
}

}  // namespace

// float32: x (B, H, W, Ci) NHWC; w (Co, 3, 3, Ci) OHWI; bias (Co,);
// y (B, Ho, Wo, Co) NHWC; the plan's split.  bfloat16: the same arrays in
// bf16 (bias float32) and the plan's tile (bm = 8 x TW output pixels), bn
// and bk.  The plan comes from ops/kernels/conv3x3.py plan(), which checks
// c_in % 16 == 0 and, for bfloat16, c_out % 8 == 0; a plan this file has no
// kernel for returns cudaErrorInvalidValue.
extern "C" int mk_conv3x3(const void* x, const void* w, const float* bias, void* y,
                          int B, int H, int W, int Ci, int Ho, int Wo, int Co,
                          int stride, int dil, int act, int dtype, int bm, int bn, int bk,
                          int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, H, W, Ci, Ho, Wo, Co, stride, dil, act};
  if (split < 1 || split > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_BF16) {
#define MK_TMA(BK, TM, BN)                                     \
  if (bk == BK && bm == TM && bn == BN)                        \
    return launch_tma<BK, TM / tmak::TH, BN>(x, w, bias, y, g, split, s);
    MK_TMA(64, 64, 64) MK_TMA(64, 128, 64) MK_TMA(64, 64, 128) MK_TMA(64, 128, 128)
    MK_TMA(32, 64, 64) MK_TMA(32, 128, 64) MK_TMA(32, 64, 128) MK_TMA(32, 128, 128)
    MK_TMA(16, 64, 64) MK_TMA(16, 128, 64) MK_TMA(16, 64, 128) MK_TMA(16, 128, 128)
#undef MK_TMA
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bm != BM || bn != f32k::BN || bk != f32k::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * Ho * Wo;
  dim3 grid((M + BM - 1) / BM, (Co + f32k::BN - 1) / f32k::BN, split);
  return launch(&f32k::conv3x3_f32, grid, f32k::NT, f32k::SMEM, split, s,
                static_cast<const float*>(x), static_cast<const float*>(w), bias,
                static_cast<float*>(y), g);
}
