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
//     The tile has its own shared memory beside the TMA ring: parked on the
//     ring's slots, it was at times read by the other CTAs as the K step's
//     input that the last copy into those slots had brought (float32
//     splits of 8, two CTAs an SM; PERF.md);
//   * the host planner (ops/kernels/conv3x3.py plan()) picks the tile, BK
//     and the split so that the grid reaches at least one CTA an SM;
//   * a CTA owns an 8 x TW (8 or 16) tile of output pixels of one image.  A
//     K step's input is then a box of the NHWC input: BK channels x TW x 8
//     pixels at the tap's offset, traversed with the conv's stride.  One
//     thread issues it, and the step's [BN][BK] weight tile, as two TMA
//     copies (cp.async.bulk.tensor) that complete on the stage's mbarrier;
//     coordinates outside the input zero-fill, which is the conv's padding.
//     A 3-stage ring keeps two steps in flight.  The copies use the
//     32/64/128-byte swizzle of a BK-channel row, and the ldmatrix addresses
//     apply the same XOR, so the eight rows of an ldmatrix fall in eight
//     bank groups.  Two warp groups a CTA, fragments double-buffered in
//     registers across the 32-byte k slices of a row;
//   * bfloat16 (conv3x3_tma): mma.sync m16n8k16, bf16 in, fp32 accumulate,
//     BK 64, 32 or 16;
//   * float32 (conv3x3_tf32): the same skeleton on float32 rows, BK 32
//     (128-byte rows) or 16.  An ldmatrix of float32 rows gives m16n8k8
//     tf32 fragments; each is split in registers into tf32 hi and lo
//     (common.cuh), and each k8 slice takes three products (lo.hi, hi.lo,
//     hi.hi) into a fresh tensor-core accumulator that the float32 sum takes
//     by FADD: the tensor core truncates its sums, and one accumulator over
//     the whole K loop would drift past the float32 reference (K1, K7).
//     Needs c_in % 16 == 0 and c_out % 8 == 0, as bf16 does.
//
// What bounds it on an H100: at the path's shapes (K = 576..2304,
// N = 64..256, M = 512..32768) the work is operations: 0.6 GFLOP a bs1
// site in bf16 (0.6-4.9 us on the tensor cores, 1-3 us of bytes), and 2.4
// GFLOP (19.3 at FFM) a bs4 eval site in float32, three TF32 products a
// MAC (15-117 us at 495 TFLOP/s).  bf16: a launch's fixed cost and the
// chain of dependent K steps of each CTA dominate; float32: the mma.sync
// issue rate and the splits beside it (PERF.md).
#include <cooperative_groups.h>
#include <cuda.h>

#include <map>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

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

// ----------------------------------------------------------- the kernels
namespace tmak {

constexpr int TH = 8;        // output rows a tile
constexpr int NT = 256;      // 8 warps

// T the element type, BK channels a K step, TW output columns a tile, BN
// output channels.
template <typename T, int BK, int TW, int BN>
struct Cfg {
  static constexpr int TM = TH * TW;           // output pixels a tile (64 or 128)
  static constexpr int WMW = TM / 32;          // 8 warps: TM/32 along M ...
  static constexpr int WN = BN / (8 / WMW);    // ... each 32 rows x WN columns
  // bytes a smem row = the swizzle span
  static constexpr int ROW = BK * static_cast<int>(sizeof(T));
  static constexpr int SLICES = ROW / 32;      // mma k slices a step: 16 bf16 or 8 float32
  static constexpr int A_BYTES = TM * ROW, B_BYTES = BN * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDR = BN + 4;
  static constexpr int RED = TM * LDR * 4;
  // the TMA ring (two steps in flight while one computes), then the
  // reduction tile of a split, apart from the ring (see the body)
  static constexpr int STAGES = 3;
  static constexpr int SMEM = 1024 + STAGES * STAGE + RED;
};

using mk::mbar_expect_tx;
using mk::mbar_init;
using mk::mbar_wait;
using mk::swz;
using mk::tma_2d;
using mk::tma_4d;

// The kernel body of both types.  xmap: the input (Ci, W, H, B) with box
// (BK, TW * stride, 8 * stride, 1) traversed with the conv's stride; wmap:
// the weights (9 * Ci, Co) with box (BK, BN).  tiles_y, tiles_x: tiles an
// image.
template <typename T, int BK, int TW, int BN>
__device__ __forceinline__ void conv3x3_body(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                             const float* __restrict__ bias,
                                             T* __restrict__ y, const Geo& g, int tiles_y,
                                             int tiles_x) {
  using C = Cfg<T, BK, TW, BN>;
  constexpr int ROW = C::ROW, WN = C::WN, NT8 = WN / 8;
  constexpr bool TF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int STAGES = C::STAGES;
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
  // wm + mt*16 + lane%16, 16-byte chunk lane/16 of the slice; B, weight row
  // wn + np*16 + (lane/16)*8 + lane%8, chunk (lane/8)%2.  A slice is 32
  // bytes of a row in both types, so the addresses are the same in bytes.
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
    // fragments double-buffered in registers across the k slices
    uint32_t a[2][2][4], bf[2][NT8][2];
    auto load_frags = [&](int buf, int i) {
      const int j = 2 * i;
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
    for (int i = 0; i < C::SLICES; ++i) {
      if (i + 1 < C::SLICES) load_frags((i + 1) & 1, i + 1);
      const int c = i & 1;
      if constexpr (TF32) {
        uint32_t alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mk::tf32_split(a[c][mt], alo[mt]);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          uint32_t bh[4] = {bf[c][2 * np][0], bf[c][2 * np][1], bf[c][2 * np + 1][0],
                            bf[c][2 * np + 1][1]};
          uint32_t bl[4];
          mk::tf32_split(bh, bl);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mk::mma_3xtf32(acc[mt][2 * np], a[c][mt], alo[mt], bh[0], bh[1], bl[0], bl[1]);
            mk::mma_3xtf32(acc[mt][2 * np + 1], a[c][mt], alo[mt], bh[2], bh[3], bl[2],
                           bl[3]);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mk::mma16816(acc[mt][nt], a[c][mt], bf[c][nt][0], bf[c][nt][1]);
      }
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
          if constexpr (TF32)
            *reinterpret_cast<float2*>(y + (size_t)m * g.Co + n) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * g.Co + n) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
    return;
  }
  float* red = reinterpret_cast<float*>(ring + STAGES * C::STAGE);
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
  cluster_reduce_store<T>(red, C::TM, C::LDR, BN, NT, bias, y, row_m, n0, g.Co, g.act);
}

// The two kernels, one a type, so that SASS dumps and profiles name them.
template <int BK, int TW, int BN>
__global__ void __launch_bounds__(NT)
conv3x3_tma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Geo g,
            int tiles_y, int tiles_x) {
  conv3x3_body<__nv_bfloat16, BK, TW, BN>(xmap, wmap, bias, y, g, tiles_y, tiles_x);
}

template <int BK, int TW, int BN>
__global__ void __launch_bounds__(NT)
conv3x3_tf32(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ bias, float* __restrict__ y, Geo g, int tiles_y,
             int tiles_x) {
  conv3x3_body<float, BK, TW, BN>(xmap, wmap, bias, y, g, tiles_y, tiles_x);
}

}  // namespace tmak

template <typename T, int BK, int TW, int BN>
int launch_tma(const void* x, const void* w, const float* bias, void* y, Geo g, int split,
               cudaStream_t s) {
  using C = tmak::Cfg<T, BK, TW, BN>;
  constexpr bool F32 = std::is_same<T, float>::value;
  const auto kernel = [] {
    if constexpr (F32) return &tmak::conv3x3_tf32<BK, TW, BN>;
    else return &tmak::conv3x3_tma<BK, TW, BN>;
  }();
  // The shared-memory cap is set once per kernel and device, at its first
  // launch (outside any CUDA-graph capture that later launches may run
  // under): eval and serving, which launch K2, are host-bound.
  static std::mutex mu;
  static std::map<int, bool> cap_set;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!cap_set[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
      cap_set[dev] = true;
    }
  }
  mk::EncodeTiled encode = mk::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapDataType type =
      F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swizzle = mk::swizzle_of(C::ROW);
  constexpr cuuint64_t ES = sizeof(T);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)g.Ci, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.B};
  const cuuint64_t xstride[3] = {(cuuint64_t)g.Ci * ES, (cuuint64_t)g.W * g.Ci * ES,
                                 (cuuint64_t)g.H * g.W * g.Ci * ES};
  const cuuint32_t xbox[4] = {(cuuint32_t)BK, (cuuint32_t)(TW * g.stride),
                              (cuuint32_t)(tmak::TH * g.stride), 1};
  const cuuint32_t xelem[4] = {1, (cuuint32_t)g.stride, (cuuint32_t)g.stride, 1};
  CUresult r = encode(&xmap, type, 4, const_cast<void*>(x), xdim, xstride, xbox, xelem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdim[2] = {(cuuint64_t)9 * g.Ci, (cuuint64_t)g.Co};
  const cuuint64_t wstride[1] = {(cuuint64_t)9 * g.Ci * ES};
  const cuuint32_t wbox[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint32_t welem[2] = {1, 1};
  r = encode(&wmap, type, 2, const_cast<void*>(w), wdim, wstride, wbox, welem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_y = (g.Ho + tmak::TH - 1) / tmak::TH, tiles_x = (g.Wo + TW - 1) / TW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.B * tiles_y * tiles_x, (g.Co + BN - 1) / BN, split);
  cfg.blockDim = dim3(tmak::NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;     // no cluster without a split
  e = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, bias, static_cast<T*>(y), g, tiles_y,
                         tiles_x);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, Ci) NHWC; w (Co, 3, 3, Ci) OHWI, both float32 or both
// bfloat16; bias (Co,) float32; y (B, Ho, Wo, Co) NHWC in x's type; the
// plan's tile (bm = 8 x TW output pixels), bn, bk and split.  The plan
// comes from ops/kernels/conv3x3.py plan(), which checks c_in % 16 == 0
// and c_out % 8 == 0; a plan this file has no kernel for returns
// cudaErrorInvalidValue.
extern "C" int mk_conv3x3(const void* x, const void* w, const float* bias, void* y,
                          int B, int H, int W, int Ci, int Ho, int Wo, int Co,
                          int stride, int dil, int act, int dtype, int bm, int bn, int bk,
                          int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, H, W, Ci, Ho, Wo, Co, stride, dil, act};
  if (split < 1 || split > 8) return static_cast<int>(cudaErrorInvalidValue);
#define MK_TMA(T, BK, TM, BN)                                  \
  if (bk == BK && bm == TM && bn == BN)                        \
    return launch_tma<T, BK, TM / tmak::TH, BN>(x, w, bias, y, g, split, s);
  if (dtype == DT_BF16) {
    MK_TMA(__nv_bfloat16, 64, 64, 64) MK_TMA(__nv_bfloat16, 64, 128, 64)
    MK_TMA(__nv_bfloat16, 64, 64, 128) MK_TMA(__nv_bfloat16, 64, 128, 128)
    MK_TMA(__nv_bfloat16, 32, 64, 64) MK_TMA(__nv_bfloat16, 32, 128, 64)
    MK_TMA(__nv_bfloat16, 32, 64, 128) MK_TMA(__nv_bfloat16, 32, 128, 128)
    MK_TMA(__nv_bfloat16, 16, 64, 64) MK_TMA(__nv_bfloat16, 16, 128, 64)
    MK_TMA(__nv_bfloat16, 16, 64, 128) MK_TMA(__nv_bfloat16, 16, 128, 128)
  } else if (dtype == DT_F32) {
    MK_TMA(float, 32, 64, 64) MK_TMA(float, 32, 128, 64) MK_TMA(float, 32, 64, 128)
    MK_TMA(float, 16, 64, 64) MK_TMA(float, 16, 128, 64) MK_TMA(float, 16, 64, 128)
  }
#undef MK_TMA
  return static_cast<int>(cudaErrorInvalidValue);
}
