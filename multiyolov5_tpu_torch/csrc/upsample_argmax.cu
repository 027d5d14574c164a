// K4: uint8 class map argmax_c(MH . x_c . MW^T) from 1/8-res planar logits.
//
// Replaces upsample_argmax_planar / _upsample_argmax_planar_tpu
// (multiyolov5_tpu/ops/pallas/upsample_argmax_kernel.py:309, :221).  MH and
// MW compose the seg head's x8 align-corners upsample with the resize to
// the frame, in float64 on the host (_compose_matrix, :40), rounded to
// float32.  Each row of a composed bilinear matrix is a short band, so the
// host passes it as (first column, `taps` weights) per output row/column.
//
// The argmax is exact float32, first maximum winning (the smaller class
// id, as torch.argmax): the TPU kernel's quantized packed key and +64
// offset (upsample_argmax_kernel.py:66-90, :160-169), with their ~2.4e-4
// tie band, have no counterpart here.  The full-res logits are never
// written.
//
// What bounds it on an H100: the separable work, C x (2 tw h W0 + 2 th H0
// W0 + H0 W0) float32 operations, 0.0044 ms at bs1's 19 x 64 x 128 ->
// 1024 x 2048 on the CUDA cores; the 2 MB of uint8 writes take 0.0006 ms.
// The first form gave each output pixel a thread that read its
// whole th x tw window of every class from global memory: ~16 output
// pixels in each direction share an input cell, so nearly every load
// repeated a neighbour's, and it was bound by load instructions (0.132 ms).
// This form issues ~8.5 instructions a (pixel, class): the column sum's 4
// FMAs, the row sum's 12 FMAs and loads over a run of 16, and the running
// argmax's compare and two selects, which keep the ALU pipe busiest.
//
// Design.  A CTA owns a tile of `tr` output rows x `tc` output columns of
// one image (ops/kernels/upsample_argmax.py `plan`); a thread owns a run of
// RUN adjacent output columns, which share SPAN input columns, in one tile
// row a pass, and the CTA walks its rows in passes.  Per chunk of `cb`
// classes:
//   1. the CTA stages the chunk's input window (`wr` rows x `wx` columns
//      from the tile's first row and column taps, zero past the image) into
//      shared memory once, as float32, eight loads in flight a thread;
//   2. per class, in order, a thread forms the row sums of its run's SPAN
//      window columns, t = sum_a wr[a] x[r0 + a][col], then each pixel's
//      value as sum_q wd[p][q] t[q], the run's column weights spread
//      densely over SPAN (zero outside the pixel's band: fmaf by a zero
//      weight leaves the sum as it is), and keeps a running (max, class)
//      per pixel in registers across the chunks.
// The column weights come from a host table laid out so that neighbouring
// threads read neighbouring runs, and serve all of a thread's passes; with
// all classes in one chunk the window is staged once for every pass.  The
// run's bytes go out as one RUN-byte store.  The kernel is held to two
// CTAs an SM (128 registers a thread); unbounded, a run of 16 took ~150 and
// one CTA an SM, 30% slower.  A separate row pass into shared memory
// (one barrier more, its latency not hidden) cost more than the 12 row
// FMAs a thread repeats.  Every pixel's arithmetic is the same fmaf chain
// whatever the tile, run, pass or chunk (rows in tap order from 0, then
// columns in band order from 0), so the class map is bitwise the same under
// every plan and from run to run.  Float32 throughout: TF32 tensor cores
// would move the argmax.
#include <mutex>

#include "common.cuh"

namespace {

constexpr int MAXT = 8;                    // taps a band may have
constexpr int MAX_THREADS = 256;
constexpr int SMEM_MAX = 227 * 1024;

// Per-launch geometry: the logits (C, h, w), the frame (H0, W0), the taps,
// the tile (tr x tc), the class chunk and the staged window (wr x wx).
struct Geo {
  int C, h, w, H0, W0, th, tw, tr, tc, cb, wr, wx;
};

// Dynamic shared memory of a CTA: the tile rows' first input rows (ints)
// and weights and the staged window, in 4-byte words.
size_t smem_bytes(int tr, int th, int cb, int wr, int wx) {
  return 4 * ((size_t)tr * (1 + th) + (size_t)cb * wr * wx);
}

template <int RUN>
__device__ __forceinline__ void store_run(uint8_t* dst, const int (&arg)[RUN], int n,
                                          bool vec) {
  if (vec) {
    uint32_t word[(RUN + 3) / 4];
#pragma unroll
    for (int k = 0; k < (RUN + 3) / 4; ++k) {
      word[k] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * k + b < RUN) word[k] |= static_cast<uint32_t>(arg[4 * k + b]) << (8 * b);
    }
    if constexpr (RUN == 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
    } else if constexpr (RUN == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
    } else if constexpr (RUN == 4) {
      *reinterpret_cast<uint32_t*>(dst) = word[0];
    } else {
#pragma unroll
      for (int p = 0; p < RUN; ++p) dst[p] = static_cast<uint8_t>(arg[p]);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < RUN; ++p)
    if (p < n) dst[p] = static_cast<uint8_t>(arg[p]);
}

template <typename T, int RUN, int SPAN>
__global__ void __launch_bounds__(MAX_THREADS, 2)
upsample_argmax_kernel(const T* __restrict__ x, const int* __restrict__ hlo,
                       const float* __restrict__ hw, const int* __restrict__ wlo,
                       const float* __restrict__ wdt, Geo g, uint8_t* __restrict__ out) {
  extern __shared__ float sm[];
  int* s_lo = reinterpret_cast<int*>(sm);   // [tr] each tile row's first input row - r0
  float* s_wr = sm + g.tr;                  // [tr][th] its row weights
  float* xs = s_wr + g.tr * g.th;           // [cb][wr][wx] the staged window
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int b = blockIdx.z;
  const int oh0 = blockIdx.y * g.tr, ow0 = blockIdx.x * g.tc;
  const int r0 = hlo[oh0], c0 = wlo[ow0];
  for (int i = tid; i < g.tr; i += nt) {
    const bool in = oh0 + i < g.H0;
    s_lo[i] = in ? hlo[oh0 + i] - r0 : 0;
    for (int a = 0; a < g.th; ++a) s_wr[i * g.th + a] = in ? hw[(oh0 + i) * g.th + a] : 0.f;
  }

  // this thread's run: output columns ow .. ow + RUN - 1 of tile rows r,
  // r + rows, r + 2 rows, ... (one a pass); its column weights serve every pass
  const int runs = g.tc / RUN;
  const int rows = nt / runs;                // tile rows a pass
  const int r_first = tid / runs;
  const int ow = ow0 + (tid - r_first * runs) * RUN;
  const bool col_live = ow < g.W0;
  const int nrun = min(RUN, g.W0 - ow);
  const int base = col_live ? wlo[ow] - c0 : 0;  // the run's first input column in the window
  // the run's dense column weights, from the host's table [RUN][SPAN][runs]:
  // neighbouring threads read neighbouring runs
  const int runs_all = (g.W0 + RUN - 1) / RUN;
  float wd[RUN][SPAN];
#pragma unroll
  for (int p = 0; p < RUN; ++p)
#pragma unroll
    for (int q = 0; q < SPAN; ++q)
      wd[p][q] = col_live ? wdt[(size_t)(p * SPAN + q) * runs_all + ow / RUN] : 0.f;

  const size_t plane = (size_t)g.h * g.w;
  const T* xb = x + (size_t)b * g.C * plane;
  const bool one_chunk = g.cb >= g.C;        // staged once for every pass
  for (int pass = 0, r = r_first; pass < g.tr / rows; ++pass, r += rows) {
    const bool live = col_live && oh0 + r < g.H0;
    // class 0 wins unless a later class is strictly greater (logits are finite)
    float best[RUN];
    int arg[RUN];
#pragma unroll
    for (int p = 0; p < RUN; ++p) {
      best[p] = __int_as_float(0xff800000);   // -inf
      arg[p] = 0;
    }
    for (int cs = 0; cs < g.C; cs += g.cb) {
      const int nc = min(g.cb, g.C - cs);
      if (pass == 0 || !one_chunk) {
        __syncthreads();                     // the tables are in; the last chunk is read
        // 1. stage: a warp a (class, window row) of the chunk, its lanes
        //    along the columns, eight rows' loads in flight
        const int items = nc * g.wr;
        for (int q = lane; q < g.wx; q += 32) {
          const int ix = c0 + q;
          for (int k0 = warp; k0 < items; k0 += 8 * nwarps) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int k = k0 + u * nwarps;
              const int cc = k / g.wr, iy = r0 + k - cc * g.wr;
              v[u] = k < items && iy < g.h && ix < g.w
                         ? to_f(xb[(size_t)(cs + cc) * plane + (size_t)iy * g.w + ix])
                         : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (k0 + u * nwarps < items) xs[(size_t)(k0 + u * nwarps) * g.wx + q] = v[u];
          }
        }
        __syncthreads();
      }
      // 2. per class, in order: the row pass at the run's SPAN window
      //    columns (t = sum_a wr[a] x[r0 + a][col]), then each pixel's column
      //    sum and its running argmax
      if (live) {
        float wrow[MAXT];
#pragma unroll
        for (int a = 0; a < MAXT; ++a) wrow[a] = a < g.th ? s_wr[r * g.th + a] : 0.f;
        const float* xc = xs + (size_t)s_lo[r] * g.wx + base;
#pragma unroll 2
        for (int cc = 0; cc < nc; ++cc, xc += g.wr * g.wx) {
          float tv[SPAN];
#pragma unroll
          for (int q = 0; q < SPAN; ++q) tv[q] = 0.f;
#pragma unroll
          for (int a = 0; a < MAXT; ++a) {
            if (a >= g.th) break;
#pragma unroll
            for (int q = 0; q < SPAN; ++q) tv[q] = fmaf(wrow[a], xc[a * g.wx + q], tv[q]);
          }
          const int c = cs + cc;
#pragma unroll
          for (int p = 0; p < RUN; ++p) {
            float v = 0.f;
#pragma unroll
            for (int q = 0; q < SPAN; ++q) v = fmaf(wd[p][q], tv[q], v);
            const bool up = v > best[p];     // selects, not a branch a pixel
            best[p] = up ? v : best[p];
            arg[p] = up ? c : arg[p];
          }
        }
      }
    }
    if (live) {
      uint8_t* dst = out + ((size_t)b * g.H0 + oh0 + r) * g.W0 + ow;
      store_run<RUN>(dst, arg, nrun, g.W0 % RUN == 0);
    }
  }
}

template <typename T, int RUN, int SPAN>
cudaError_t launch(const void* x, int B, const int* hlo, const float* hw, const int* wlo,
                   const float* wdt, const Geo& g, uint8_t* out, int threads, int smem,
                   cudaStream_t s) {
  auto kernel = upsample_argmax_kernel<T, RUN, SPAN>;
  // the shared-memory cap is set once per instantiation, at its first launch
  static std::mutex mu;
  static bool attr_set = false;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!attr_set) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
  }
  const dim3 grid((g.W0 + g.tc - 1) / g.tc, (g.H0 + g.tr - 1) / g.tr, B);
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(x), hlo, hw, wlo, wdt, g, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int run, int span, const void* x, int B, const int* hlo, const float* hw,
                     const int* wlo, const float* wdt, const Geo& g, uint8_t* out, int threads,
                     int smem, cudaStream_t s) {
#define MK_K4(R, S)                                                                  \
  if (run == R && span == S)                                                         \
    return launch<T, R, S>(x, B, hlo, hw, wlo, wdt, g, out, threads, smem, s);
  MK_K4(16, 4)
  MK_K4(8, 4)
  MK_K4(8, 8)
  MK_K4(4, 8)
  MK_K4(1, 8)
#undef MK_K4
  return cudaErrorInvalidValue;
}

}  // namespace

// The dynamic shared memory of a CTA under a plan: ops/kernels/
// upsample_argmax.py `smem_bytes`.
extern "C" int mk_upsample_argmax_smem_bytes(int tr, int th, int cb, int wr, int wx) {
  return static_cast<int>(smem_bytes(tr, th, cb, wr, wx));
}

// x: (B, C, h, w) planar logits in `dtype`; hlo/hw: per output row the first
// input row and `th` float32 weights; wlo: per output column the first input
// column (of `tw` taps); wdt: the column weights spread densely over each
// run's `span` input columns from its first column's first tap, as
// [run][span][ceil(W0 / run)] float32 (ops/kernels/upsample_argmax.py
// `dense_weights`); out: (B, H0, W0) uint8.  The plan (ops/kernels/
// upsample_argmax.py `plan`): tiles of `tr` x `tc` output pixels, CTAs of
// `threads` threads a run of `run` columns each, over `tr` / (threads x run /
// tc) passes; each run's taps within `span` input columns (an instantiation
// of the kernel); `cb` classes a chunk; a staged window of `wr` rows x `wx`
// columns; `smem` bytes.  The plan must hold every tile's taps inside its
// window and every run's inside its span; the kernel does not check that.
// A plan the kernel does not take returns an error and launches nothing.
extern "C" int mk_upsample_argmax(const void* x, int B, int C, int h, int w, const int* hlo,
                                  const float* hw, int th, const int* wlo, const float* wdt,
                                  int tw, int H0, int W0, uint8_t* out, int dtype, int tr,
                                  int tc, int run, int span, int cb, int wr, int wx,
                                  int threads, int smem, void* stream) {
  const int runs = run > 0 ? tc / run : 0;
  if (B < 1 || C < 1 || C > 256 || th < 1 || th > MAXT || tw < 1 || tw > MAXT || tr < 1 ||
      run < 1 || tc < run || tc % run || threads < 32 || threads > MAX_THREADS ||
      threads % 32 || threads % runs || tr % (threads / runs) || cb < 1 || cb > C ||
      wr < th || wx < span || smem > SMEM_MAX ||
      (size_t)smem != smem_bytes(tr, th, cb, wr, wx) || (H0 + tr - 1) / tr > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{C, h, w, H0, W0, th, tw, tr, tc, cb, wr, wx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(run, span, x, B, hlo, hw, wlo, wdt, g, out,
                                                    threads, smem, s));
  return static_cast<int>(
      dispatch<float>(run, span, x, B, hlo, hw, wlo, wdt, g, out, threads, smem, s));
}
