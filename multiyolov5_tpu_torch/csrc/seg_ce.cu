// K6: fused x8 bilinear upsample + weighted softmax cross-entropy, forward
// and backward.
//
// Replaces seg_ce_up8 (multiyolov5_tpu/ops/pallas/seg_ce_kernel.py:256):
// its custom VJP _seg_ce (:204-253), forward body _fwd_kernel (:64-98) and
// backward body _bwd_kernel (:101-142).  The loss is
//   sum_valid w[y] * (lse_c(up(z)) - up(z)_y) / max(sum_valid w[y], 1)
// with up = align-corners bilinear resize of the 1/8-res logits z (B, C, h,
// w) to the labels' (H, W), and valid = (y != ignore_index and 0 <= y < C).
// The TPU kernel forms each full-res class plane with two MXU matmuls in
// VMEM.  Here the interpolation is what it is, 2x2 taps: the host passes per
// output row (and column) its first input row and two float32 weights, built
// in float64 like torch's and the JAX package's matrices.  No full-res
// (B, C, H, W) tensor, logits or gradient, is ever written.
//
// Forward: one thread per label pixel walks the classes, forms each logit
// from its 2x2 taps (z, 2.5-5 MB at the path's shapes, stays in L1/L2) and
// keeps an online logsumexp in registers, one exp per class.  It writes the
// pixel's logsumexp (B*H*W floats) for the backward.  Each block reduces its
// (weighted nll, weight) in a fixed order to one partial; one more block sums
// the partials in a fixed order, in double: the result is deterministic.
//
// Backward: the gather form, one thread per input element (b, c, i, j).  The
// output pixels whose taps touch it form a window of ~17 x 17 (the host
// passes each input row's and column's first output index and count).  For
// each, the thread rebuilds the class-c logit from the 3 x 3 input
// neighbourhood it keeps in registers row by row, takes softmax_c from the
// stored logsumexp, and accumulates (softmax_c - [y == c]) * w[y] * g / D
// times the two tap weights.  One writer per dz element: no atomics.
//
// What bounds it on an H100: the exps, B*H*W*C of them each way (80M at the
// path's 8x19x512x1024), at the SFU rate, ~0.02 ms each way; the backward
// computes each 4 times over (a label pixel lies in 4 input elements'
// windows) and reads its labels and logsumexps from L1/L2 as often.
#include "common.cuh"

namespace {

constexpr int FWD_THREADS = 256;
constexpr int RED_THREADS = 1024;
constexpr int BWD_THREADS = 128;

__device__ __forceinline__ bool valid_label(int lab, int ignore, int C) {
  return lab != ignore && lab >= 0 && lab < C;
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
seg_ce_fwd_kernel(const T* __restrict__ z, const int* __restrict__ y,
                  const float* __restrict__ wcls, int C, int h, int w, int H,
                  int W, const int* __restrict__ hlo,
                  const float* __restrict__ hwt, const int* __restrict__ wlo,
                  const float* __restrict__ wwt, int ignore,
                  float* __restrict__ lse, float2* __restrict__ partials) {
  const int X = blockIdx.x * FWD_THREADS + threadIdx.x;
  const int Y = blockIdx.y;
  const int b = blockIdx.z;
  float nll = 0.f, den = 0.f;
  if (X < W) {
    const int r0 = hlo[Y], c0 = wlo[X];
    const float a0 = hwt[2 * Y], a1 = hwt[2 * Y + 1];
    const float q0 = wwt[2 * X], q1 = wwt[2 * X + 1];
    const size_t plane = (size_t)h * w;
    const T* p = z + (size_t)b * C * plane + (size_t)r0 * w + c0;
    const size_t pix = ((size_t)b * H + Y) * W + X;
    const int lab = y[pix];
    float m = -INFINITY, s = 0.f, py = 0.f;
    for (int c = 0; c < C; ++c, p += plane) {
      // columns first, then rows: the order of MH . (z . MW^T)
      const float v = a0 * (q0 * to_f(p[0]) + q1 * to_f(p[1])) +
                      a1 * (q0 * to_f(p[w]) + q1 * to_f(p[w + 1]));
      if (v > m) {
        s = s * expf(m - v) + 1.f;
        m = v;
      } else {
        s += expf(v - m);
      }
      if (c == lab) py = v;
    }
    const float l = m + logf(s);
    lse[pix] = l;
    if (valid_label(lab, ignore, C)) {
      den = wcls[lab];
      nll = (l - py) * den;
    }
  }
  // fixed-order block reduction: warp shuffles, then the warps' sums
  __shared__ float2 part[FWD_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    nll += __shfl_down_sync(0xffffffffu, nll, o);
    den += __shfl_down_sync(0xffffffffu, den, o);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(nll, den);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 acc = part[0];
    for (int k = 1; k < FWD_THREADS / 32; ++k) {
      acc.x += part[k].x;
      acc.y += part[k].y;
    }
    partials[((size_t)b * H + Y) * gridDim.x + blockIdx.x] = acc;
  }
}

// stats = (loss, D): the partials summed in a fixed order, in double.
__global__ void __launch_bounds__(RED_THREADS)
seg_ce_reduce_kernel(const float2* __restrict__ partials, int n,
                     float* __restrict__ stats) {
  __shared__ double sn[RED_THREADS], sd[RED_THREADS];
  double a = 0.0, d = 0.0;
  for (int k = threadIdx.x; k < n; k += RED_THREADS) {
    a += partials[k].x;
    d += partials[k].y;
  }
  sn[threadIdx.x] = a;
  sd[threadIdx.x] = d;
  __syncthreads();
  for (int o = RED_THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      sn[threadIdx.x] += sn[threadIdx.x + o];
      sd[threadIdx.x] += sd[threadIdx.x + o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float num = static_cast<float>(sn[0]), dd = static_cast<float>(sd[0]);
    stats[0] = num / fmaxf(dd, 1.f);
    stats[1] = dd;
  }
}

template <typename T>
__device__ __forceinline__ float tap(const T* row, int col, int w) {
  return (col >= 0 && col < w) ? to_f(row[col]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
seg_ce_bwd_kernel(const T* __restrict__ z, const int* __restrict__ y,
                  const float* __restrict__ lse, const float* __restrict__ wcls,
                  const float* __restrict__ gout,
                  const float* __restrict__ stats, int C, int h, int w, int H,
                  int W, const int* __restrict__ hlo,
                  const float* __restrict__ hwt,
                  const int* __restrict__ hfirst,
                  const int* __restrict__ hcount,
                  const int* __restrict__ wlo, const float* __restrict__ wwt,
                  const int* __restrict__ wfirst,
                  const int* __restrict__ wcount, int ignore,
                  T* __restrict__ dz) {
  extern __shared__ float wsc[];  // C weights with g / D folded in
  const float scale = gout[0] / fmaxf(stats[1], 1.f);
  for (int k = threadIdx.x; k < C; k += BWD_THREADS) wsc[k] = wcls[k] * scale;
  __syncthreads();
  const int nbx = (w + BWD_THREADS - 1) / BWD_THREADS;
  const int c = blockIdx.x / nbx;
  const int j = (blockIdx.x % nbx) * BWD_THREADS + threadIdx.x;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= w) return;
  const T* zc = z + ((size_t)b * C + c) * h * w;
  const int ys = hfirst[i], yn = hcount[i];
  const int xs = wfirst[j], xn = wcount[j];
  float acc = 0.f;
  for (int t = 0; t < yn; ++t) {
    const int Y = ys + t;
    const int r0 = hlo[Y];
    const float a0 = hwt[2 * Y], a1 = hwt[2 * Y + 1];
    const float wyi = (r0 == i) ? a0 : a1;  // i is r0 or r0 + 1
    // row-interpolated logits at input columns j - 1, j, j + 1
    const T* z0 = zc + (size_t)r0 * w;
    const T* z1 = z0 + w;
    const float v0 = a0 * tap(z0, j - 1, w) + a1 * tap(z1, j - 1, w);
    const float v1 = a0 * tap(z0, j, w) + a1 * tap(z1, j, w);
    const float v2 = a0 * tap(z0, j + 1, w) + a1 * tap(z1, j + 1, w);
    const size_t row = ((size_t)b * H + Y) * W;
    float rs = 0.f;
    for (int u = 0; u < xn; ++u) {
      const int X = xs + u;
      const int lab = y[row + X];
      if (!valid_label(lab, ignore, C)) continue;
      const float q0 = wwt[2 * X], q1 = wwt[2 * X + 1];
      const bool at_j = wlo[X] == j;  // j is c0 or c0 + 1
      const float p = at_j ? q0 * v1 + q1 * v2 : q0 * v0 + q1 * v1;
      float g = expf(p - lse[row + X]);
      if (lab == c) g -= 1.f;
      rs += g * wsc[lab] * (at_j ? q0 : q1);
    }
    acc += wyi * rs;
  }
  dz[((size_t)b * C + c) * h * w + (size_t)i * w + j] = from_f<T>(acc);
}

template <typename T>
int launch_fwd(const void* z, const int* y, const float* wcls, int B, int C,
               int h, int w, int H, int W, const int* hlo, const float* hwt,
               const int* wlo, const float* wwt, int ignore, float* lse,
               float* partials, float* stats, cudaStream_t stream) {
  const dim3 grid((W + FWD_THREADS - 1) / FWD_THREADS, H, B);
  seg_ce_fwd_kernel<T><<<grid, FWD_THREADS, 0, stream>>>(
      static_cast<const T*>(z), y, wcls, C, h, w, H, W, hlo, hwt, wlo, wwt,
      ignore, lse, reinterpret_cast<float2*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_ce_reduce_kernel<<<1, RED_THREADS, 0, stream>>>(
      reinterpret_cast<const float2*>(partials), grid.x * H * B, stats);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* z, const int* y, const float* lse,
               const float* wcls, const float* gout, const float* stats, int B,
               int C, int h, int w, int H, int W, const int* hlo,
               const float* hwt, const int* hfirst, const int* hcount,
               const int* wlo, const float* wwt, const int* wfirst,
               const int* wcount, int ignore, void* dz, cudaStream_t stream) {
  const dim3 grid(C * ((w + BWD_THREADS - 1) / BWD_THREADS), h, B);
  seg_ce_bwd_kernel<T><<<grid, BWD_THREADS, C * sizeof(float), stream>>>(
      static_cast<const T*>(z), y, lse, wcls, gout, stats, C, h, w, H, W, hlo,
      hwt, hfirst, hcount, wlo, wwt, wfirst, wcount, ignore,
      static_cast<T*>(dz));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (B, C, h, w) planar logits in `dtype`; y: (B, H, W) int32 labels;
// wcls: (C,) float32 class weights; hlo/hwt: per output row its first input
// row and 2 float32 weights (wlo/wwt per output column); lse: (B, H, W)
// float32 out; partials: B * H * ceil(W / 256) float2 scratch; stats: 2
// floats out, (loss, D = sum of valid weights).
extern "C" int mk_seg_ce_fwd(const void* z, const int* y, const float* wcls,
                             int B, int C, int h, int w, int H, int W,
                             const int* hlo, const float* hwt, const int* wlo,
                             const float* wwt, int ignore, float* lse,
                             float* partials, float* stats, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_fwd<__nv_bfloat16>(z, y, wcls, B, C, h, w, H, W, hlo, hwt,
                                     wlo, wwt, ignore, lse, partials, stats, s);
  return launch_fwd<float>(z, y, wcls, B, C, h, w, H, W, hlo, hwt, wlo, wwt,
                           ignore, lse, partials, stats, s);
}

// The forward's inputs and outputs, gout: the upstream gradient (1 float);
// hfirst/hcount: per input row the first output row whose taps touch it and
// how many do (wfirst/wcount per input column); dz: (B, C, h, w) in `dtype`.
extern "C" int mk_seg_ce_bwd(const void* z, const int* y, const float* lse,
                             const float* wcls, const float* gout,
                             const float* stats, int B, int C, int h, int w,
                             int H, int W, const int* hlo, const float* hwt,
                             const int* hfirst, const int* hcount,
                             const int* wlo, const float* wwt,
                             const int* wfirst, const int* wcount, int ignore,
                             void* dz, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16>(z, y, lse, wcls, gout, stats, B, C, h, w,
                                     H, W, hlo, hwt, hfirst, hcount, wlo, wwt,
                                     wfirst, wcount, ignore, dz, s);
  return launch_bwd<float>(z, y, lse, wcls, gout, stats, B, C, h, w, H, W, hlo,
                           hwt, hfirst, hcount, wlo, wwt, wfirst, wcount,
                           ignore, dz, s);
}
