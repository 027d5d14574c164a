// K6: fused x8 bilinear upsample + weighted softmax cross-entropy, forward
// and backward.
//
// Replaces seg_ce_up8 (multiyolov5_tpu/ops/pallas/seg_ce_kernel.py:256):
// its custom VJP _seg_ce (:204-253), forward body _fwd_kernel (:64-98) and
// backward body _bwd_kernel (:101-142).  The loss is
//   sum_valid w[y] * (lse_c(up(z)) - up(z)_y) / max(sum_valid w[y], 1)
// with up = align-corners bilinear resize of the 1/8-res logits z (B, h, w,
// C), channels last, to the labels' (H, W), and valid = (y != ignore_index
// and 0 <= y < C).  The TPU kernel forms each full-res class plane with two
// MXU matmuls in VMEM.  Here the interpolation is what it is, 2x2 taps: the
// host passes per output row (and column) its first input row and two
// float32 weights, built in float64 like torch's and the JAX package's
// matrices, and per input row (column) the first output row whose taps
// touch it and how many do.  No full-res (B, C, H, W) tensor, logits or
// gradient, is ever written.
//
// What bounds it on an H100: the exps, one per (label pixel, class) each
// way, 80M at the train step's (8, 64, 128, 19) -> 512x1024, at the SFU's
// 16 a clock an SM (the CUDA programming guide, compute capability 9.0),
// ~0.02 ms each way.  The bytes come next: 16.8 MB of int32
// labels read by both passes, 16.8 MB of float32 logsumexp written by the
// forward and read by the backward, 2.5-5 MB of z and of dz.  So both
// passes take each exp once, on the CUDA cores (no tensor cores: the
// interpolation is 2 taps a side), and read each label and logsumexp once
// from device memory, coalesced.
//
// Both passes tile the input cells.  A CTA stages its z tile in shared
// memory, float32 with the classes padded (PAD_LOGIT) to the chunk the
// threads hold, so a thread's class loops have no bounds to test; a
// thread owns one label column X and walks the tile's label rows top to
// bottom, each row's table entries, label and logsumexp loaded two rows
// ahead.  It keeps the column-interpolated logits of the two input rows it
// is between (zl and dd = zh - zl, base 2) in registers and reloads them
// only when the walk crosses an input row, so a label pixel's logit costs
// one FFMA a class.  What sets the time is each warp's chain of dependent
// steps a label row (exps, their sum, the log, the label's logit), not a
// unit's throughput: a CTA alone on its SM lives about as long as beside
// two others.  So the kernels hold registers to <= 96 a thread
// (__launch_bounds__), 4 CTAs of 160 threads an SM, for more rows in
// flight.
//
// Forward: a CTA a ti x tj tile of input cells (the label pixels whose
// first taps lie in it, no halo).  A thread sums 2^(logit - m) over its
// pixel's classes against the cell row's max m (one FFMA, one exp and one
// FADD a class; a pixel whose sum falls below 2^-100, its own max far
// below m, is summed again against that max), takes one log and writes the
// pixel's logsumexp (B*H*W
// floats) for the backward.  Each thread sums its (weighted nll, weight)
// along its walk, the CTA reduces them in a fixed order to one partial,
// and one more block sums the partials in a fixed order, in double: the
// loss is deterministic.
//
// Backward: a CTA a ti x tj tile of dz for one image, every class.  The
// label pixels whose taps touch the tile are its own cells and one cell of
// halo each way: (ti + 1) x (tj + 1) cells, recomputed where tiles meet
// ((9/8)^2 ~ 1.27x the exps at 8 x 8, where the gather form it replaced
// took 4x).  A thread takes a label column and a group of cg classes (2 x
// 10 at C = 19) and forms, a pixel at a time, g_c = (softmax_c - [y == c])
// w[y] g / D (g / D folded into the weights; 0 for an ignored label), one
// exp a class.  The adjoint is separable and runs in a fixed order: first
// along the rows (MH^T, as the TPU kernel), in registers, as the thread
// walks down its column: a pixel adds a0 p_c w g / D to input row lo and a1
// of it to row lo + 1, and a row is complete, and added into the partials
// U in shared memory, when the walk leaves it; the one-hot term goes into
// U at once, by the same thread.  Then along the columns: each dz element
// sums its ~16 label columns in ascending order.  Each dz element has one
// writer, no atomics anywhere: dz is bitwise repeatable, and the same for
// every tile size (an element's sums run over the same pixels in the same
// order in any tile).
#include "common.cuh"

namespace {

// A CTA's threads, and the CTAs an SM should hold: 4 x 160 threads at <= 102
// registers a thread (the walks are latency-bound: more warps, more rows
// in flight); 2 for the widest class chunks, which need more registers
constexpr int MAX_THREADS = 160;
constexpr int MIN_CTAS = 4;
constexpr int RED_THREADS = 1024;
constexpr float L2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float PAD_LOGIT = -1e30f;  // a padded class's logit: its exp is 0
// dynamic shared memory a CTA may take: the card's 227 KB less 1 KB for the
// forward's static reduction slots
constexpr int SMEM_MAX = 226 * 1024;

// Shared memory of a pass, in floats, with the classes padded to CP (the
// forward's cb, the backward's groups x cg).  Forward: the CP class
// weights, the (ti + 1) x (tj + 1) x CP z tile.  Backward: the CP scaled
// class weights, the two column weights of each of the tile's `cols` label
// columns, the (ti + 2) x (tj + 2) x CP z tile, and the row-contracted
// partials U (ti input rows x `cols` label columns x CP).
// ops/kernels/seg_ce.py smem_bytes counts the same.
struct Layout {
  int cw, zs, u, total;
};

__host__ __device__ inline Layout make_layout(bool bwd, int CP, int ti, int tj, int cols) {
  Layout L;
  L.cw = CP;
  L.zs = L.cw + (bwd ? 2 * cols : 0);
  L.u = L.zs + (bwd ? (ti + 2) * (tj + 2) : (ti + 1) * (tj + 1)) * CP;
  L.total = L.u + (bwd ? ti * cols * CP : 0);
  return L;
}

__device__ __forceinline__ bool valid_label(int lab, int ignore, int C) {
  return lab != ignore && lab >= 0 && lab < C;
}

// 2^x on the SFU (MUFU.EX2): relative error ~2^-22, 0 below 2^-126
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// What a walk reads of one label row: its first input row and two row
// weights, and the thread's label and (backward) logsumexp.
struct RowIn {
  int lo, lab;
  float a0, a1, l;
};

template <bool BWD>
__device__ __forceinline__ RowIn load_row(int Y, size_t pix, const int* hlo, const float* hwt,
                                          const int* y, const float* lse) {
  RowIn r;
  r.lo = __ldg(hlo + Y);
  r.a0 = BWD ? __ldg(hwt + 2 * Y) : 0.f;
  r.a1 = __ldg(hwt + 2 * Y + 1);
  r.lab = __ldg(y + pix);
  r.l = BWD ? __ldg(lse + pix) : 0.f;
  return r;
}

// z rows r0 .. r0 + n - 1, columns c0 .. c0 + m - 1, from channels-last z
// into float32 shared memory with the classes padded from C to CP by
// PAD_LOGIT; each thread keeps 8 loads in flight.
template <typename T>
__device__ __forceinline__ void stage_z(float* zs, const T* z, size_t img, int r0, int n,
                                        int c0, int m, int w, int C, int CP, int tid, int nt) {
  const T* src = z + ((img + r0) * w + c0) * C;
  const int row = m * C, total = n * row;
  for (int base = tid; base < total; base += 8 * nt) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * nt, r = e / row;
      if (e < total) v[u] = src[(size_t)r * w * C + (e - r * row)];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * nt, r = e / row, q = e - r * row, col = q / C;
      if (e < total) zs[(r * m + col) * CP + q - col * C] = to_f(v[u]);
    }
  }
  const int pad = CP - C;
  for (int e = tid; e < n * m * pad; e += nt) {
    const int cell = e / pad;
    zs[cell * CP + C + e - cell * pad] = PAD_LOGIT;
  }
}

// Classes [0, N) from zc (the thread's first column and class) of staged
// z rows `row` and `row + 1` (zrow floats a row, CP a column),
// column-interpolated (q0 z[.][c0] + q1 z[.][c0 + 1]) and scaled to base 2:
// lo = the upper row's, dd = the lower row's minus lo, so that a label row
// with weight a1 on the lower row has logit fmaf(a1, dd, lo) / ln 2.
template <int N>
__device__ __forceinline__ void row_pair(float (&lo)[N], float (&dd)[N], const float* zc,
                                         int row, int zrow, int CP, float q0, float q1) {
  const float* p = zc + row * zrow;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    lo[k] = fmaf(q1, p[CP + k], q0 * p[k]) * L2E;
    dd[k] = fmaf(q1, p[zrow + CP + k], q0 * p[zrow + k]) * L2E - lo[k];
  }
}

// The forward's per-pixel sum of 2^(logit - m) over the classes, the
// logits fmaf(a1, dd, zl) + m (base 2, zl less the cell row's max m).
template <int CB>
__device__ __forceinline__ float sum_exp2(const float (&zl)[CB], const float (&dd)[CB],
                                          float a1) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < CB; ++q) s += ex2(fmaf(a1, dd[q], zl[q]));
  return s;
}

// The same sum where the pixel's own max lies far below the row's, less
// that max, which l2 takes on (the sum < 2^-100 cannot be trusted).
template <int CB>
__device__ __forceinline__ float rescue_sum(const float (&zl)[CB], const float (&dd)[CB], float a1,
                                         float& l2) {
  float m2 = -INFINITY;
#pragma unroll
  for (int q = 0; q < CB; ++q) m2 = fmaxf(m2, fmaf(a1, dd[q], zl[q]));
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < CB; ++q) s += ex2(fmaf(a1, dd[q], zl[q]) - m2);
  l2 += m2;
  return s;
}

// The forward's nll term of one label: (lse - its logit) w[y], 0 where
// the label is ignored; the logit by row_pair's operations on its class.
__device__ __forceinline__ float label_nll(const RowIn& in, float l, const float* zc, int row,
                                           int zrow, int CP, float q0, float q1,
                                           const float* wc, int ignore, int C, float& den) {
  const bool ok = valid_label(in.lab, ignore, C);
  const float* p = zc + row * zrow + (ok ? in.lab : 0);
  const float lo = fmaf(q1, p[CP], q0 * p[0]) * L2E;
  const float dd = fmaf(q1, p[zrow + CP], q0 * p[zrow]) * L2E - lo;
  const float wv = ok ? wc[in.lab] : 0.f;
  den += wv;
  return (l - fmaf(in.a1, dd, lo) * LN2) * wv;
}

template <typename T, int CB>
__global__ void __launch_bounds__(MAX_THREADS, CB > 20 ? 2 : MIN_CTAS)
seg_ce_fwd_kernel(const T* __restrict__ z, const int* __restrict__ y,
                  const float* __restrict__ wcls, int C, int h, int w, int H, int W,
                  const int* __restrict__ hlo, const float* __restrict__ hwt,
                  const int* __restrict__ hfirst, const int* __restrict__ hcount,
                  const int* __restrict__ wlo, const float* __restrict__ wwt,
                  const int* __restrict__ wfirst, const int* __restrict__ wcount, int ignore,
                  int ti, int tj, int cols, float* __restrict__ lse,
                  float2* __restrict__ partials) {
  extern __shared__ float sm[];
  const Layout L = make_layout(false, CB, ti, tj, cols);
  float* wc = sm;
  float* zs = sm + L.zs;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.z, r0 = blockIdx.y * ti, s0 = blockIdx.x * tj;
  const int nr = min(ti, h - 1 - r0), nc = min(tj, w - 1 - s0);  // cells of the tile
  const int zrow = (nc + 1) * CB;                                 // floats a staged z row
  for (int k = tid; k < CB; k += nt) wc[k] = k < C ? wcls[k] : 0.f;
  stage_z(zs, z, (size_t)b * h, r0, nr + 1, s0, nc + 1, w, C, CB, tid, nt);
  __syncthreads();
  // label rows (columns) whose first tap lies in the tile's cells
  const int Ys = hfirst[r0 + 1], Ye = hfirst[r0 + nr - 1] + hcount[r0 + nr - 1];
  const int Xs = wfirst[s0 + 1], Xe = wfirst[s0 + nc - 1] + wcount[s0 + nc - 1];
  const size_t img = (size_t)b * H;
  float nll = 0.f, den = 0.f;
  for (int X = Xs + tid; X < Xe && Ys < Ye; X += nt) {
    const int lx = wlo[X];
    const float q0 = wwt[2 * X], q1 = wwt[2 * X + 1];
    const float* zc = zs + (lx - s0) * CB;
    // the two input rows of the current cell row, base 2, less their max m
    float zl[CB], dd[CB], m = 0.f;
    int zr = -1;
    size_t pix = (img + Ys) * W + X;
    RowIn n1 = load_row<false>(Ys, pix, hlo, hwt, y, nullptr), n2 = n1;
    if (Ys + 1 < Ye) n2 = load_row<false>(Ys + 1, pix + W, hlo, hwt, y, nullptr);
    for (int Y = Ys; Y < Ye; ++Y, pix += W) {
      const RowIn in = n1;  // rows Y + 1 and Y + 2 are in flight
      n1 = n2;
      if (Y + 2 < Ye) n2 = load_row<false>(Y + 2, pix + 2 * W, hlo, hwt, y, nullptr);
      if (in.lo != zr) {
        row_pair(zl, dd, zc, in.lo - r0, zrow, CB, q0, q1);
        m = -INFINITY;
#pragma unroll
        for (int q = 0; q < CB; ++q) m = fmaxf(m, fmaxf(zl[q], zl[q] + dd[q]));
#pragma unroll
        for (int q = 0; q < CB; ++q) zl[q] -= m;
        zr = in.lo;
      }
      float l2 = m, sa = sum_exp2(zl, dd, in.a1);
      if (sa < 0x1p-100f) sa = rescue_sum(zl, dd, in.a1, l2);
      const float l = (l2 + log2f(sa)) * LN2;
      lse[pix] = l;
      nll += label_nll(in, l, zc, in.lo - r0, zrow, CB, q0, q1, wc, ignore, C, den);
    }
  }
  // fixed-order block reduction: warp shuffles, then the warps' sums in order
  __shared__ float2 part[MAX_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    nll += __shfl_down_sync(0xffffffffu, nll, o);
    den += __shfl_down_sync(0xffffffffu, den, o);
  }
  if ((tid & 31) == 0) part[tid >> 5] = make_float2(nll, den);
  __syncthreads();
  if (tid == 0) {
    float2 acc = part[0];
    for (int k = 1; k < nt / 32; ++k) {
      acc.x += part[k].x;
      acc.y += part[k].y;
    }
    partials[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = acc;
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

// Add a completed input row's partials of the thread's classes into U, if
// the row is one of the tile's.
template <int CG>
__device__ __forceinline__ void park_row(float* U, const float (&acc)[CG], int row, int i0,
                                         int ni, int cols, int xi, int CP, int cb) {
  const int r = row - i0;
  if (r < 0 || r >= ni) return;
  float* u = U + (r * cols + xi) * CP + cb;
#pragma unroll
  for (int k = 0; k < CG; ++k) u[k] += acc[k];
}

// One label pixel's backward terms: (p_c - [y == c]) w[y] g / D, the p_c
// part a0 of it into acc0 (input row cur) and a1 into acc1 (cur + 1), the
// one-hot part straight into U.
template <int CG>
__device__ __forceinline__ void pixel_grad(float (&acc0)[CG], float (&acc1)[CG],
                                           const float (&zl)[CG], const float (&dd)[CG],
                                           const RowIn& in, const float* wsc, float* U,
                                           int cur, int i0, int ni, int cols, int xi, int C,
                                           int CP, int cb, int ignore) {
  const bool ok = valid_label(in.lab, ignore, C);
  const float ws = ok ? wsc[in.lab] : 0.f;
  const float a0w = in.a0 * ws, a1w = in.a1 * ws, nl = -in.l * L2E;
#pragma unroll
  for (int q = 0; q < CG; ++q) {
    const float p = ex2(fmaf(in.a1, dd[q], zl[q]) + nl);
    acc0[q] = fmaf(a0w, p, acc0[q]);
    acc1[q] = fmaf(a1w, p, acc1[q]);
  }
  if (ok && static_cast<unsigned>(in.lab - cb) < static_cast<unsigned>(CG)) {
    const int rr = cur - i0;
    float* u = U + (rr * cols + xi) * CP + in.lab;
    if (rr >= 0 && rr < ni) u[0] -= a0w;
    if (rr + 1 >= 0 && rr + 1 < ni) u[cols * CP] -= a1w;
  }
}

template <typename T, int CG>
__global__ void __launch_bounds__(MAX_THREADS, CG > 10 ? 2 : MIN_CTAS)
seg_ce_bwd_kernel(const T* __restrict__ z, const int* __restrict__ y,
                  const float* __restrict__ lse, const float* __restrict__ wcls,
                  const float* __restrict__ gout, const float* __restrict__ stats, int C, int h,
                  int w, int H, int W, const int* __restrict__ hlo,
                  const float* __restrict__ hwt, const int* __restrict__ hfirst,
                  const int* __restrict__ hcount, const int* __restrict__ wlo,
                  const float* __restrict__ wwt, const int* __restrict__ wfirst,
                  const int* __restrict__ wcount, int ignore, int ti, int tj, int groups,
                  int cols, T* __restrict__ dz) {
  extern __shared__ float sm[];
  const int CP = groups * CG;
  const Layout L = make_layout(true, CP, ti, tj, cols);
  float* wsc = sm;
  float* cw = sm + L.cw;
  float* zs = sm + L.zs;
  float* U = sm + L.u;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.z, i0 = blockIdx.y * ti, j0 = blockIdx.x * tj;
  const int ni = min(ti, h - i0), nj = min(tj, w - j0);
  // label rows (columns) whose taps touch the tile's input rows (columns)
  const int Ys = hfirst[i0], Ye = hfirst[i0 + ni - 1] + hcount[i0 + ni - 1];
  const int Xs = wfirst[j0], Xe = wfirst[j0 + nj - 1] + wcount[j0 + nj - 1];
  const int nx = Xe - Xs;
  // the z rows and columns those pixels' taps read
  const int zr0 = max(i0 - 1, 0), zc0 = max(j0 - 1, 0);
  const int zrn = min(i0 + ni, h - 1) - zr0 + 1, zcn = min(j0 + nj, w - 1) - zc0 + 1;
  const int zrow = zcn * CP;
  const float scale = gout[0] / fmaxf(stats[1], 1.f);
  for (int k = tid; k < CP; k += nt) wsc[k] = k < C ? wcls[k] * scale : 0.f;
  for (int k = tid; k < 2 * nx; k += nt) cw[k] = wwt[2 * Xs + k];
  stage_z(zs, z, (size_t)b * h, zr0, zrn, zc0, zcn, w, C, CP, tid, nt);
  for (int e = tid; e < ni * cols * CP; e += nt) U[e] = 0.f;
  __syncthreads();

  // work items: (class group g, label column xi), a thread's in turn
  const size_t img = (size_t)b * H;
  for (int item = tid; item < groups * nx && Ys < Ye; item += nt) {
    const int g = item / nx, xi = item - g * nx, cb = g * CG, X = Xs + xi;
    const int lx = wlo[X];
    const float q0 = cw[2 * xi], q1 = cw[2 * xi + 1];
    const float* zc = zs + (lx - zc0) * CP + cb;
    float zl[CG], dd[CG], acc0[CG], acc1[CG];  // acc0: input row cur, acc1: cur + 1
#pragma unroll
    for (int k = 0; k < CG; ++k) acc0[k] = acc1[k] = 0.f;
    int zr = -1;
    size_t pix = (img + Ys) * W + X;
    RowIn n1 = load_row<true>(Ys, pix, hlo, hwt, y, lse), n2 = n1;
    if (Ys + 1 < Ye) n2 = load_row<true>(Ys + 1, pix + W, hlo, hwt, y, lse);
    int cur = n1.lo;
    for (int Y = Ys; Y < Ye; ++Y, pix += W) {
      const RowIn in = n1;  // rows Y + 1 and Y + 2 are in flight
      n1 = n2;
      if (Y + 2 < Ye) n2 = load_row<true>(Y + 2, pix + 2 * W, hlo, hwt, y, lse);
      if (in.lo != zr) {
        while (cur < in.lo) {  // input row cur is complete
          park_row(U, acc0, cur, i0, ni, cols, xi, CP, cb);
#pragma unroll
          for (int q = 0; q < CG; ++q) {
            acc0[q] = acc1[q];
            acc1[q] = 0.f;
          }
          ++cur;
        }
        row_pair(zl, dd, zc, in.lo - zr0, zrow, CP, q0, q1);
        zr = in.lo;
      }
      pixel_grad(acc0, acc1, zl, dd, in, wsc, U, cur, i0, ni, cols, xi, C, CP, cb, ignore);
    }
    park_row(U, acc0, cur, i0, ni, cols, xi, CP, cb);
    park_row(U, acc1, cur + 1, i0, ni, cols, xi, CP, cb);
  }
  __syncthreads();

  // the column contraction: dz[i][j][c] sums its label columns in order,
  // those with first tap j - 1 (weight q1), then those with first tap j (q0)
  for (int e = tid; e < nj * C; e += nt) {
    const int jj = e / C, c = e - jj * C, j = j0 + jj;
    const int xs = wfirst[j] - Xs, xe = xs + wcount[j];
    const int xm = j + 1 < w ? min(wfirst[j + 1] - Xs, xe) : xe;
    for (int r = 0; r < ni; ++r) {
      const float* u = U + r * cols * CP + c;
      float s = 0.f;
      for (int x = xs; x < xm; ++x) s = fmaf(cw[2 * x + 1], u[x * CP], s);
      for (int x = xm; x < xe; ++x) s = fmaf(cw[2 * x], u[x * CP], s);
      dz[(((size_t)b * h + i0 + r) * w + j) * C + c] = from_f<T>(s);
    }
  }
}

// Raise a kernel's dynamic shared-memory cap once, at its first launch
// (outside any CUDA-graph capture that later launches may run under).
template <typename K>
cudaError_t allow_smem(K kern, bool& done) {
  if (done) return cudaSuccess;
  done = true;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

template <typename T, int CB>
int launch_fwd(const void* z, const int* y, const float* wcls, int B, int C, int h, int w,
               int H, int W, const int* const* it, const float* hwt, const float* wwt,
               int ignore, int ti, int tj, int cols, int threads, float* lse, float* partials,
               float* stats, cudaStream_t stream) {
  static bool cap = false;
  cudaError_t err = allow_smem(seg_ce_fwd_kernel<T, CB>, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w - 1 + tj - 1) / tj, (h - 1 + ti - 1) / ti, B);
  seg_ce_fwd_kernel<T, CB><<<grid, threads, make_layout(false, CB, ti, tj, cols).total * 4,
                              stream>>>(
      static_cast<const T*>(z), y, wcls, C, h, w, H, W, it[0], hwt, it[1], it[2], it[3], wwt,
      it[4], it[5], ignore, ti, tj, cols, lse, reinterpret_cast<float2*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_ce_reduce_kernel<<<1, RED_THREADS, 0, stream>>>(
      reinterpret_cast<const float2*>(partials), grid.x * grid.y * grid.z, stats);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CG>
int launch_bwd(const void* z, const int* y, const float* lse, const float* wcls,
               const float* gout, const float* stats, int B, int C, int h, int w, int H, int W,
               const int* const* it, const float* hwt, const float* wwt, int ignore, int ti,
               int tj, int groups, int cols, int threads, void* dz, cudaStream_t stream) {
  static bool cap = false;
  cudaError_t err = allow_smem(seg_ce_bwd_kernel<T, CG>, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + tj - 1) / tj, (h + ti - 1) / ti, B);
  seg_ce_bwd_kernel<T, CG><<<grid, threads, make_layout(true, groups * CG, ti, tj, cols).total * 4,
                              stream>>>(
      static_cast<const T*>(z), y, lse, wcls, gout, stats, C, h, w, H, W, it[0], hwt, it[1],
      it[2], it[3], wwt, it[4], it[5], ignore, ti, tj, groups, cols, static_cast<T*>(dz));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_classes(int cb, const void* z, const int* y, const float* wcls, int B, int C, int h,
                int w, int H, int W, const int* const* it, const float* hwt,
                const float* wwt, int ignore, int ti, int tj, int cols, int threads,
                float* lse, float* partials, float* stats, cudaStream_t s) {
#define MK_FWD(N)                                                                         \
  case N:                                                                                 \
    return launch_fwd<T, N>(z, y, wcls, B, C, h, w, H, W, it, hwt, wwt, ignore, ti, tj,   \
                            cols, threads, lse, partials, stats, s);
  switch (cb) {
    MK_FWD(8)
    MK_FWD(20)
    MK_FWD(32)
  }
#undef MK_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_classes(int cg, const void* z, const int* y, const float* lse, const float* wcls,
                const float* gout, const float* stats, int B, int C, int h, int w, int H,
                int W, const int* const* it, const float* hwt, const float* wwt, int ignore,
                int ti, int tj, int groups, int cols, int threads, void* dz, cudaStream_t s) {
#define MK_BWD(N)                                                                          \
  case N:                                                                                  \
    return launch_bwd<T, N>(z, y, lse, wcls, gout, stats, B, C, h, w, H, W, it, hwt, wwt,  \
                            ignore, ti, tj, groups, cols, threads, dz, s);
  switch (cg) {
    MK_BWD(4)
    MK_BWD(8)
    MK_BWD(10)
    MK_BWD(20)
  }
#undef MK_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_threads(int threads) {
  return threads < 32 || threads > MAX_THREADS || threads % 32 != 0;
}

}  // namespace

// Dynamic shared memory of one CTA of a pass (0: forward, 1: backward) at
// CP padded classes (cb forward, groups x cg backward), a ti x tj tile and
// `cols` label columns a tile.
extern "C" int mk_seg_ce_smem_bytes(int pass, int CP, int ti, int tj, int cols) {
  return 4 * make_layout(pass == 1, CP, ti, tj, cols).total;
}

// z: (B, h, w, C) channels-last logits in `dtype`; y: (B, H, W) int32
// labels; wcls: (C,) float32 class weights; hlo/hwt: per output row its
// first input row and 2 float32 weights, hfirst/hcount: per input row the
// first output row whose taps touch it and how many do (wlo, wwt, wfirst,
// wcount the same for columns).  The plan (ops/kernels/seg_ce.py plan): a
// CTA a ti x tj tile of input cells, `cols` >= the label columns of any
// tile, cb >= C classes in registers (8, 20 or 32).  lse:
// (B, H, W) float32 out; partials: one float2 a CTA, scratch; stats: 2
// floats out, (loss, D = sum of valid weights).
extern "C" int mk_seg_ce_fwd(const void* z, const int* y, const float* wcls, int B, int C,
                             int h, int w, int H, int W, const int* hlo, const float* hwt,
                             const int* hfirst, const int* hcount, const int* wlo,
                             const float* wwt, const int* wfirst, const int* wcount,
                             int ignore, int ti, int tj, int cb, int cols, int threads,
                             float* lse, float* partials, float* stats, int dtype,
                             void* stream) {
  if (bad_threads(threads) || cb < C || ti < 1 || tj < 1 || h < 2 ||
      w < 2 || mk_seg_ce_smem_bytes(0, cb, ti, tj, cols) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* it[6] = {hlo, hfirst, hcount, wlo, wfirst, wcount};
  if (dtype == DT_BF16)
    return fwd_classes<__nv_bfloat16>(cb, z, y, wcls, B, C, h, w, H, W, it, hwt, wwt, ignore,
                                      ti, tj, cols, threads, lse, partials, stats, s);
  return fwd_classes<float>(cb, z, y, wcls, B, C, h, w, H, W, it, hwt, wwt, ignore, ti, tj,
                            cols, threads, lse, partials, stats, s);
}

// The forward's inputs and outputs, gout: the upstream gradient (1 float);
// the plan: a CTA a ti x tj tile of dz, `groups` groups of cg classes
// (4, 8, 10 or 20) a label column, `cols` >= the label columns of any tile.
// dz: (B, h, w, C) channels-last in `dtype`.
extern "C" int mk_seg_ce_bwd(const void* z, const int* y, const float* lse,
                             const float* wcls, const float* gout, const float* stats, int B,
                             int C, int h, int w, int H, int W, const int* hlo,
                             const float* hwt, const int* hfirst, const int* hcount,
                             const int* wlo, const float* wwt, const int* wfirst,
                             const int* wcount, int ignore, int ti, int tj, int cg, int groups,
                             int cols, int threads, void* dz, int dtype, void* stream) {
  if (bad_threads(threads) || cg * groups < C || ti < 1 ||
      tj < 1 || h < 2 || w < 2 || mk_seg_ce_smem_bytes(1, cg * groups, ti, tj, cols) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* it[6] = {hlo, hfirst, hcount, wlo, wfirst, wcount};
  if (dtype == DT_BF16)
    return bwd_classes<__nv_bfloat16>(cg, z, y, lse, wcls, gout, stats, B, C, h, w, H, W, it,
                                      hwt, wwt, ignore, ti, tj, groups, cols, threads, dz, s);
  return bwd_classes<float>(cg, z, y, lse, wcls, gout, stats, B, C, h, w, H, W, it, hwt, wwt,
                            ignore, ti, tj, groups, cols, threads, dz, s);
}
