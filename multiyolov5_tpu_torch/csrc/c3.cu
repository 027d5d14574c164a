// K7: the whole fused C3 block (reference models/common.py C3 on BN-folded
// convs), NHWC in, NHWC out:
//     A = cv1(x);  n x { A = [A +] cv2_3x3(cv1_1x1(A)) };  y = cv3([A, cv2(x)])
// every conv with a float32 bias and SiLU.
//
// Replaces the Pallas kernels c3_packed_pallas (body _c3_math) and
// c3_packed_pallas_hwbc (multiyolov5_tpu/ops/pallas/c3_kernel.py:391, :315,
// :50-117), which compute this one function.  Their q-column packing (_bd,
// _pack_w33) fills the TPU's 128-wide matrix unit and the batch-layout store
// of the second steers XLA's layouts; neither has a counterpart here.
//
// Semantics kept from the TPU kernel:
//   * each 3x3's zero padding applies to ITS input: after cv1, after every
//     bottleneck 1x1 and after every bottleneck output, a pixel outside the
//     image is set to 0 (not SiLU(bias)) before anything reads it;
//   * the shortcut adds the bottleneck's own input A, not the C3's input;
//   * cv3 runs as two split products over [A | cv2(x)], never concatenated;
//   * intermediates round to the compute type where the TPU kernel casts
//     them (.astype(dt)): A after cv1 and after each bottleneck (the
//     residual sum is taken in float32 first), the 1x1's output, cv2(x).
//
// Both forms keep a tile's intermediates in shared memory: a tile's input
// slab carries an n-pixel halo (n = number of bottlenecks), every stage
// recomputes the halo it needs, and device memory sees one read of x and
// one write of y.  The 3 + 2n stages (cv1, cv2, each bottleneck's 1x1 and
// 3x3, cv3) each run as a small GEMM over a rectangle of the slab against
// that stage's weights: a warp's work item is a run of 16-pixel row tiles by
// a chunk of output channels, ldmatrix feeds mma.sync, 32 bytes of K a
// step, and the 3x3 is nine shifted row sets of the same buffer.
//
// bfloat16 (c3_bf16): mma.sync m16n8k16, bf16 in, fp32 accumulate; c_ is
// padded to a multiple of 16 with zero weights and biases, so the pad
// channels hold SiLU(0) = 0.  A grid of persistent CTAs, one of 16 warps
// an SM (ops/kernels/c3.py plan), walks the (image, tile) list with a
// fixed stride, with no atomics: the output is the same bit for bit on
// every launch.  Each CTA:
//   * copies all 3 + 2n stages' weights into shared memory once, by
//     cp.async, and keeps them for every tile (39 KB at pspv5s's c_ 32,
//     one bottleneck; 132 KB at pspv5m's c_ 48, two);
//   * loads a tile's x slab with TMA: one 4-D box (KC channels, Sw, Sh, 1)
//     a chunk of KC = 64, 32 or 16 channels (c1 = 96 is three boxes of 32,
//     c1 = 128 two of 64), rows of KC x 2 bytes under the TMA swizzle of
//     that span, which the ldmatrix addresses undo by the same XOR; the
//     box's out-of-image coordinates zero-fill, cv1's input padding.  The
//     next tile's slab loads into the same buffer once cv1 and cv2 have
//     read it, completing on an mbarrier while the bottlenecks and cv3
//     run (a second buffer, loading from the tile's start, read no
//     faster: PERF.md);
//   * runs a tile in 2 + 2n barrier-separated phases: cv1 (slab) and cv2
//     (tile) together, as they read the same slab; each bottleneck's 1x1,
//     then its 3x3 (in place on A, each (pixel, channel) read and
//     rewritten by one thread); cv3, into a staging tile of y in shared
//     memory (in the 1x1's buffer, dead by then), which the next tile's
//     first phase writes out with 16-byte stores;
//   * deals work items of 16 pixels by 32 channels to its warps
//     round-robin across the stages of a phase; a warp runs an item's K
//     steps (sources x taps x 16 channels) as one loop that loads the
//     next step's fragments before this step's products, and divides by
//     multiply and shift;
//   * takes SiLU as h + h tanh(h), h = x/2: one MUFU op (tanh.approx.f32),
//     within ~2^-11 |x| of SiLU, below a bf16 ulp of the stored value over
//     the range the activations take.
// Intermediates sit in rows of c_p + 8 (y's staging c2 + 8) elements, an
// odd multiple of 16 bytes, so the eight rows of an ldmatrix fall in
// different banks.
//
// float32 (c3_tf32): 3xTF32 on mma.sync m16n8k8, one CTA of 16 warps a
// tile of one image.  Each float32 operand splits in registers after its
// ldmatrix into x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi)
// (common.cuh), and a * w is summed as a_lo w_hi + a_hi w_lo + a_hi w_hi
// (a_lo w_lo, ~2^-22 of it, dropped).  The tensor core truncates each
// mma's sum toward zero, so each k8 step sums into a fresh accumulator that
// the float32 sum takes by FADD, rounded to nearest (as K1's stem_tf32).
// Its input tile is copied with cp.async, rows padded by 16 bytes; each
// stage's weights are copied into one of one or two buffers while the step
// before computes ([c_out][taps * c_in], zero padded), and a plan may run
// each stage in passes of 16 or 32 output channels (c3_tf32<true>), which
// lets pspv5m's c_ 48 (84 KB of 3x3 weights in float32) take an 8x16 tile.
// c_ is padded to a multiple of 8 (the k8 step), weight rows to 16 (a B
// ldmatrix loads two n8 tiles).  The 16-warp CTA and the 16x16 tile, against
// 8 warps and 8x16, took eval's shape from 0.51 to 0.32 ms (PERF.md).
//
// What bounds it on an H100: at pspv5s's bs8 1024x1024 serving shape
// (8, 256, 256, 64), c_ 32, the function reads and writes 134 MB (0.040 ms
// at 3.35 TB/s) and does 19.3 GFLOP (0.0195 ms on the bf16 tensor cores):
// bytes-bound.  At eval's float32 (4, 128, 256, 64) it moves 67.1 MB
// (0.0200 ms) and does 4.83 GFLOP, three TF32 products a MAC: 0.0293 ms at
// 495 TFLOP/s, operations-bound (0.0721 ms as float32 on the CUDA cores).
// Both forms recompute the halo (1.27x of cv1 and the 1x1 on a 16x16 tile
// at n = 1), synchronise the CTA between stages and run mma.sync rather
// than wgmma; the float32 form also splits every fragment and flushes every
// k8 step on the CUDA cores, and reloads each stage's weights a tile.
#include <map>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int MAXNB = 4;
constexpr int SMEM_MAX = 227 * 1024;   // the most dynamic shared memory a CTA may have

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int min_rows(int n, int rows) { return rows > 0 && rows < n ? rows : n; }

// ----------------------------------------------------------- async copies
// 16 bytes, zero-filled when `valid` is false (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// One stage's weights: global [n_real][taps][cK] -> shared
// [n_rows][taps * cKp + pad], zero where n >= n_real or k >= cK, in 16-byte
// chunks (cK and cKp are multiples of 8), by a CTA of NT threads.
template <typename T>
struct WDesc {
  const T* g;
  int n_real, n_rows, taps, cK, cKp;
};

template <typename T, int NT>
__device__ void copy_w(T* Ws, int pad, const WDesc<T>& d) {
  constexpr int VEC = 16 / sizeof(T);
  const int pW = d.taps * d.cKp + pad;
  const int per = d.taps * d.cKp / VEC;
  for (int i = threadIdx.x; i < d.n_rows * per; i += NT) {
    const int n = i / per, r = (i - n * per) * VEC;
    const int t = r / d.cKp, k = r - t * d.cKp;
    const bool ok = n < d.n_real && k < d.cK;
    cp_async16(Ws + n * pW + r, ok ? d.g + ((size_t)n * d.taps + t) * d.cK + k : d.g, ok);
  }
}

// Where the tile lies in the image: slab pixel p -> image pixel, or -1
// outside the image.
struct Geo {
  int Sw, gy0, gx0, H, W;
  __device__ __forceinline__ int gpix(int p) const {
    const int gy = gy0 + p / Sw, gx = gx0 + p % Sw;
    return (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gy * W + gx : -1;
  }
};

// A 3x3 tap's pixel offset on the slab (TAPS 9), or 0 (TAPS 1).
template <int TAPS>
__device__ __forceinline__ int tap_off(int t, int Sw) {
  return TAPS == 1 ? 0 : (t / 3 - 1) * Sw + (t % 3 - 1);
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory at a shared-window address.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// ================================================================ float32
namespace f32 {

constexpr int NT = 512, NCH = 16;   // threads of a CTA, output channels of a work item

struct C3Args {
  const void* w[3 + 2 * MAXNB];   // OHWI: cv1, cv2, cv3, then m.j.cv1 (1x1), m.j.cv2 (3x3)
  const float* b[3 + 2 * MAXNB];
  const void* x;
  void* y;
  int B, H, W, c1, ch, c2, nb, shortcut, th, tw, nbuf, rows, tiles_x;
};

// Shared-memory layout in floats; the host, the device and
// ops/kernels/c3.py smem_bytes compute it the same way.  A weight buffer
// holds `rows` rows of a stage (0: all of them).
struct Layout {
  int Sh, Sw, S, cp, pX, pA, offA, offB, offB2, offW, wsize, total;
};

__host__ __device__ inline Layout make_layout(int c1, int ch, int c2, int nb, int th, int tw,
                                              int nbuf, int rows) {
  const int pad = 4;
  Layout L;
  L.Sh = th + 2 * nb;
  L.Sw = tw + 2 * nb;
  L.S = L.Sh * L.Sw;
  L.cp = round8(ch);
  L.pX = c1 + pad;
  L.pA = L.cp + pad;
  const int r = min_rows(round16(L.cp), rows);   // weight rows of a c_-output stage
  int w_max = r * (c1 + pad);
  const int w3 = min_rows(round16(c2), rows) * (2 * L.cp + pad), w33 = r * (9 * L.cp + pad);
  w_max = w3 > w_max ? w3 : w_max;
  w_max = w33 > w_max ? w33 : w_max;
  L.offA = round8(L.S * L.pX);
  const int sA = round8(L.S * L.pA);
  L.offB = L.cp <= c1 ? 0 : L.offA + sA;
  L.offB2 = L.offA + (L.cp <= c1 ? 1 : 2) * sA;
  L.offW = L.offB2 + round8(th * tw * L.pA);
  L.wsize = round8(w_max);
  L.total = L.offW + nbuf * L.wsize;
  return L;
}

// The input tile, in 16-byte chunks (c1 % 16 == 0).
__device__ void copy_x(float* Xs, const C3Args& a, const Layout& L, int b, int gy0, int gx0) {
  const int nv = a.c1 / 4;
  const float* x = static_cast<const float*>(a.x);
  for (int i = threadIdx.x; i < L.S * nv; i += NT) {
    const int pix = i / nv, cv = (i - pix * nv) * 4;
    const int gy = gy0 + pix / L.Sw, gx = gx0 + pix % L.Sw;
    const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    cp_async16(Xs + pix * L.pX + cv,
               ok ? x + (((size_t)b * a.H + gy) * a.W + gx) * a.c1 + cv : x, ok);
  }
}

// One operand of a stage: rows of buffer A (pitch pA) indexed by slab pixel
// (use_m 0) or by the rectangle's own row index (use_m 1), K channels a tap,
// against weight columns kw0 + t * K .. for tap t.
struct Src {
  const float* A;
  int pA, use_m, kw0, K;
};

// A stage's output channels nlo .. nhi - 1 over the rectangle (r0, c0, rh,
// rw) of the slab: out[m][n] = bias[n] + sum over sources and taps of
// A[row(m) + off(t)][k] * W[n - nlo][kw0 + t K + k] (bias 0 past nreal).
// epi(p, m, gp, n, v0, v1) gets two neighbouring channels of row m (slab
// pixel p, image pixel gp or -1).  A K step is 8 float32 (m16n8k8, 32
// bytes of a row); an ldmatrix of float32 rows gives tf32 fragments
// (common.cuh mk::ldsm_x4).
template <int NSRC, int TAPS, class Epi>
__device__ __forceinline__ void run_stage(const float* Ws, int pW, const Src (&src)[NSRC],
                                          const Geo& G, int r0, int c0, int rh, int rw, int nlo,
                                          int nhi, const float* bias, int nreal, Epi epi) {
  constexpr int ES = 4, V = 4;   // bytes an element; elements in 16 bytes
  constexpr int NWARPS = NT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = (lane % 4) * 2, g = lane / 4;
  const int M = rh * rw, nmt = (M + 15) / 16, N = nhi - nlo, nnc = (N + NCH - 1) / NCH;
  auto pix = [&](int m) { return (r0 + m / rw) * G.Sw + c0 + m % rw; };
  // work items: a 16-row tile x NCH channels
  for (int it = warp; it < nmt * nnc; it += NWARPS) {
    const int mt = it / nnc, n0 = (it - mt * nnc) * NCH;
    // ldmatrix rows: lane % 16 of the tile (rows past M read row 0)
    int ml = mt * 16 + lane % 16;
    ml = ml < M ? ml : 0;
    const int pl = pix(ml);
    const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
    const int p_lo = m_lo < M ? pix(m_lo) : 0, p_hi = m_hi < M ? pix(m_hi) : 0;
    const int gp_lo = G.gpix(p_lo), gp_hi = G.gpix(p_hi);
    float acc[NCH / 8][4];
#pragma unroll
    for (int i = 0; i < NCH / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < NSRC; ++s) {
      const Src& S = src[s];
      const unsigned a_base = saddr(S.A + (S.use_m ? ml : pl) * S.pA + (lane / 16) * V);
      const unsigned b_base = saddr(Ws + (n0 + (lane / 16) * 8 + lane % 8) * pW + S.kw0 +
                                    ((lane / 8) % 2) * V);
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const unsigned a_t = a_base + tap_off<TAPS>(t, G.Sw) * S.pA * ES;
        const unsigned b_t = b_base + t * S.K * ES;
        for (int k0 = 0; k0 < S.K; k0 += 2 * V) {
          uint32_t a[4];
          ldsm_x4(a, a_t + k0 * ES);
          uint32_t alo[4];
          mk::tf32_split(a, alo);
#pragma unroll
          for (int np = 0; np < NCH / 16; ++np) {
            if (n0 + np * 16 < N) {
              uint32_t bf[4], blo[4];
              ldsm_x4(bf, b_t + np * 16 * pW * ES + k0 * ES);
              mk::tf32_split(bf, blo);
              mk::mma_3xtf32(acc[2 * np], a, alo, bf[0], bf[1], blo[0], blo[1]);
              if (n0 + np * 16 + 8 < N)
                mk::mma_3xtf32(acc[2 * np + 1], a, alo, bf[2], bf[3], blo[2], blo[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NCH / 8; ++nt) {
      const int n = nlo + n0 + nt * 8 + q;
      if (n0 + nt * 8 >= N) continue;
      const float b0 = n < nreal ? __ldg(bias + n) : 0.f;
      const float b1 = n + 1 < nreal ? __ldg(bias + n + 1) : 0.f;
      if (m_lo < M) epi(p_lo, m_lo, gp_lo, n, acc[nt][0] + b0, acc[nt][1] + b1);
      if (m_hi < M) epi(p_hi, m_hi, gp_hi, n, acc[nt][2] + b0, acc[nt][3] + b1);
    }
  }
}

__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// SiLU with the fast exponential (ex2.approx) and the fast reciprocal
// (__fdividef, 2 ulps; it gives 0 where 1 + e^-v passes 2^126, SiLU's limit
// there): within a few float32 ulps of expf's, far inside the kernel's
// bounds against its plain version.  The IEEE division's slow-path branches
// held a fifth of the time (PERF.md).
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

template <bool PASSES>
__device__ __forceinline__ void c3_body(const C3Args& a) {
  constexpr int PAD = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int R = PASSES ? a.rows : 0;   // weight rows a pass (0: a pass is a whole stage)
  const Layout L = make_layout(a.c1, a.ch, a.c2, a.nb, a.th, a.tw, a.nbuf, R);
  float* Xs = sm;
  float* As = sm + L.offA;
  float* Bs = sm + L.offB;
  float* B2s = sm + L.offB2;
  const int b = blockIdx.y;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int nb = a.nb, cp = L.cp, Sw = L.Sw, Sh = L.Sh, ch = a.ch, c2 = a.c2;
  const Geo G{Sw, ty * a.th - nb, tx * a.tw - nb, a.H, a.W};   // slab (0, 0) in the image
  const float* const* w = reinterpret_cast<const float* const*>(a.w);
  const float* const* bias = a.b;

  // the stages' weights, in stage order: cv1, cv2, (1x1, 3x3) per
  // bottleneck, cv3.  A stage runs in passes of R output channels (all of
  // them where R is 0), each over its own rows of weights: a step is one
  // pass of one stage.  Without PASSES this folds away at compile time.
  const int nst = 3 + 2 * nb;
  auto desc = [&](int s) -> WDesc<float> {
    const int rows = round16(cp);
    if (s < 2) return {w[s], ch, rows, 1, a.c1, a.c1};
    if (s == nst - 1) return {w[2], c2, round16(c2), 2, ch, cp};
    return (s % 2 == 0) ? WDesc<float>{w[s + 1], ch, rows, 1, ch, cp}
                        : WDesc<float>{w[s + 1], ch, rows, 9, ch, cp};
  };
  auto npass = [&](int s) {
    const int r = round16(s == nst - 1 ? c2 : cp);
    return R > 0 ? (r + R - 1) / R : 1;
  };
  auto step_desc = [&](int s, int p) {
    WDesc<float> d = desc(s);
    const int r0 = p * R;
    if (r0 > 0) {
      d.g += (size_t)r0 * d.taps * d.cK;
      d.n_real = d.n_real > r0 ? d.n_real - r0 : 0;
      d.n_rows -= r0;
    }
    d.n_real = min_rows(d.n_real, R);
    d.n_rows = min_rows(d.n_rows, R);
    return d;
  };
  auto wbuf = [&](int k) { return sm + L.offW + (a.nbuf == 2 ? (k & 1) * L.wsize : 0); };
  int step = 0, st = 0, ps = 0;   // this step, its stage and pass
  auto next = [&](int& s, int& p) {
    if (++p == npass(s)) {
      p = 0;
      ++s;
    }
  };
  // waits for this step's weights (and the last step's outputs), then
  // starts copying the next step's weights into the other buffer
  auto begin = [&]() -> float* {
    cp_async_wait_all();
    __syncthreads();
    int s = st, p = ps;
    next(s, p);
    if (a.nbuf == 2 && s < nst) {
      copy_w<float, NT>(wbuf(step + 1), PAD, step_desc(s, p));
      cp_async_commit();
    }
    return wbuf(step);
  };
  // with one buffer, the next step's weights are copied once this one is done
  auto end = [&]() {
    int s = st, p = ps;
    next(s, p);
    if (a.nbuf == 1 && s < nst) {
      __syncthreads();
      copy_w<float, NT>(wbuf(step + 1), PAD, step_desc(s, p));
      cp_async_commit();
    }
    ++step;
    st = s;
    ps = p;
  };
  // runs stage st's passes: body(Ws, nlo, nhi) for output channels nlo .. nhi - 1
  auto passes = [&](int N, auto body) {
    for (int p = 0, np = npass(st); p < np; ++p) {
      const int nlo = p * R;
      body(begin(), nlo, R > 0 && nlo + R < N ? nlo + R : N);
      end();
    }
  };
  auto act = [&](float v, int n, int nreal) {   // SiLU(v), 0 on pad channels
    return n < nreal ? silu_fast(v) : 0.f;
  };

  copy_x(Xs, a, L, b, G.gy0, G.gx0);
  copy_w<float, NT>(wbuf(0), PAD, step_desc(0, 0));
  cp_async_commit();

  // cv1 over the whole slab -> A, masked outside the image
  {
    const Src src[1] = {{Xs, L.pX, 0, 0, a.c1}};
    passes(cp, [&](const float* Ws, int nlo, int nhi) {
      run_stage<1, 1>(Ws, a.c1 + PAD, src, G, 0, 0, Sh, Sw, nlo, nhi, bias[0], ch,
                      [&](int p, int, int gp, int n, float v0, float v1) {
        store2(As + p * L.pA + n, gp >= 0 ? act(v0, n, ch) : 0.f,
               gp >= 0 ? act(v1, n + 1, ch) : 0.f);
      });
    });
  }
  // cv2 over the tile -> B2 (rows in tile order)
  {
    const Src src[1] = {{Xs, L.pX, 0, 0, a.c1}};
    passes(cp, [&](const float* Ws, int nlo, int nhi) {
      run_stage<1, 1>(Ws, a.c1 + PAD, src, G, nb, nb, a.th, a.tw, nlo, nhi, bias[1], ch,
                      [&](int, int m, int, int n, float v0, float v1) {
        store2(B2s + m * L.pA + n, act(v0, n, ch), act(v1, n + 1, ch));
      });
    });
  }
  // the bottlenecks; bottleneck j reads A on the slab less j pixels a side
  const bool add = a.shortcut != 0;
  for (int j = 0; j < nb; ++j) {
    {
      const Src src[1] = {{As, L.pA, 0, 0, cp}};
      passes(cp, [&](const float* Ws, int nlo, int nhi) {
        run_stage<1, 1>(Ws, cp + PAD, src, G, j, j, Sh - 2 * j, Sw - 2 * j, nlo, nhi,
                        bias[3 + 2 * j], ch,
                        [&](int p, int, int gp, int n, float v0, float v1) {
          store2(Bs + p * L.pA + n, gp >= 0 ? act(v0, n, ch) : 0.f,
                 gp >= 0 ? act(v1, n + 1, ch) : 0.f);
        });
      });
    }
    {
      const Src src[1] = {{Bs, L.pA, 0, 0, cp}};
      passes(cp, [&](const float* Ws, int nlo, int nhi) {
        // each (pixel, channel) of A is read and rewritten by one thread only
        run_stage<1, 9>(Ws, 9 * cp + PAD, src, G, j + 1, j + 1, Sh - 2 * j - 2,
                        Sw - 2 * j - 2, nlo, nhi, bias[4 + 2 * j], ch,
                        [&](int p, int, int gp, int n, float v0, float v1) {
          float* dst = As + p * L.pA + n;
          // pad channels: act gives 0 and A holds 0 there
          store2(dst, gp >= 0 ? act(v0, n, ch) + (add ? dst[0] : 0.f) : 0.f,
                 gp >= 0 ? act(v1, n + 1, ch) + (add ? dst[1] : 0.f) : 0.f);
        });
      });
    }
  }
  // cv3 as two split products: A (tile pixels) and cv2(x)
  {
    const Src src[2] = {{As, L.pA, 0, 0, cp}, {B2s, L.pA, 1, cp, cp}};
    float* y = static_cast<float*>(a.y) + (size_t)b * a.H * a.W * c2;
    passes(c2, [&](const float* Ws, int nlo, int nhi) {
      run_stage<2, 1>(Ws, 2 * cp + PAD, src, G, nb, nb, a.th, a.tw, nlo, nhi, bias[2], c2,
                      [&](int, int, int gp, int n, float v0, float v1) {
        if (gp >= 0) store2(y + (size_t)gp * c2 + n, act(v0, n, c2), act(v1, n + 1, c2));
      });
    });
  }
}

// with and without passes (the step logic costs the pass-free plans 2-3%,
// PERF.md)
template <bool PASSES>
__global__ void __launch_bounds__(NT) c3_tf32(C3Args a) {
  c3_body<PASSES>(a);
}

}  // namespace f32

// =============================================================== bfloat16
namespace bf {

using T = __nv_bfloat16;
constexpr int NT = 512, NW = NT / 32;   // one CTA of 16 warps an SM
constexpr int NCH = 32;   // output channels of a warp's work item (16 rows)
constexpr int PAD = 8;    // 16 bytes at the end of every row

struct Args {
  const T* w[3 + 2 * MAXNB];   // OHWI, in argument order (stage_w)
  const float* b[3 + 2 * MAXNB];
  T* y;
  int B, H, W, c1, ch, c2, nb, shortcut, th, tw, tiles_x, tiles_y;
};

// The weights of argument s: cv1, cv2, cv3 (two taps: A's columns, then
// cv2(x)'s), then per bottleneck its 1x1 and its 3x3; cp is c_ padded.
__device__ __forceinline__ WDesc<T> stage_w(const T* const* w, int s, int c1, int ch, int c2,
                                            int cp) {
  if (s < 2) return {w[s], ch, cp, 1, c1, c1};
  if (s == 2) return {w[2], c2, round16(c2), 2, ch, cp};
  return {w[s], ch, cp, s % 2 == 1 ? 1 : 9, ch, cp};
}

// Channels of one TMA box of x: the widest of 64, 32, 16 that divides c1
// (a row of 128, 64 or 32 bytes, the span of its swizzle).
__host__ __device__ inline int x_chunk(int c1) {
  return c1 % 64 == 0 ? 64 : c1 % 32 == 0 ? 32 : 16;
}

// Shared-memory layout in bf16 elements, from a 1024-byte aligned base (the
// dynamic allocation is 1024 bytes larger to allow it); the host, the
// device and ops/kernels/c3.py smem_bytes compute it the same way: x's
// slab (nchunk chunks of S rows of KC channels, each chunk rounded to 1024
// bytes), A's slab (rows of cp + 8), the 1x1's output on the slab
// sharing its space with y's staging tile (th*tw rows of c2 + 8), cv2's
// output on the tile (rows of cp + 8), then every stage's weights ([rows]
// [taps * cKp + 8]) in argument order: cv1, cv2 (cp rows of c1 + 8), cv3
// (c2 rows, 16-padded, of 2 cp + 8), each bottleneck's 1x1 (cp x (cp + 8))
// and 3x3 (cp x (9 cp + 8)).
struct Layout {
  int Sh, Sw, S, cp, kc, nchunk, xchunk, pA, pY, offA, offBs, offB2, offW, pW1, pW3, pWb1,
      pWb3, total;
  __host__ __device__ int w_cv(int s) const {   // cv1 (0), cv2 (1), cv3 (2)
    return offW + (s > 0 ? cp * pW1 : 0) + (s > 1 ? cp * pW1 : 0);
  }
  __host__ __device__ int w_b1(int j, int c2) const {   // bottleneck j's 1x1; its 3x3 follows
    return w_cv(2) + round16(c2) * pW3 + j * cp * (pWb1 + pWb3);
  }
};

__host__ __device__ inline Layout make_layout(int c1, int ch, int c2, int nb, int th, int tw) {
  Layout L;
  L.Sh = th + 2 * nb;
  L.Sw = tw + 2 * nb;
  L.S = L.Sh * L.Sw;
  L.cp = round16(ch);
  L.kc = x_chunk(c1);
  L.nchunk = c1 / L.kc;
  L.xchunk = (L.S * L.kc + 511) / 512 * 512;
  L.pA = L.cp + PAD;
  L.pY = c2 + PAD;
  L.offA = L.nchunk * L.xchunk;
  L.offBs = L.offA + L.S * L.pA;
  const int bs = L.S * L.pA, ys = th * tw * L.pY;
  L.offB2 = L.offBs + (bs > ys ? bs : ys);
  L.offW = L.offB2 + th * tw * L.pA;
  L.pW1 = c1 + PAD;
  L.pW3 = 2 * L.cp + PAD;
  L.pWb1 = L.cp + PAD;
  L.pWb3 = 9 * L.cp + PAD;
  L.total = L.w_b1(nb, c2);
  return L;
}

inline int smem_bytes(const Layout& L) { return L.total * 2 + 1024; }

// q = m / d by a multiply and a shift, exact for m < 16384 and d <= 128.
struct Div {
  unsigned mul;
  __device__ explicit Div(int d) : mul(((1u << 20) + d - 1) / d) {}
  __device__ __forceinline__ int operator()(int m) const {
    return static_cast<int>((static_cast<unsigned>(m) * mul) >> 20);
  }
};

// Where the tile lies in the image: slab pixel p -> image pixel, or -1
// outside the image.
struct TileGeo {
  int Sw, gy0, gx0, H, W;
  Div dsw;
  __device__ __forceinline__ int gpix(int p) const {
    const int r = dsw(p), gy = gy0 + r, gx = gx0 + p - r * Sw;
    return (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gy * W + gx : -1;
  }
};

// SiLU(v) = h + h tanh(h), h = v / 2: one MUFU op; SiLU(0) = 0 exactly, so
// channels past c_ (zero weights and bias) stay 0.
__device__ __forceinline__ float silu(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

__device__ __forceinline__ void store2(T* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// An operand of a stage: rows of a shared buffer, indexed by slab pixel
// (use_m 0) or by the rectangle's own row (use_m 1), K channels a tap,
// against weight columns kw0 + t * K .. for tap t.  A padded buffer holds
// element (r, k) at base + r * rowb + 2 k; x's slab (SWZ) holds it in chunk
// k >> kcs (cbytes apart) at base + r * rowb + ((((k >> 3) & jm) ^ sw(r))
// << 4), sw(r) = (r * rowb >> 7) & jm: rows of KC = 2^kcs channels under
// the TMA swizzle, jm = KC / 8 - 1.
struct Opnd {
  unsigned base;
  int rowb, use_m, kw0, K, cbytes, kcs, jm;
};

// A rectangle of the slab: rows r0 .. r0 + rh - 1, columns c0 .. c0 + rw - 1.
struct Rect {
  int r0, c0, rh, rw;
};

// out[m][n] = bias[n] + sum over sources and taps of
// A[row(m) + off(t)][k] * W[n][kw0 + t K + k] (bias 0 past nreal), for the
// rectangle's rows m and channels n < N.  Work items (16 rows x NCH
// channels) go to the warps round-robin from the phase's running count
// `item0`, so that the stages of one phase share the warps evenly.  A
// warp's K steps (sources x taps x K / 16) run as one loop whose
// fragments for the next step are loaded before this step's products.
// epi(p, m, gp, n, v0, v1) gets two neighbouring channels of row m (slab
// pixel p, image pixel gp or -1).  Every source has the same K; SWZ
// sources are x's slab, alone.
template <int TAPS, int NSRC, bool SWZ, class Epi>
__device__ __forceinline__ void gemm(const Opnd (&src)[NSRC], unsigned wsm, int pW,
                                     const TileGeo& G, const Rect& R, int N, const float* bias,
                                     int nreal, int& item0, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = (lane % 4) * 2, g = lane / 4;
  const int M = R.rh * R.rw, nnc = (N + NCH - 1) / NCH, items = (M + 15) / 16 * nnc;
  const Div drw(R.rw), dnc(nnc);
  auto pix = [&](int m) {
    const int r = drw(m);
    return (R.r0 + r) * G.Sw + R.c0 + m - r * R.rw;
  };
  const int K = src[0].K, KS = K / 16, nst = NSRC * TAPS;
  const int first = ((warp - item0) % NW + NW) % NW;
  item0 += items;
  for (int it = first; it < items; it += NW) {
    const int mt = dnc(it), n0 = (it - mt * nnc) * NCH;
    int ml = mt * 16 + lane % 16;   // ldmatrix rows (past M: row 0)
    ml = ml < M ? ml : 0;
    const int pl = pix(ml);
    const bool h0 = n0 + 8 < N, n1 = n0 + 16 < N, h1 = n0 + 24 < N;
    const unsigned wb = wsm + ((n0 + (lane / 16) * 8 + lane % 8) * pW + ((lane / 8) % 2) * 8) * 2;
    // the load cursor: (source, tap) st, K step kq, and their addresses
    int st = 0, kq = 0, ax = 0;
    unsigned ra = 0, wt = 0;
    auto at = [&](int s_t) {
      const int s = s_t / TAPS, t = s_t - s * TAPS;
      const Opnd& O0 = src[0];
      const Opnd& O1 = src[NSRC - 1];
      const bool one = NSRC > 1 && s > 0;   // field by field: no runtime index into src
      const int r = ((one ? O1.use_m : O0.use_m) ? ml : pl) + tap_off<TAPS>(t, G.Sw);
      const int rowb = one ? O1.rowb : O0.rowb;
      ra = (one ? O1.base : O0.base) + r * rowb;
      if (SWZ)
        ax = (r * rowb >> 7) & O0.jm;
      else
        ra += (lane / 16) * 16;
      wt = wb + ((one ? O1.kw0 : O0.kw0) + t * K) * 2;
    };
    uint32_t a[2][4], bf[2][2][4];
    auto load = [&](int k) {
      unsigned aa = ra + kq * 32;
      if (SWZ) {
        const int kk = kq * 16 + (lane / 16) * 8;
        aa = ra + (kk >> src[0].kcs) * src[0].cbytes + ((((kk >> 3) & src[0].jm) ^ ax) << 4);
      }
      ldsm_x4(a[k], aa);
      ldsm_x4(bf[k][0], wt + kq * 32);
      if (n1) ldsm_x4(bf[k][1], wt + kq * 32 + 32 * pW);
      if (++kq == KS) {
        kq = 0;
        if (++st < nst) at(st);
      }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    auto mmas = [&](int k) {
      mk::mma16816(acc[0], a[k], bf[k][0][0], bf[k][0][1]);
      if (h0) mk::mma16816(acc[1], a[k], bf[k][0][2], bf[k][0][3]);
      if (n1) {
        mk::mma16816(acc[2], a[k], bf[k][1][0], bf[k][1][1]);
        if (h1) mk::mma16816(acc[3], a[k], bf[k][1][2], bf[k][1][3]);
      }
    };
    at(0);
    load(0);
    const int steps = nst * KS;
    for (int i = 0; i < steps; i += 2) {
      const bool more = i + 1 < steps;
      if (more) load(1);
      mmas(0);
      if (more) {
        if (i + 2 < steps) load(0);
        mmas(1);
      }
    }
    float bv[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8 + q;
      bv[nt][0] = n < nreal ? __ldg(bias + n) : 0.f;
      bv[nt][1] = n + 1 < nreal ? __ldg(bias + n + 1) : 0.f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + half * 8;
      if (m >= M) continue;
      const int p = pix(m), gp = G.gpix(p);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (n0 + nt * 8 < N)
          epi(p, m, gp, n0 + nt * 8 + q, acc[nt][2 * half] + bv[nt][0],
              acc[nt][2 * half + 1] + bv[nt][1]);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
c3_bf16(const __grid_constant__ CUtensorMap xmap, const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full;
  // the swizzle pattern repeats every 1024 bytes: align the slabs to it
  T* sm = reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                               ~static_cast<uintptr_t>(1023));
  const Layout L = make_layout(a.c1, a.ch, a.c2, a.nb, a.th, a.tw);
  const int tid = threadIdx.x, nb = a.nb, ch = a.ch, c2 = a.c2, cp = L.cp;
  const int ntiles = a.B * a.tiles_y * a.tiles_x;
  T* As = sm + L.offA;
  T* Bs = sm + L.offBs;
  T* Ys = Bs;   // y's staging tile: the 1x1's output is dead once cv3 runs
  T* B2s = sm + L.offB2;
  const unsigned xbytes = L.nchunk * L.S * L.kc * 2;
  auto where = [&](int t, int& b, int& ty, int& tx) {
    tx = t % a.tiles_x;
    const int r = t / a.tiles_x;
    ty = r % a.tiles_y;
    b = r / a.tiles_y;
  };
  // one thread issues tile t's slab, a box a chunk
  auto issue = [&](int t) {
    int b, ty, tx;
    where(t, b, ty, tx);
    mk::mbar_expect_tx(&full, xbytes);
    for (int c = 0; c < L.nchunk; ++c)
      mk::tma_4d(sm + c * L.xchunk, &xmap, c * L.kc, tx * a.tw - nb, ty * a.th - nb, b, &full);
  };
  // writes tile t's y from its staging tile, 16 bytes a thread a step
  const int nv = c2 / 8, tpx = a.th * a.tw;
  const int m_step = NT / nv, c_step = NT - m_step * nv;
  const Div dtw(a.tw);
  auto write_y = [&](int t) {
    int b, ty, tx;
    where(t, b, ty, tx);
    const size_t img = (size_t)b * a.H * a.W;
    for (int m = tid / nv, c = tid - (tid / nv) * nv; m < tpx;) {
      const int r = dtw(m), gy = ty * a.th + r, gx = tx * a.tw + m - r * a.tw;
      if (gy < a.H && gx < a.W)
        *reinterpret_cast<uint4*>(a.y + (img + (size_t)gy * a.W + gx) * c2 + c * 8) =
            *reinterpret_cast<const uint4*>(Ys + m * L.pY + c * 8);
      m += m_step;
      c += c_step;
      if (c >= nv) {
        c -= nv;
        ++m;
      }
    }
  };

  if (tid == 0) {
    mk::mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && static_cast<int>(blockIdx.x) < ntiles) issue(blockIdx.x);
  // every stage's weights, once
  copy_w<T, NT>(sm + L.w_cv(0), PAD, stage_w(a.w, 0, a.c1, ch, c2, cp));
  copy_w<T, NT>(sm + L.w_cv(1), PAD, stage_w(a.w, 1, a.c1, ch, c2, cp));
  copy_w<T, NT>(sm + L.w_cv(2), PAD, stage_w(a.w, 2, a.c1, ch, c2, cp));
  for (int j = 0; j < nb; ++j) {
    copy_w<T, NT>(sm + L.w_b1(j, c2), PAD, stage_w(a.w, 3 + 2 * j, a.c1, ch, c2, cp));
    copy_w<T, NT>(sm + L.w_b1(j, c2) + cp * L.pWb1, PAD,
                  stage_w(a.w, 4 + 2 * j, a.c1, ch, c2, cp));
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const bool add = a.shortcut != 0;
  const unsigned w0 = saddr(sm + L.w_cv(0)), w1 = saddr(sm + L.w_cv(1)),
                 w2 = saddr(sm + L.w_cv(2)), wb0 = saddr(sm + L.w_b1(0, c2));
  const int wbj = cp * (L.pWb1 + L.pWb3) * 2, wb3 = cp * L.pWb1 * 2;   // bytes
  const Opnd pa = {saddr(As), L.pA * 2, 0, 0, cp, 0, 0, 0};     // A on the slab
  const Opnd pb = {saddr(Bs), L.pA * 2, 0, 0, cp, 0, 0, 0};     // the 1x1's output
  const Opnd pb2 = {saddr(B2s), L.pA * 2, 1, cp, cp, 0, 0, 0};  // cv2(x), tile rows
  int prev = -1;
  unsigned parity = 0;   // the phase of the slab's barrier
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int next = t + gridDim.x;
    mk::mbar_wait(&full, parity);
    parity ^= 1;
    int b, ty, tx;
    where(t, b, ty, tx);
    const TileGeo G{L.Sw, ty * a.th - nb, tx * a.tw - nb, a.H, a.W, Div(L.Sw)};
    const Opnd px = {saddr(sm), L.kc * 2, 0, 0, a.c1, L.xchunk * 2,
                     31 - __clz(L.kc), L.kc / 8 - 1};
    int item0 = 0;
    // phase 1: the last tile's y out; cv1 over the slab -> A (0 outside the
    // image), cv2 over the tile -> B2
    if (prev >= 0) write_y(prev);
    {
      const Opnd src[1] = {px};
      gemm<1, 1, true>(src, w0, L.pW1, G, Rect{0, 0, L.Sh, L.Sw}, cp, a.b[0], ch, item0,
                           [&](int p, int, int gp, int n, float v0, float v1) {
        store2(As + p * L.pA + n, gp >= 0 ? silu(v0) : 0.f, gp >= 0 ? silu(v1) : 0.f);
      });
      gemm<1, 1, true>(src, w1, L.pW1, G, Rect{nb, nb, a.th, a.tw}, cp, a.b[1], ch, item0,
                           [&](int, int m, int, int n, float v0, float v1) {
        store2(B2s + m * L.pA + n, silu(v0), silu(v1));
      });
    }
    __syncthreads();
    // the slab is read no more: the next tile's loads during the rest
    if (tid == 0 && next < ntiles) issue(next);
    // the bottlenecks; bottleneck j reads A on the slab less j pixels a side
    for (int j = 0; j < nb; ++j) {
      {
        const Opnd src[1] = {pa};
        gemm<1, 1, false>(src, wb0 + j * wbj, L.pWb1, G,
                              Rect{j, j, L.Sh - 2 * j, L.Sw - 2 * j}, cp, a.b[3 + 2 * j], ch,
                              item0, [&](int p, int, int gp, int n, float v0, float v1) {
          store2(Bs + p * L.pA + n, gp >= 0 ? silu(v0) : 0.f, gp >= 0 ? silu(v1) : 0.f);
        });
      }
      __syncthreads();
      {
        const Opnd src[1] = {pb};
        // each (pixel, channel) of A is read and rewritten by one thread only;
        // pad channels: silu gives 0 and A holds 0 there
        gemm<9, 1, false>(src, wb0 + j * wbj + wb3, L.pWb3, G,
                              Rect{j + 1, j + 1, L.Sh - 2 * j - 2, L.Sw - 2 * j - 2}, cp,
                              a.b[4 + 2 * j], ch, item0,
                              [&](int p, int, int gp, int n, float v0, float v1) {
          T* dst = As + p * L.pA + n;
          float r0 = 0.f, r1 = 0.f;
          if (add) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
            r0 = r.x;
            r1 = r.y;
          }
          store2(dst, gp >= 0 ? silu(v0) + r0 : 0.f, gp >= 0 ? silu(v1) + r1 : 0.f);
        });
      }
      __syncthreads();
    }
    // cv3 as two split products, A (tile pixels) and cv2(x) -> y's staging tile
    {
      const Opnd src[2] = {pa, pb2};
      gemm<1, 2, false>(src, w2, L.pW3, G, Rect{nb, nb, a.th, a.tw}, c2, a.b[2], c2, item0,
                            [&](int, int m, int, int n, float v0, float v1) {
        store2(Ys + m * L.pY + n, silu(v0), silu(v1));
      });
    }
    __syncthreads();
    prev = t;
  }
  if (prev >= 0) write_y(prev);
}

}  // namespace bf

// The dynamic shared-memory cap is raised to what the kernel's static
// shared memory leaves of SMEM_MAX, and the largest shared-memory carveout
// asked for, once per kernel and device, at its first launch (outside any
// CUDA-graph capture that later launches may run under).
int raise_smem_cap(const void* kern, int ki) {
  static std::mutex mu;
  static std::map<int, unsigned> cap_set;   // device -> bit ki set once raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  if (cap_set[dev] & (1u << ki)) return 0;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  cap_set[dev] |= 1u << ki;
  return 0;
}

}  // namespace

// Dynamic shared memory (bytes) of one CTA for these widths and tile:
// float32 with `nbuf` weight buffers of `rows` rows (0: a whole stage's);
// bfloat16 with one x slab and every stage's weights (nbuf, rows unused).
extern "C" int mk_c3_smem_bytes(int c1, int ch, int c2, int nb, int th, int tw,
                                int nbuf, int rows, int dtype) {
  if (dtype == DT_BF16) return bf::smem_bytes(bf::make_layout(c1, ch, c2, nb, th, tw));
  return f32::make_layout(c1, ch, c2, nb, th, tw, nbuf, rows).total * 4;
}

// x: (B, H, W, c1) NHWC; y: (B, H, W, c2); w: 3 + 2 * nb OHWI weights of
// x's dtype (cv1 (ch, 1, 1, c1), cv2 (ch, 1, 1, c1), cv3 (c2, 1, 1, 2 ch),
// then per bottleneck its 1x1 (ch, 1, 1, ch) and 3x3 (ch, 3, 3, ch));
// b: the matching float32 biases.  th x tw the tile; float32: nbuf weight
// buffers of `rows` rows, one CTA a tile; bfloat16: nbuf 1, rows 0 and
// `ctas` persistent CTAs.  The wrapper checks c1 % 16 == 0,
// ch % 8 == 0, c2 % 8 == 0, 1 <= nb <= 4, 16-byte aligned tensors and the
// shared-memory size.
extern "C" int mk_c3(const void* x, void* y, const void* const* w,
                     const float* const* b, int B, int H, int W, int c1, int ch,
                     int c2, int nb, int shortcut, int th, int tw, int nbuf, int rows,
                     int ctas, int dtype, void* stream) {
  if (nb < 1 || nb > MAXNB || (nbuf != 1 && nbuf != 2) || rows < 0 || rows % 16 ||
      (dtype == DT_BF16 && (nbuf != 1 || rows != 0 || ctas < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = mk_c3_smem_bytes(c1, ch, c2, nb, th, tw, nbuf, rows, dtype);
  // the bf16 form's mbarrier is static shared memory
  if (smem > SMEM_MAX - (dtype == DT_BF16 ? 8 : 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  if (dtype == DT_BF16) {
    bf::Args a;
    for (int i = 0; i < 3 + 2 * nb; ++i) {
      a.w[i] = static_cast<const bf::T*>(w[i]);
      a.b[i] = b[i];
    }
    a.y = static_cast<bf::T*>(y);
    a.B = B;
    a.H = H;
    a.W = W;
    a.c1 = c1;
    a.ch = ch;
    a.c2 = c2;
    a.nb = nb;
    a.shortcut = shortcut;
    a.th = th;
    a.tw = tw;
    a.tiles_x = tiles_x;
    a.tiles_y = tiles_y;
    int err = raise_smem_cap(reinterpret_cast<const void*>(bf::c3_bf16), 0);
    if (err) return err;
    mk::EncodeTiled encode = mk::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // x as (c1, W, H, B); a box is one chunk of channels of the slab
    const int kc = bf::x_chunk(c1), nb2 = 2 * nb;
    const cuuint64_t dim[4] = {(cuuint64_t)c1, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t stride[3] = {(cuuint64_t)c1 * 2, (cuuint64_t)W * c1 * 2,
                                  (cuuint64_t)H * W * c1 * 2};
    const cuuint32_t box[4] = {(cuuint32_t)kc, (cuuint32_t)(tw + nb2), (cuuint32_t)(th + nb2),
                               1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    CUtensorMap xmap;
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dim, stride,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, mk::swizzle_of(kc * 2),
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    bf::c3_bf16<<<ctas, bf::NT, smem, s>>>(xmap, a);
    return static_cast<int>(cudaGetLastError());
  }
  f32::C3Args a;
  for (int i = 0; i < 3 + 2 * nb; ++i) {
    a.w[i] = w[i];
    a.b[i] = b[i];
  }
  a.x = x;
  a.y = y;
  a.B = B;
  a.H = H;
  a.W = W;
  a.c1 = c1;
  a.ch = ch;
  a.c2 = c2;
  a.nb = nb;
  a.shortcut = shortcut;
  a.th = th;
  a.tw = tw;
  a.nbuf = nbuf;
  a.rows = rows;
  a.tiles_x = tiles_x;
  const bool passes = rows > 0;
  const void* kern = passes ? reinterpret_cast<const void*>(f32::c3_tf32<true>)
                            : reinterpret_cast<const void*>(f32::c3_tf32<false>);
  const int err = raise_smem_cap(kern, passes ? 2 : 1);
  if (err) return err;
  dim3 grid(tiles_x * tiles_y, B);
  if (passes)
    f32::c3_tf32<true><<<grid, f32::NT, smem, s>>>(a);
  else
    f32::c3_tf32<false><<<grid, f32::NT, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
