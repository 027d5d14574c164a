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
// Design: one CTA per th x tw output tile of one image.  It copies the input
// tile plus an n-pixel halo (n = number of bottlenecks) into shared memory
// once, recomputes the halo at every stage, and keeps every intermediate in
// shared memory; device memory sees one read of x and one write of y.  The
// 3 + 2n stages (cv1, cv2, each bottleneck's 1x1 and 3x3, cv3) each run as a
// small GEMM over a rectangle of the slab against that stage's weights,
// which cp.async copies into shared memory ([c_out][taps * c_in], zero
// padded) while the step before computes, where two weight buffers fit.  A
// float32 plan may run each stage in passes of 16 or 32 output channels,
// each over its own rows of weights: pspv5m's 3x3 (c_ 48) weights alone
// take 84 KB in float32, and passes of 32 let it take an 8x16 tile.
// ops/kernels/c3.py plan picks the tile, buffers and pass rows.
// Both types share one warp tiling: a warp's work item is a 16-pixel row
// tile by a chunk of output channels (32 for bf16 in a CTA of 8 warps, 16
// for float32 in a CTA of 16); ldmatrix feeds mma.sync, 32 bytes of K a
// step; the 3x3 is nine shifted row sets of the same buffer.  Row pitches
// are odd multiples of 16 bytes (a row plus 16 bytes), so the eight rows of
// an ldmatrix fall in different banks, and every copy moves 16-byte chunks.
// The bottleneck 1x1's output shares x's rows where it fits (c_ <= c1): x
// is read for the last time by cv2.
//   * bfloat16 (c3_bf16): mma.sync m16n8k16, bf16 in, fp32 accumulate.  c_
//     is padded to a multiple of 16 with zero weights and biases, so the
//     pad channels hold SiLU(0) = 0;
//   * float32 (c3_tf32): 3xTF32 on mma.sync m16n8k8.  Each float32 operand
//     splits in registers after its ldmatrix into x = hi + lo, hi =
//     tf32_rna(x), lo = tf32_rna(x - hi) (common.cuh), and a * w is summed
//     as a_lo w_hi + a_hi w_lo + a_hi w_hi (a_lo w_lo, ~2^-22 of it,
//     dropped).  x and every intermediate are float32, so every product
//     takes three.  The tensor core truncates each mma's sum toward zero, so
//     each k8 step sums into a fresh accumulator that the float32 sum takes
//     by FADD, rounded to nearest (as K1's stem_tf32).  c_ is padded to a
//     multiple of 8 (the k8 step), weight rows to 16 (a B ldmatrix loads
//     two n8 tiles).  The 16-warp CTA and the 16x16 tile, against 8 warps
//     and 8x16, took eval's shape from 0.51 to 0.32 ms (PERF.md): with one
//     CTA an SM, the stages' barriers and epilogues left 8 warps idle.
//
// What bounds it on an H100: at pspv5s's bs8 1024x1024 serving shape
// (8, 256, 256, 64), c_ 32, the function reads and writes 134 MB (0.040 ms
// at 3.35 TB/s) and does 19.3 GFLOP (0.0195 ms on the bf16 tensor cores):
// bytes-bound.  At eval's float32 (4, 128, 256, 64) it moves 67.1 MB
// (0.0200 ms) and does 4.83 GFLOP, three TF32 products a MAC: 0.0293 ms at
// 495 TFLOP/s, operations-bound (0.0721 ms as float32 on the CUDA cores).
// This form recomputes the halo (1.27x on a 16x16 tile at n = 1),
// synchronises the CTA between steps, runs mma.sync rather than wgmma and,
// in float32, splits every fragment and flushes every k8 step on the CUDA
// cores, so it sits well above those bounds; TMA, wgmma and a persistent
// pipelined CTA are later work.
#include "common.cuh"

namespace {

// Threads of a CTA and output channels of a warp's work item, by type
template <typename T> struct Form;
template <> struct Form<__nv_bfloat16> { static constexpr int NT = 256, NCH = 32; };
template <> struct Form<float> { static constexpr int NT = 512, NCH = 16; };
constexpr int MAXNB = 4;
constexpr int SMEM_MAX = 227 * 1024;   // the most dynamic shared memory a CTA may have

struct C3Args {
  const void* w[3 + 2 * MAXNB];   // OHWI: cv1, cv2, cv3, then m.j.cv1 (1x1), m.j.cv2 (3x3)
  const float* b[3 + 2 * MAXNB];
  const void* x;
  void* y;
  int B, H, W, c1, ch, c2, nb, shortcut, th, tw, nbuf, rows, tiles_x;
};

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout in elements of `es` bytes (2 bf16, 4 float32); the
// host, the device and ops/kernels/c3.py smem_bytes compute it the same way.
// A weight buffer holds `rows` rows of a stage (0: all of them).
struct Layout {
  int Sh, Sw, S, cp, pX, pA, offA, offB, offB2, offW, wsize, total;
};

__host__ __device__ inline int min_rows(int n, int rows) { return rows > 0 && rows < n ? rows : n; }

__host__ __device__ inline Layout make_layout(int c1, int ch, int c2, int nb, int th,
                                              int tw, int nbuf, int rows, int es) {
  const int pad = 16 / es;
  Layout L;
  L.Sh = th + 2 * nb;
  L.Sw = tw + 2 * nb;
  L.S = L.Sh * L.Sw;
  L.cp = es == 2 ? round16(ch) : round8(ch);
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
// chunks (cK and cKp are multiples of 8).
template <typename T>
struct WDesc {
  const T* g;
  int n_real, n_rows, taps, cK, cKp;
};

template <typename T>
__device__ void copy_w(T* Ws, int pad, const WDesc<T>& d) {
  constexpr int VEC = 16 / sizeof(T);
  const int pW = d.taps * d.cKp + pad;
  const int per = d.taps * d.cKp / VEC;
  for (int i = threadIdx.x; i < d.n_rows * per; i += Form<T>::NT) {
    const int n = i / per, r = (i - n * per) * VEC;
    const int t = r / d.cKp, k = r - t * d.cKp;
    const bool ok = n < d.n_real && k < d.cK;
    cp_async16(Ws + n * pW + r, ok ? d.g + ((size_t)n * d.taps + t) * d.cK + k : d.g, ok);
  }
}

// The input tile, in 16-byte chunks (c1 % 16 == 0).
template <typename T>
__device__ void copy_x(T* Xs, const C3Args& a, const Layout& L, int b, int gy0, int gx0) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = a.c1 / VEC;
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < L.S * nv; i += Form<T>::NT) {
    const int pix = i / nv, cv = (i - pix * nv) * VEC;
    const int gy = gy0 + pix / L.Sw, gx = gx0 + pix % L.Sw;
    const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    cp_async16(Xs + pix * L.pX + cv,
               ok ? x + (((size_t)b * a.H + gy) * a.W + gx) * a.c1 + cv : x, ok);
  }
}

// ------------------------------------------------------------ stage GEMMs
// Where the tile lies in the image: slab pixel p -> image pixel, or -1
// outside the image.
struct Geo {
  int Sw, gy0, gx0, H, W;
  __device__ __forceinline__ int gpix(int p) const {
    const int gy = gy0 + p / Sw, gx = gx0 + p % Sw;
    return (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gy * W + gx : -1;
  }
};

// One operand of a stage: rows of buffer A (pitch pA) indexed by slab pixel
// (use_m 0) or by the rectangle's own row index (use_m 1), K channels a tap,
// against weight columns kw0 + t * K .. for tap t.
template <typename T>
struct Src {
  const T* A;
  int pA, use_m, kw0, K;
};

// A 3x3 tap's pixel offset on the slab (TAPS 9), or 0 (TAPS 1).
template <int TAPS>
__device__ __forceinline__ int tap_off(int t, int Sw) {
  return TAPS == 1 ? 0 : (t / 3 - 1) * Sw + (t % 3 - 1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A stage's output channels nlo .. nhi - 1 over the rectangle (r0, c0, rh,
// rw) of the slab: out[m][n] = bias[n] + sum over sources and taps of
// A[row(m) + off(t)][k] * W[n - nlo][kw0 + t K + k] (bias 0 past nreal).
// epi(p, m, gp, n, v0, v1) gets two neighbouring channels of row m (slab
// pixel p, image pixel gp or -1).  A K step is 32 bytes of a row: 16 bf16
// values (m16n8k16) or 8 float32 (m16n8k8), so the ldmatrix addressing is
// the same in bytes for both types; an ldmatrix of float32 rows gives tf32
// fragments (common.cuh mk::ldsm_x4).
template <typename T, int NSRC, int TAPS, class Epi>
__device__ __forceinline__ void run_stage(const T* Ws, int pW, const Src<T> (&src)[NSRC],
                                          const Geo& G, int r0, int c0, int rh, int rw, int nlo,
                                          int nhi, const float* bias, int nreal, Epi epi) {
  constexpr int ES = sizeof(T), V = 16 / ES;   // bytes an element; elements in 16 bytes
  constexpr int NCH = Form<T>::NCH, NWARPS = Form<T>::NT / 32;
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
      const Src<T>& S = src[s];
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
          if constexpr (ES == 2) {
#pragma unroll
            for (int np = 0; np < NCH / 16; ++np) {
              if (n0 + np * 16 < N) {
                uint32_t bf[4];
                ldsm_x4(bf, b_t + np * 16 * pW * ES + k0 * ES);
                mma_bf16(acc[2 * np], a, bf[0], bf[1]);
                if (n0 + np * 16 + 8 < N) mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
              }
            }
          } else {
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

template <typename T>
__device__ __forceinline__ void store2(T* dst, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// SiLU with the fast exponential (ex2.approx): within a few float32 ulps
// of expf's, far inside the kernel's bounds against its plain version.  The
// float32 form also divides by the fast reciprocal (__fdividef, 2 ulps; it
// gives 0 where 1 + e^-v passes 2^126, SiLU's limit there): the IEEE
// division's slow-path branches held a fifth of its time (PERF.md).
template <typename T>
__device__ __forceinline__ float silu_fast(float v) { return v / (1.0f + __expf(-v)); }
template <>
__device__ __forceinline__ float silu_fast<float>(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

template <typename T, bool PASSES>
__device__ __forceinline__ void c3_body(const C3Args& a) {
  constexpr int PAD = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int R = PASSES ? a.rows : 0;   // weight rows a pass (0: a pass is a whole stage)
  const Layout L = make_layout(a.c1, a.ch, a.c2, a.nb, a.th, a.tw, a.nbuf, R, sizeof(T));
  T* Xs = sm;
  T* As = sm + L.offA;
  T* Bs = sm + L.offB;
  T* B2s = sm + L.offB2;
  const int b = blockIdx.y;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int nb = a.nb, cp = L.cp, Sw = L.Sw, Sh = L.Sh, ch = a.ch, c2 = a.c2;
  const Geo G{Sw, ty * a.th - nb, tx * a.tw - nb, a.H, a.W};   // slab (0, 0) in the image
  const T* const* w = reinterpret_cast<const T* const*>(a.w);
  const float* const* bias = a.b;

  // the stages' weights, in stage order: cv1, cv2, (1x1, 3x3) per
  // bottleneck, cv3.  A stage runs in passes of R output channels (all of
  // them where R is 0), each over its own rows of weights: a step is one
  // pass of one stage.  Without PASSES this folds away at compile time.
  const int nst = 3 + 2 * nb;
  auto desc = [&](int s) -> WDesc<T> {
    const int rows = round16(cp);
    if (s < 2) return {w[s], ch, rows, 1, a.c1, a.c1};
    if (s == nst - 1) return {w[2], c2, round16(c2), 2, ch, cp};
    return (s % 2 == 0) ? WDesc<T>{w[s + 1], ch, rows, 1, ch, cp}
                        : WDesc<T>{w[s + 1], ch, rows, 9, ch, cp};
  };
  auto npass = [&](int s) {
    const int r = round16(s == nst - 1 ? c2 : cp);
    return R > 0 ? (r + R - 1) / R : 1;
  };
  auto step_desc = [&](int s, int p) {
    WDesc<T> d = desc(s);
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
  auto begin = [&]() -> T* {
    cp_async_wait_all();
    __syncthreads();
    int s = st, p = ps;
    next(s, p);
    if (a.nbuf == 2 && s < nst) {
      copy_w(wbuf(step + 1), PAD, step_desc(s, p));
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
      copy_w(wbuf(step + 1), PAD, step_desc(s, p));
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
    return n < nreal ? silu_fast<T>(v) : 0.f;
  };

  copy_x(Xs, a, L, b, G.gy0, G.gx0);
  copy_w(wbuf(0), PAD, step_desc(0, 0));
  cp_async_commit();

  // cv1 over the whole slab -> A, masked outside the image
  {
    const Src<T> src[1] = {{Xs, L.pX, 0, 0, a.c1}};
    passes(cp, [&](const T* Ws, int nlo, int nhi) {
      run_stage<T, 1, 1>(Ws, a.c1 + PAD, src, G, 0, 0, Sh, Sw, nlo, nhi, bias[0], ch,
                         [&](int p, int, int gp, int n, float v0, float v1) {
        store2(As + p * L.pA + n, gp >= 0 ? act(v0, n, ch) : 0.f,
               gp >= 0 ? act(v1, n + 1, ch) : 0.f);
      });
    });
  }
  // cv2 over the tile -> B2 (rows in tile order)
  {
    const Src<T> src[1] = {{Xs, L.pX, 0, 0, a.c1}};
    passes(cp, [&](const T* Ws, int nlo, int nhi) {
      run_stage<T, 1, 1>(Ws, a.c1 + PAD, src, G, nb, nb, a.th, a.tw, nlo, nhi, bias[1], ch,
                         [&](int, int m, int, int n, float v0, float v1) {
        store2(B2s + m * L.pA + n, act(v0, n, ch), act(v1, n + 1, ch));
      });
    });
  }
  // the bottlenecks; bottleneck j reads A on the slab less j pixels a side
  const bool add = a.shortcut != 0;
  for (int j = 0; j < nb; ++j) {
    {
      const Src<T> src[1] = {{As, L.pA, 0, 0, cp}};
      passes(cp, [&](const T* Ws, int nlo, int nhi) {
        run_stage<T, 1, 1>(Ws, cp + PAD, src, G, j, j, Sh - 2 * j, Sw - 2 * j, nlo, nhi,
                           bias[3 + 2 * j], ch,
                           [&](int p, int, int gp, int n, float v0, float v1) {
          store2(Bs + p * L.pA + n, gp >= 0 ? act(v0, n, ch) : 0.f,
                 gp >= 0 ? act(v1, n + 1, ch) : 0.f);
        });
      });
    }
    {
      const Src<T> src[1] = {{Bs, L.pA, 0, 0, cp}};
      passes(cp, [&](const T* Ws, int nlo, int nhi) {
        // each (pixel, channel) of A is read and rewritten by one thread only
        run_stage<T, 1, 9>(Ws, 9 * cp + PAD, src, G, j + 1, j + 1, Sh - 2 * j - 2,
                           Sw - 2 * j - 2, nlo, nhi, bias[4 + 2 * j], ch,
                           [&](int p, int, int gp, int n, float v0, float v1) {
          T* dst = As + p * L.pA + n;
          // pad channels: act gives 0 and A holds 0 there
          store2(dst, gp >= 0 ? act(v0, n, ch) + (add ? to_f(dst[0]) : 0.f) : 0.f,
                 gp >= 0 ? act(v1, n + 1, ch) + (add ? to_f(dst[1]) : 0.f) : 0.f);
        });
      });
    }
  }
  // cv3 as two split products: A (tile pixels) and cv2(x)
  {
    const Src<T> src[2] = {{As, L.pA, 0, 0, cp}, {B2s, L.pA, 1, cp, cp}};
    T* y = static_cast<T*>(a.y) + (size_t)b * a.H * a.W * c2;
    passes(c2, [&](const T* Ws, int nlo, int nhi) {
      run_stage<T, 2, 1>(Ws, 2 * cp + PAD, src, G, nb, nb, a.th, a.tw, nlo, nhi, bias[2], c2,
                         [&](int, int, int gp, int n, float v0, float v1) {
        if (gp >= 0) store2(y + (size_t)gp * c2 + n, act(v0, n, c2), act(v1, n + 1, c2));
      });
    });
  }
}

// The two forms, each under a symbol of its own; the float32 form with and
// without passes (the step logic costs the pass-free plans 2-3%, PERF.md).
__global__ void __launch_bounds__(Form<__nv_bfloat16>::NT) c3_bf16(C3Args a) {
  c3_body<__nv_bfloat16, false>(a);
}
template <bool PASSES>
__global__ void __launch_bounds__(Form<float>::NT) c3_tf32(C3Args a) {
  c3_body<float, PASSES>(a);
}

}  // namespace

// Dynamic shared memory (bytes) of one CTA for these widths, tile and
// number of weight buffers (2: the next stage's weights load during this one).
extern "C" int mk_c3_smem_bytes(int c1, int ch, int c2, int nb, int th, int tw,
                                int nbuf, int rows, int dtype) {
  const int es = dtype == DT_BF16 ? 2 : 4;
  return make_layout(c1, ch, c2, nb, th, tw, nbuf, rows, es).total * es;
}

// x: (B, H, W, c1) NHWC; y: (B, H, W, c2); w: 3 + 2 * nb OHWI weights of
// x's dtype (cv1 (ch, 1, 1, c1), cv2 (ch, 1, 1, c1), cv3 (c2, 1, 1, 2 ch),
// then per bottleneck its 1x1 (ch, 1, 1, ch) and 3x3 (ch, 3, 3, ch));
// b: the matching float32 biases.  The wrapper checks c1 % 16 == 0,
// ch % 8 == 0, c2 % 8 == 0, 1 <= nb <= 4, 16-byte aligned tensors and the
// shared-memory size.
extern "C" int mk_c3(const void* x, void* y, const void* const* w,
                     const float* const* b, int B, int H, int W, int c1, int ch,
                     int c2, int nb, int shortcut, int th, int tw, int nbuf, int rows,
                     int dtype, void* stream) {
  if (nb < 1 || nb > MAXNB || (nbuf != 1 && nbuf != 2) || rows < 0 || rows % 16 ||
      (dtype == DT_BF16 && rows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  C3Args a;
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
  a.tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const int smem = mk_c3_smem_bytes(c1, ch, c2, nb, th, tw, nbuf, rows, dtype);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // raise the dynamic shared-memory cap once per kernel, at the first launch
  // (outside any CUDA-graph capture that later launches may run under); the
  // float32 form also asks for the largest shared-memory carveout
  static bool cap_set[3] = {false, false, false};
  const int ki = dtype == DT_BF16 ? 0 : rows > 0 ? 2 : 1;
  const void* kern = ki == 0 ? reinterpret_cast<const void*>(c3_bf16)
                     : ki == 1 ? reinterpret_cast<const void*>(c3_tf32<false>)
                               : reinterpret_cast<const void*>(c3_tf32<true>);
  if (!cap_set[ki]) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess && ki > 0)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap_set[ki] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(a.tiles_x * tiles_y, B);
  if (ki == 0)
    c3_bf16<<<grid, Form<__nv_bfloat16>::NT, smem, s>>>(a);
  else if (ki == 1)
    c3_tf32<false><<<grid, Form<float>::NT, smem, s>>>(a);
  else
    c3_tf32<true><<<grid, Form<float>::NT, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
