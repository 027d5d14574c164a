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
// padded) while the stage before computes, where two weight buffers fit:
//   * bfloat16: each warp takes 16-pixel row tiles and 32-channel column
//     chunks; ldmatrix feeds mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//     the 3x3 is nine shifted row sets of the same buffer.  c_ is padded to
//     a multiple of 16 with zero weights and biases, so the pad channels
//     hold SiLU(0) = 0.  Row pitches are odd multiples of 16 bytes, so the
//     eight rows of an ldmatrix fall in different banks;
//   * float32: each thread a 4x4 register tile on the CUDA cores, no TF32.
//
// What bounds it on an H100: at pspv5s's bs8 1024x1024 serving shape
// (8, 256, 256, 64), c_ 32, the function reads and writes 134 MB (0.040 ms
// at 3.35 TB/s) and does 19.3 GFLOP (0.0195 ms on the bf16 tensor cores):
// bytes-bound.  This form recomputes a 1.4x halo, synchronises the CTA
// between stages and runs mma.sync rather than wgmma, so it sits well
// above that bound; TMA, wgmma and a persistent pipelined CTA are later work.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int MAXNB = 4;
constexpr int SMEM_MAX = 227 * 1024;   // the most dynamic shared memory a CTA may have

struct C3Args {
  const void* w[3 + 2 * MAXNB];   // OHWI: cv1, cv2, cv3, then m.j.cv1 (1x1), m.j.cv2 (3x3)
  const float* b[3 + 2 * MAXNB];
  const void* x;
  void* y;
  int B, H, W, c1, ch, c2, nb, shortcut, th, tw, nbuf, tiles_x;
};

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout in elements; the host and the device compute it the same way.
struct Layout {
  int Sh, Sw, S, cp, pX, pA, offA, offB, offB2, offW, wsize, total;
};

__host__ __device__ inline Layout make_layout(int c1, int ch, int c2, int nb, int th,
                                              int tw, int nbuf, int pad) {
  Layout L;
  L.Sh = th + 2 * nb;
  L.Sw = tw + 2 * nb;
  L.S = L.Sh * L.Sw;
  L.cp = round16(ch);
  L.pX = c1 + pad;
  L.pA = L.cp + pad;
  int w_max = L.cp * (c1 + pad);
  const int w3 = round16(c2) * (2 * L.cp + pad), w33 = L.cp * (9 * L.cp + pad);
  w_max = w3 > w_max ? w3 : w_max;
  w_max = w33 > w_max ? w33 : w_max;
  L.offA = round8(L.S * L.pX);
  L.offB = L.offA + round8(L.S * L.pA);
  L.offB2 = L.offB + round8(L.S * L.pA);
  L.offW = L.offB2 + round8(th * tw * L.pA);
  L.wsize = round8(w_max);
  L.total = L.offW + nbuf * L.wsize;
  return L;
}

// ----------------------------------------------------------- async copies
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  // zero-fills when `valid` is false (src-size 0 reads nothing)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// One stage's weights: global [n_real][taps][cK] -> shared
// [n_rows][taps * cKp + pad], zero where n >= n_real or k >= cK.  bfloat16
// moves 16-byte chunks (cK % 8 == 0), float32 single values.
template <typename T>
struct WDesc {
  const T* g;
  int n_real, n_rows, taps, cK, cKp;
};

template <typename T>
__device__ void copy_w(T* Ws, int pad, const WDesc<T>& d) {
  constexpr int VEC = sizeof(T) == 2 ? 8 : 1;
  const int pW = d.taps * d.cKp + pad;
  const int per = d.taps * d.cKp / VEC;
  for (int i = threadIdx.x; i < d.n_rows * per; i += NT) {
    const int n = i / per, r = (i - n * per) * VEC;
    const int t = r / d.cKp, k = r - t * d.cKp;
    const bool ok = n < d.n_real && k < d.cK;
    cp_async<VEC * sizeof(T)>(Ws + n * pW + r,
                              ok ? d.g + ((size_t)n * d.taps + t) * d.cK + k : d.g, ok);
  }
}

// The input tile: bfloat16 in 16-byte chunks, float32 single values (the
// float32 row pitch c1 + 1 is not a multiple of 16 bytes).
template <typename T>
__device__ void copy_x(T* Xs, const C3Args& a, const Layout& L, int b, int gy0, int gx0) {
  constexpr int VEC = sizeof(T) == 2 ? 8 : 1;
  const int nv = a.c1 / VEC;
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < L.S * nv; i += NT) {
    const int pix = i / nv, cv = (i - pix * nv) * VEC;
    const int gy = gy0 + pix / L.Sw, gx = gx0 + pix % L.Sw;
    const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    cp_async<VEC * sizeof(T)>(Xs + pix * L.pX + cv,
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

// A stage over the rectangle (r0, c0, rh, rw) of the slab with N output
// channels: out[m][n] = sum over sources and taps of A[row(m) + off(t)][k] *
// W[n][kw0 + t K + k].  epi(p, m, gp, n, v0, v1) gets two neighbouring
// channels of row m (slab pixel p, image pixel gp or -1).
template <int NSRC, int TAPS, class Epi>
__device__ __forceinline__ void run_stage(const __nv_bfloat16* Ws, int pW,
                                          const Src<__nv_bfloat16> (&src)[NSRC], const Geo& G,
                                          int r0, int c0, int rh, int rw, int N, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = (lane % 4) * 2, g = lane / 4;
  const int M = rh * rw, nmt = (M + 15) / 16;
  auto pix = [&](int m) { return (r0 + m / rw) * G.Sw + c0 + m % rw; };
  for (int mt = warp; mt < nmt; mt += NWARPS) {
    // ldmatrix rows: lane % 16 of the tile (rows past M read row 0)
    int ml = mt * 16 + lane % 16;
    ml = ml < M ? ml : 0;
    const int pl = pix(ml);
    const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
    const int p_lo = m_lo < M ? pix(m_lo) : 0, p_hi = m_hi < M ? pix(m_hi) : 0;
    const int gp_lo = G.gpix(p_lo), gp_hi = G.gpix(p_hi);
    for (int n0 = 0; n0 < N; n0 += 32) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int s = 0; s < NSRC; ++s) {
        const Src<__nv_bfloat16>& S = src[s];
        const unsigned a_base = saddr(S.A + (S.use_m ? ml : pl) * S.pA + (lane / 16) * 8);
        const unsigned b_base = saddr(Ws + (n0 + (lane / 16) * 8 + lane % 8) * pW + S.kw0 +
                                      ((lane / 8) % 2) * 8);
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const unsigned a_t = a_base + tap_off<TAPS>(t, G.Sw) * S.pA * 2;
          const unsigned b_t = b_base + t * S.K * 2;
          for (int k0 = 0; k0 < S.K; k0 += 16) {
            uint32_t a[4];
            ldsm_x4(a, a_t + k0 * 2);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              if (n0 + np * 16 < N) {
                uint32_t bf[4];
                ldsm_x4(bf, b_t + np * 16 * pW * 2 + k0 * 2);
                mma_bf16(acc[2 * np], a, bf[0], bf[1]);
                if (n0 + np * 16 + 8 < N) mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + nt * 8 + q;
        if (n0 + nt * 8 >= N) continue;
        if (m_lo < M) epi(p_lo, m_lo, gp_lo, n, acc[nt][0], acc[nt][1]);
        if (m_hi < M) epi(p_hi, m_hi, gp_hi, n, acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// The same stage in float32: each thread a 4-row x 4-channel register tile.
template <int NSRC, int TAPS, class Epi>
__device__ __forceinline__ void run_stage(const float* Ws, int pW,
                                          const Src<float> (&src)[NSRC], const Geo& G,
                                          int r0, int c0, int rh, int rw, int N, Epi epi) {
  const int M = rh * rw, nmb = (M + 3) / 4, nnb = N / 4;
  for (int it = threadIdx.x; it < nmb * nnb; it += NT) {
    const int mb = it / nnb, n0 = (it - mb * nnb) * 4;
    int m[4], p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = mb * 4 + i;
      const int mc = m[i] < M ? m[i] : 0;
      p[i] = (r0 + mc / rw) * G.Sw + c0 + mc % rw;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < NSRC; ++s) {
      const Src<float>& S = src[s];
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const float* ar[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ar[i] = S.A + ((S.use_m ? (m[i] < M ? m[i] : 0) : p[i]) + tap_off<TAPS>(t, G.Sw)) * S.pA;
        const float* wr = Ws + n0 * pW + S.kw0 + t * S.K;
        for (int k = 0; k < S.K; ++k) {
          float av[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = ar[i][k];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = wr[j * pW + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m[i] >= M) continue;
      const int gp = G.gpix(p[i]);
      epi(p[i], m[i], gp, n0, acc[i][0], acc[i][1]);
      epi(p[i], m[i], gp, n0 + 2, acc[i][2], acc[i][3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float v0, float v1) {
  dst[0] = v0;
  dst[1] = v1;
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// SiLU with the fast exponential (ex2.approx): within a few float32 ulps
// of expf's, far inside the kernel's bounds against its plain version.
__device__ __forceinline__ float silu_fast(float v) { return v / (1.0f + __expf(-v)); }

template <typename T>
__global__ void __launch_bounds__(NT) c3_kernel(C3Args a) {
  constexpr int PAD = sizeof(T) == 2 ? 8 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Layout L = make_layout(a.c1, a.ch, a.c2, a.nb, a.th, a.tw, a.nbuf, PAD);
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

  // the stages' weights, in stage order: cv1, cv2, (1x1, 3x3) per bottleneck, cv3
  const int nst = 3 + 2 * nb;
  auto desc = [&](int s) -> WDesc<T> {
    if (s < 2) return {w[s], ch, cp, 1, a.c1, a.c1};
    if (s == nst - 1) return {w[2], c2, round16(c2), 2, ch, cp};
    return (s % 2 == 0) ? WDesc<T>{w[s + 1], ch, cp, 1, ch, cp}
                        : WDesc<T>{w[s + 1], ch, cp, 9, ch, cp};
  };
  auto wbuf = [&](int s) { return sm + L.offW + (a.nbuf == 2 ? (s & 1) * L.wsize : 0); };
  int stage = 0;
  // waits for this stage's weights (and the last stage's outputs), then
  // starts copying the next stage's weights into the other buffer
  auto begin = [&]() -> T* {
    cp_async_wait_all();
    __syncthreads();
    if (a.nbuf == 2 && stage + 1 < nst) {
      copy_w(wbuf(stage + 1), PAD, desc(stage + 1));
      cp_async_commit();
    }
    return wbuf(stage);
  };
  // with one buffer, the next stage's weights are copied once this one is done
  auto end = [&]() {
    if (a.nbuf == 1 && stage + 1 < nst) {
      __syncthreads();
      copy_w(wbuf(stage + 1), PAD, desc(stage + 1));
      cp_async_commit();
    }
    ++stage;
  };
  auto act = [&](float v, int bi, int n, int nreal) {   // SiLU(v + bias), 0 on pad channels
    return n < nreal ? silu_fast(v + bias[bi][n]) : 0.f;
  };

  copy_x(Xs, a, L, b, G.gy0, G.gx0);
  copy_w(wbuf(0), PAD, desc(0));
  cp_async_commit();

  // cv1 over the whole slab -> A, masked outside the image
  {
    const T* Ws = begin();
    const Src<T> src[1] = {{Xs, L.pX, 0, 0, a.c1}};
    run_stage<1, 1>(Ws, a.c1 + PAD, src, G, 0, 0, Sh, Sw, cp,
                    [&](int p, int, int gp, int n, float v0, float v1) {
      store2(As + p * L.pA + n, gp >= 0 ? act(v0, 0, n, ch) : 0.f,
             gp >= 0 ? act(v1, 0, n + 1, ch) : 0.f);
    });
    end();
  }
  // cv2 over the tile -> B2 (rows in tile order)
  {
    const T* Ws = begin();
    const Src<T> src[1] = {{Xs, L.pX, 0, 0, a.c1}};
    run_stage<1, 1>(Ws, a.c1 + PAD, src, G, nb, nb, a.th, a.tw, cp,
                    [&](int, int m, int, int n, float v0, float v1) {
      store2(B2s + m * L.pA + n, act(v0, 1, n, ch), act(v1, 1, n + 1, ch));
    });
    end();
  }
  // the bottlenecks; bottleneck j reads A on the slab less j pixels a side
  const bool add = a.shortcut != 0;
  for (int j = 0; j < nb; ++j) {
    {
      const T* Ws = begin();
      const Src<T> src[1] = {{As, L.pA, 0, 0, cp}};
      run_stage<1, 1>(Ws, cp + PAD, src, G, j, j, Sh - 2 * j, Sw - 2 * j, cp,
                      [&](int p, int, int gp, int n, float v0, float v1) {
        store2(Bs + p * L.pA + n, gp >= 0 ? act(v0, 3 + 2 * j, n, ch) : 0.f,
               gp >= 0 ? act(v1, 3 + 2 * j, n + 1, ch) : 0.f);
      });
      end();
    }
    {
      const T* Ws = begin();
      const Src<T> src[1] = {{Bs, L.pA, 0, 0, cp}};
      // each (pixel, channel) of A is read and rewritten by one thread only
      run_stage<1, 9>(Ws, 9 * cp + PAD, src, G, j + 1, j + 1, Sh - 2 * j - 2,
                      Sw - 2 * j - 2, cp, [&](int p, int, int gp, int n, float v0, float v1) {
        T* dst = As + p * L.pA + n;
        const int bi = 4 + 2 * j;
        // pad channels: act gives 0 and A holds 0 there
        store2(dst, gp >= 0 ? act(v0, bi, n, ch) + (add ? to_f(dst[0]) : 0.f) : 0.f,
               gp >= 0 ? act(v1, bi, n + 1, ch) + (add ? to_f(dst[1]) : 0.f) : 0.f);
      });
      end();
    }
  }
  // cv3 as two split products: A (tile pixels) and cv2(x)
  {
    const T* Ws = begin();
    const Src<T> src[2] = {{As, L.pA, 0, 0, cp}, {B2s, L.pA, 1, cp, cp}};
    T* y = static_cast<T*>(a.y) + (size_t)b * a.H * a.W * c2;
    run_stage<2, 1>(Ws, 2 * cp + PAD, src, G, nb, nb, a.th, a.tw, c2,
                    [&](int, int, int gp, int n, float v0, float v1) {
      if (gp >= 0) store2(y + (size_t)gp * c2 + n, act(v0, 2, n, c2), act(v1, 2, n + 1, c2));
    });
    end();
  }
}

}  // namespace

// Dynamic shared memory (bytes) of one CTA for these widths, tile and
// number of weight buffers (2: the next stage's weights load during this one).
extern "C" int mk_c3_smem_bytes(int c1, int ch, int c2, int nb, int th, int tw,
                                int nbuf, int dtype) {
  const bool bf = dtype == DT_BF16;
  const Layout L = make_layout(c1, ch, c2, nb, th, tw, nbuf, bf ? 8 : 1);
  return L.total * (bf ? 2 : 4);
}

// x: (B, H, W, c1) NHWC; y: (B, H, W, c2); w: 3 + 2 * nb OHWI weights of
// x's dtype (cv1 (ch, 1, 1, c1), cv2 (ch, 1, 1, c1), cv3 (c2, 1, 1, 2 ch),
// then per bottleneck its 1x1 (ch, 1, 1, ch) and 3x3 (ch, 3, 3, ch));
// b: the matching float32 biases.  The wrapper checks c1 % 16 == 0,
// ch % 8 == 0, c2 % 8 == 0, 1 <= nb <= 4, 16-byte aligned tensors and the
// shared-memory size.
extern "C" int mk_c3(const void* x, void* y, const void* const* w,
                     const float* const* b, int B, int H, int W, int c1, int ch,
                     int c2, int nb, int shortcut, int th, int tw, int nbuf, int dtype,
                     void* stream) {
  if (nb < 1 || nb > MAXNB || (nbuf != 1 && nbuf != 2))
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
  a.tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const int smem = mk_c3_smem_bytes(c1, ch, c2, nb, th, tw, nbuf, dtype);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // raise the dynamic shared-memory cap once per type, at the first launch
  // (outside any CUDA-graph capture that later launches may run under)
  static bool cap_set[2] = {false, false};
  const int ti = dtype == DT_BF16 ? 1 : 0;
  if (!cap_set[ti]) {
    const cudaError_t err =
        ti ? cudaFuncSetAttribute(c3_kernel<__nv_bfloat16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)
           : cudaFuncSetAttribute(c3_kernel<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap_set[ti] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(a.tiles_x * tiles_y, B);
  if (ti)
    c3_kernel<__nv_bfloat16><<<grid, NT, smem, s>>>(a);
  else
    c3_kernel<float><<<grid, NT, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
