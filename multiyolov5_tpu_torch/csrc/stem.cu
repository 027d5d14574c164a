// K1: the folded YOLOv5 stem, straight from the letterboxed frame.
//
// Replaces stem_apply_pallas_u8 and stem_apply_pallas_u8_multi
// (multiyolov5_tpu/ops/pallas/stem_kernel.py:141, :308) on a uint8 frame,
// and stem_apply_pallas (:415) on a float32 or bfloat16 frame already
// normalised to [0, 1].  Same function in every mode:
//   y1 = SiLU(conv3x3(s2d4(frame), w1, pad 1) + b1)     48 -> c_mid
//   y  = SiLU(conv2x2(pad_top_left(y1), w2) + b2)       c_mid -> c_out
// on the 4x4 space-to-depth grid.  For a uint8 frame the caller folds the
// /255 normalize into w1 (ops/stem.py's fold, then w1 / 255); for a float
// frame w1 is the fold itself.
//
// The space-to-depth is index arithmetic on the load: quarter-grid channel
// (p + 2q) * 12 + (r + 2s) * 3 + c holds frame pixel (4U + 2p + r,
// 4V + 2q + s), channel c — phase order [ee, oe, eo, oo], H-offset first,
// at both levels.  The TPU host packing (frame_to_stem96, and the
// (B, H/4, W/4, 48) s2d input of stem_apply_pallas) is not needed.  conv2's
// padding pads the *activated* y1 map, not conv1 applied to padded input:
// y1 entries above or left of the image are zero.
//
// Two forms, by output type:
//
// bfloat16 output (tc namespace) computes as the TPU kernel does in bf16
// (stem_kernel.py:75-95, :178-181, :212-214): the frame, the (folded) w1
// and w2 rounded to bf16, float32 accumulation, float32 b1 and b2, y1
// rounded to bf16 after the SiLU.  Both convs are implicit GEMMs on the
// tensor cores (mma.sync m16n8k16).  A CTA of 8 warps owns an 8x16 tile of
// output pixels; it stages the 11x19x48 input patch (bf16) in shared memory
// once, then walks c_mid in chunks of 64 channels:
//   conv1: M = the 9x17 y1 tile (153 rows, padded to 160), N = 64, K = 432;
//          the chunk of y1 (bf16) goes to shared memory;
//   conv2: M = the 128 output pixels, N = c_out, K = 4 taps x 64; its fp32
//          partial sums stay in registers across the chunks.
// So shared memory (45 KB) does not grow with c_mid, and the 9x17 tile
// recomputes 20% (an 8x8 tile's 9x9 would recompute 27%).  A
// operands come by ldmatrix from rows padded to an odd multiple of 16
// bytes; B operands (the weights) come as 16-byte loads per lane from a
// copy the wrapper packs once in the mma fragment order (bf16, c_mid
// padded to a multiple of 64 and c_out to a multiple of 32 with zeros), so
// no CTA stages weights in shared memory.  The conv2 accumulators cost
// c_out / 2 registers a thread: at x width (c_out 160) one CTA an SM.
//
// float32 output (f32 namespace, the CUDA-core form) keeps float32 arithmetic
// on the CUDA cores, as the TPU kernel does at f32: an 8x8 output tile,
// the 11x11x48 patch and the 9x9 x c_mid y1 tile in shared memory
// ((11*11*48 + 81*c_mid) * 4 bytes: 124 KB at x width, one CTA an SM).
//
// What bounds it on an H100: per 1024x512 frame at s width (c_mid 128,
// c_out 64) 5.8 GFLOP (11.2 GMAC at x width is 22.5 GFLOP); the frame read
// (1.5 MB uint8, 6 MB float32) and the output write are small.  In bf16 the
// tensor cores make it a few-microsecond kernel at its bound; mma.sync,
// the 20% recompute and the synchronised chunk loop keep this form above it.
#include "common.cuh"

namespace {

// ------------------------------------------- float32, on the CUDA cores
namespace f32 {

constexpr int TH = 8, TW = 8;              // output tile
constexpr int MH = TH + 1, MW = TW + 1;    // y1 tile incl. top/left halo
constexpr int PH = TH + 3, PW = TW + 3;    // input patch
constexpr int CIN = 48;
constexpr int NT = 256;

template <typename TI, typename T>
__global__ void __launch_bounds__(NT)
stem_kernel(const TI* __restrict__ frame, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, T* __restrict__ out, int H4, int W4,
            int cmid, int cout) {
  extern __shared__ float smem[];
  float* xin = smem;                    // [PH][PW][CIN]
  float* mid = smem + PH * PW * CIN;    // [MH][MW][cmid]
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int H = 4 * H4, W = 4 * W4;

  // input patch: quarter-grid rows r0-2 .. r0+TH, cols c0-2 .. c0+TW
  for (int idx = tid; idx < PH * PW * CIN; idx += NT) {
    const int ch = idx % CIN;
    const int pix = idx / CIN;
    const int U = r0 - 2 + pix / PW, V = c0 - 2 + pix % PW;
    float v = 0.f;
    if (U >= 0 && U < H4 && V >= 0 && V < W4) {
      const int outer = ch / 12, inner = (ch % 12) / 3, c = ch % 3;
      const int row = 4 * U + 2 * (outer & 1) + (inner & 1);
      const int col = 4 * V + 2 * (outer >> 1) + (inner >> 1);
      v = to_f<TI>(frame[((size_t)(b * H + row) * W + col) * 3 + c]);
    }
    xin[idx] = v;
  }
  __syncthreads();

  // conv1: an item is one channel over 3 rows of the 9x9 y1 tile
  for (int item = tid; item < cmid * 3; item += NT) {
    const int co = item % cmid, chunk = item / cmid;
    float acc[3][MW];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < MW; ++j) acc[i][j] = 0.f;
    for (int du = 0; du < 3; ++du) {
      for (int cin = 0; cin < CIN; ++cin) {
        float wv[3];
#pragma unroll
        for (int dv = 0; dv < 3; ++dv)
          wv[dv] = w1[((du * 3 + dv) * CIN + cin) * cmid + co];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float* src = xin + ((chunk * 3 + i + du) * PW) * CIN + cin;
          float in[PW];
#pragma unroll
          for (int j = 0; j < PW; ++j) in[j] = src[j * CIN];
#pragma unroll
          for (int dv = 0; dv < 3; ++dv)
#pragma unroll
            for (int j = 0; j < MW; ++j) acc[i][j] += wv[dv] * in[j + dv];
        }
      }
    }
    const float bias = b1[co];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int mr = chunk * 3 + i;
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        const bool pad = (r0 - 1 + mr < 0) || (c0 - 1 + j < 0);
        mid[(mr * MW + j) * cmid + co] = pad ? 0.f : silu_f(acc[i][j] + bias);
      }
    }
  }
  __syncthreads();

  // conv2: an item is one output channel over 2 rows of the 8x8 tile
  for (int item = tid; item < cout * (TH / 2); item += NT) {
    const int co = item % cout, chunk = item / cout;
    float acc[2][TW];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < TW; ++j) acc[i][j] = 0.f;
    for (int du = 0; du < 2; ++du) {
      for (int cm = 0; cm < cmid; ++cm) {
        const float wa = w2[((du * 2 + 0) * cmid + cm) * cout + co];
        const float wb = w2[((du * 2 + 1) * cmid + cm) * cout + co];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* src = mid + ((chunk * 2 + i + du) * MW) * cmid + cm;
          float m[MW];
#pragma unroll
          for (int j = 0; j < MW; ++j) m[j] = src[j * cmid];
#pragma unroll
          for (int j = 0; j < TW; ++j) acc[i][j] += wa * m[j] + wb * m[j + 1];
        }
      }
    }
    const float bias = b2[co];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + chunk * 2 + i;
      if (r >= H4) continue;
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        const int c = c0 + j;
        if (c < W4)
          out[((size_t)(b * H4 + r) * W4 + c) * cout + co] =
              from_f<T>(silu_f(acc[i][j] + bias));
      }
    }
  }
}

}  // namespace f32

// ------------------------------------------- bfloat16, on the tensor cores
namespace tc {

constexpr int TH = 8, TW = 16;              // output tile
constexpr int MH = TH + 1, MW = TW + 1;     // y1 tile incl. top/left halo
constexpr int MID = MH * MW, MPAD = 160;    // 153 y1 rows, padded to 10 m16 tiles
constexpr int PH = TH + 3, PW = TW + 3;     // input patch
constexpr int CIN = 48, CH = 64;            // conv1 K channels; c_mid chunk
constexpr int XLD = 56, YLD = 72;           // row pitches: odd multiples of 16 bytes
constexpr int K1S = 9 * CIN / 16;           // conv1 k16 steps (27)
constexpr int K2S = 4 * CH / 16;            // conv2 k16 steps a chunk (16)
constexpr int NT = 256;

template <typename TI> __device__ __forceinline__ __nv_bfloat16 to_bf(TI v);
template <> __device__ __forceinline__ __nv_bfloat16 to_bf<uint8_t>(uint8_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));   // exact
}
template <> __device__ __forceinline__ __nv_bfloat16 to_bf<float>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 to_bf<__nv_bfloat16>(__nv_bfloat16 v) {
  return v;
}

// p1: conv1's B fragments, uint4 [chunk][27][4 n16][32 lanes]; p2: conv2's,
// uint4 [chunk][16][c_out_p / 16][32 lanes] (ops/kernels/stem.py packs
// both).  NP2 = c_out_p / 32: the 16-column pairs each of conv2's two
// column warps owns.
template <typename TI, int NP2>
__global__ void __launch_bounds__(NT, NP2 <= 3 ? 2 : 1)
stem_tc(const TI* __restrict__ frame, const uint4* __restrict__ p1,
        const float* __restrict__ b1, const uint4* __restrict__ p2,
        const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H4,
        int W4, int cmid, int cout) {
  __shared__ __align__(16) __nv_bfloat16 xin[PH * PW * XLD];
  __shared__ __align__(16) __nv_bfloat16 y1s[MPAD * YLD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int H = 4 * H4, W = 4 * W4;
  const int nch = (cmid + CH - 1) / CH;
  constexpr int NPT = 2 * NP2;              // 16-column pairs of c_out_p

  // input patch: quarter-grid rows r0-2 .. r0+TH, cols c0-2 .. c0+TW; an
  // item is one patch pixel's frame row 4U + a: 4 pixels x 3 channels
  for (int it = tid; it < PH * PW * 4; it += NT) {
    const int px = it >> 2, a = it & 3;
    const int U = r0 - 2 + px / PW, V = c0 - 2 + px % PW;
    __nv_bfloat16* dst = xin + px * XLD + (a >> 1) * 12 + (a & 1) * 3;
    const bool in = U >= 0 && U < H4 && V >= 0 && V < W4;
    const TI* src = frame + ((size_t)(b * H + 4 * U + a) * W + 4 * V) * 3;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)          // column offset 2q + s
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dst[(bb >> 1) * 24 + (bb & 1) * 6 + c] =
            in ? to_bf<TI>(src[bb * 3 + c]) : __float2bfloat16_rn(0.f);
  }

  // conv1 warp tile: 80 y1 rows (5 m16) x 16 chunk columns (2 n8)
  const int wm1 = warp / 4, wn1 = warp % 4;
  int pbase[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    int m = wm1 * 80 + i * 16 + lane % 16;
    m = m < MID ? m : 0;
    pbase[i] = (m / MW) * PW + m % MW;
  }
  // conv2 warp tile: 32 output pixels (2 m16) x NP2 * 16 columns
  const int wm2 = warp / 2, wn2 = warp % 2;
  int obase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = wm2 * 32 + i * 16 + lane % 16;
    obase[i] = (o / TW) * MW + o % TW;
  }
  const int acol = (lane / 16) * 8;

  float acc2[2][2 * NP2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc2[i][j][q] = 0.f;
  __syncthreads();

  for (int ch = 0; ch < nch; ++ch) {
    // ---- conv1 for channels ch*64 .. ch*64+63 of y1
    float acc1[5][2][4];
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc1[i][j][q] = 0.f;
    const uint4* q1 = p1 + (size_t)ch * K1S * 4 * 32 + wn1 * 32 + lane;
    uint4 bcur = __ldg(q1);
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * PW + tap % 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ks = tap * 3 + j;
        const uint4 bnext = ks + 1 < K1S ? __ldg(q1 + (ks + 1) * 128) : bcur;
        uint32_t a[5][4];
#pragma unroll
        for (int i = 0; i < 5; ++i) mk::ldsm_x4(a[i], xin + (pbase[i] + off) * XLD + j * 16 + acol);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          mk::mma16816(acc1[i][0], a[i], bcur.x, bcur.y);
          mk::mma16816(acc1[i][1], a[i], bcur.z, bcur.w);
        }
        bcur = bnext;
      }
    }
    __syncthreads();                        // the last chunk's conv2 is done with y1s
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wm1 * 80 + i * 16 + g + half * 8;
        const int mr = m / MW, mc = m % MW;
        const bool halo = r0 - 1 + mr < 0 || c0 - 1 + mc < 0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = wn1 * 16 + nt * 8 + 2 * t, nn = ch * CH + n;
          const float v0 = acc1[i][nt][half * 2] + (nn < cmid ? b1[nn] : 0.f);
          const float v1 = acc1[i][nt][half * 2 + 1] + (nn + 1 < cmid ? b1[nn + 1] : 0.f);
          *reinterpret_cast<__nv_bfloat162*>(y1s + m * YLD + n) =
              halo ? __floats2bfloat162_rn(0.f, 0.f)
                   : __floats2bfloat162_rn(silu_f(v0), silu_f(v1));
        }
      }
    __syncthreads();

    // ---- conv2's partial sum over this chunk of c_mid
    const uint4* q2 = p2 + ((size_t)ch * K2S * NPT + wn2 * NP2) * 32 + lane;
#pragma unroll 4
    for (int ks = 0; ks < K2S; ++ks) {
      const int tap = ks / 4, c16 = ks % 4;
      const int off = (tap / 2) * MW + tap % 2;
      uint4 bw[NP2];
#pragma unroll
      for (int j = 0; j < NP2; ++j) bw[j] = __ldg(q2 + (ks * NPT + j) * 32);
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) mk::ldsm_x4(a[i], y1s + (obase[i] + off) * YLD + c16 * 16 + acol);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NP2; ++j) {
          mk::mma16816(acc2[i][2 * j], a[i], bw[j].x, bw[j].y);
          mk::mma16816(acc2[i][2 * j + 1], a[i], bw[j].z, bw[j].w);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = wm2 * 32 + i * 16 + g + half * 8;
      const int r = r0 + o / TW, c = c0 + o % TW;
      if (r >= H4 || c >= W4) continue;
      __nv_bfloat16* dst = out + ((size_t)(b * H4 + r) * W4 + c) * cout;
#pragma unroll
      for (int nt = 0; nt < 2 * NP2; ++nt) {
        const int n = wn2 * NP2 * 16 + nt * 8 + 2 * t;
        if (n >= cout) continue;
        const float v0 = silu_f(acc2[i][nt][half * 2] + b2[n]);
        const float v1 = silu_f(acc2[i][nt][half * 2 + 1] + b2[n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <typename TI, int NP2>
int launch(const void* frame, const void* p1, const float* b1, const void* p2,
           const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
           cudaStream_t stream) {
  dim3 grid((W4 + TW - 1) / TW, (H4 + TH - 1) / TH, B);
  stem_tc<TI, NP2><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(frame), static_cast<const uint4*>(p1), b1,
      static_cast<const uint4*>(p2), b2, static_cast<__nv_bfloat16*>(out), H4, W4,
      cmid, cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch_np(const void* frame, const void* p1, const float* b1, const void* p2,
              const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
              cudaStream_t s) {
  switch ((cout + 31) / 32) {
    case 1: return launch<TI, 1>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
    case 2: return launch<TI, 2>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
    case 3: return launch<TI, 3>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
    case 4: return launch<TI, 4>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
    case 5: return launch<TI, 5>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

namespace f32 {

template <typename TI, typename T>
int launch(const void* frame, const float* w1, const float* b1,
           const float* w2, const float* b2, void* out, int B, int H4, int W4,
           int cmid, int cout, cudaStream_t stream) {
  const size_t smem = (size_t)(PH * PW * CIN + MH * MW * cmid) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stem_kernel<TI, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((W4 + TW - 1) / TW, (H4 + TH - 1) / TH, B);
  stem_kernel<TI, T><<<grid, NT, smem, stream>>>(
      static_cast<const TI*>(frame), w1, b1, w2, b2, static_cast<T*>(out), H4,
      W4, cmid, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// frame: (B, 4*H4, 4*W4, 3) in `in_dtype` (DT_U8, or DT_F32 / DT_BF16 in
// [0, 1]); w1: (3, 3, 48, cmid) float32 HWIO, with the /255 folded in for
// a uint8 frame; b1: (cmid,); w2: (2, 2, cmid, cout) float32 HWIO;
// b2: (cout,); out: (B, H4, W4, cout) NHWC float32.  The CUDA-core form.
extern "C" int mk_stem(const void* frame, const float* w1, const float* b1,
                       const float* w2, const float* b2, void* out, int B,
                       int H4, int W4, int cmid, int cout, int in_dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_U8)
    return f32::launch<uint8_t, float>(frame, w1, b1, w2, b2, out, B, H4, W4, cmid,
                                       cout, s);
  if (in_dtype == DT_BF16)
    return f32::launch<__nv_bfloat16, float>(frame, w1, b1, w2, b2, out, B, H4, W4,
                                             cmid, cout, s);
  return f32::launch<float, float>(frame, w1, b1, w2, b2, out, B, H4, W4, cmid,
                                   cout, s);
}

// The bfloat16-output form on the tensor cores: p1 and p2 are the packed
// bf16 weights of ops/kernels/stem.py pack_weights (c_mid padded to a
// multiple of 64, c_out to a multiple of 32, cout <= 160); b1: (cmid,),
// b2: (cout,) float32; out: (B, H4, W4, cout) NHWC bfloat16.
extern "C" int mk_stem_tc(const void* frame, const void* p1, const float* b1,
                          const void* p2, const float* b2, void* out, int B,
                          int H4, int W4, int cmid, int cout, int in_dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_U8)
    return tc::launch_np<uint8_t>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
  if (in_dtype == DT_BF16)
    return tc::launch_np<__nv_bfloat16>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid,
                                        cout, s);
  return tc::launch_np<float>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, s);
}
