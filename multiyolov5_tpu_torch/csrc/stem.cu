// K1: the folded YOLOv5 stem, straight from the letterboxed frame.
//
// Replaces stem_apply_pallas_u8 and stem_apply_pallas_u8_multi
// (multiyolov5_tpu/ops/pallas/stem_kernel.py:141, :308) on a uint8 frame,
// and stem_apply_pallas (:415) on a float32 or bfloat16 frame already
// normalised to [0, 1].  Same function in every mode:
//   y1 = SiLU(conv3x3(s2d4(frame), w1, pad 1) + b1)     16 C -> c_mid
//   y  = SiLU(conv2x2(pad_top_left(y1), w2) + b2)       c_mid -> c_out
// on the 4x4 space-to-depth grid of a frame of C channels (1 <= C <= 13;
// the TPU kernels take any c_in, stem_kernel.py:153, :320, :419).  For a uint8 frame the caller folds the
// /255 normalize into w1 (ops/stem.py's fold, then w1 / 255); for a float
// frame w1 is the fold itself.
//
// The space-to-depth is index arithmetic on the load: quarter-grid channel
// (p + 2q) * 4C + (r + 2s) * C + c holds frame pixel (4U + 2p + r,
// 4V + 2q + s), channel c — phase order [ee, oe, eo, oo], H-offset first,
// at both levels.  The TPU host packing (frame_to_stem96, and the
// (B, H/4, W/4, 48) s2d input of stem_apply_pallas) is not needed.  conv2's
// padding pads the *activated* y1 map, not conv1 applied to padded input:
// y1 entries above or left of the image are zero.
//
// Two forms, by output type, both on the tensor cores with one skeleton.
// A CTA of 8 warps owns an 8x16 tile of output pixels; it stages the
// 11x19x16C input patch in shared memory once, then walks c_mid in chunks
// of 64 channels:
//   conv1: M = the 9x17 y1 tile (153 rows, padded to 160), N = 64,
//          K = 144 C (C k16 steps a tap);
//          the chunk of y1 goes to shared memory;
//   conv2: M = the 128 output pixels, N = c_out, K = 4 taps x 64; its fp32
//          partial sums stay in registers across the chunks.
// So shared memory does not grow with c_mid, and the 9x17 tile recomputes
// 20% (an 8x8 tile's 9x9 would recompute 27%).  A operands come by
// ldmatrix from rows padded to an odd multiple of 16 bytes (no bank
// conflicts); B operands (the weights) come as 16-byte loads per lane from
// a copy the wrapper packs once in the mma fragment order (c_mid padded to
// a multiple of 64 and c_out to a multiple of 32 with zeros), so no CTA
// stages weights in shared memory.  The conv2 accumulators cost c_out / 2
// registers a thread: at x width (c_out 160) one CTA an SM.  C is a
// template constant for RGB frames (C = 3, the loops over a tap's k steps
// unrolled) and a kernel argument for any other C; shared memory is
// dynamic, sized by C.
//
// bfloat16 output (tc namespace, stem_tc) computes as the TPU kernel does
// in bf16 (stem_kernel.py:75-95, :178-181, :212-214): the frame, the
// (folded) w1 and w2 rounded to bf16, float32 accumulation, float32 b1 and
// b2, y1 rounded to bf16 after the SiLU; mma.sync m16n8k16, the patch and
// y1 in bf16 (45 KB of shared memory at C = 3, 52 KB at C = 4).
//
// float32 output (tf32 namespace, stem_tf32) replaces the same TPU kernels
// at float32, the eval path's form (evaluation.py builds a float32
// Engine): products and sums float32-accurate, float32 biases, the exact
// expf SiLU.  The TPU computes an f32 matmul in several bf16 passes of its
// MXU; this card's counterpart is 3xTF32 on mma.sync m16n8k8: x = hi + lo
// with hi = tf32_rna(x), lo = tf32_rna(x - hi), and a * b summed as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, ~2^-22 of it, dropped),
// float32 accumulation throughout.  The tensor core truncates each mma's
// sum toward zero, so a long chain of mmas drifts toward zero: each k8
// step sums into a fresh accumulator, and the running sum takes it on the
// CUDA cores, rounded to nearest (see mma_hi).  The weights come split on the
// host (ops/kernels/stem.py pack_weights_tf32, hi and lo side by side);
// the patch and y1 are split in registers after ldmatrix.  A uint8 or bf16
// frame value is exact in tf32, so on those frames conv1 needs 2 products,
// not 3.  The patch (16C + 4-float rows, 43.5 KB at C = 3) and the y1
// chunk (68-float rows, 43.5 KB) are float32: 87 KB of dynamic shared
// memory at C = 3 (the 227 KB an SM holds caps C at 13), two CTAs an SM
// up to c_out 64 (s width; the launch bounds cap registers at 128 for
// that).  A chunk of 32 would halve y1's shared memory, but registers, not
// shared memory, cap the CTAs an SM, and conv1 would reuse each split A
// fragment for one n8 tile instead of two.
//
// What bounds it on an H100: 2 flops a MAC of the two convs, 3 TF32
// products a MAC (2 for conv1 on a uint8 or bf16 frame), at 495 TFLOP/s:
// per 1024x512 frame at s width (c_mid 128, c_out 64) 5.8 GFLOP of
// float32 work, 0.035 ms as 3xTF32 on a float frame, 0.028 on a uint8
// one (0.086 ms as float32 on the CUDA cores at 67 TFLOP/s); 22.5 GFLOP
// at x width.  The frame read (1.5 MB uint8, 6 MB float32) and the output
// write are small.  mma.sync (not wgmma), the 20% recompute, the
// in-register splits and the synchronised chunk loop keep both forms above
// their bounds.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_C = 13;                   // frame channels: the float32 patch's shared memory

// ------------------------------------------- bfloat16, on the tensor cores
namespace tc {

constexpr int TH = 8, TW = 16;              // output tile
constexpr int MH = TH + 1, MW = TW + 1;     // y1 tile incl. top/left halo
constexpr int MID = MH * MW, MPAD = 160;    // 153 y1 rows, padded to 10 m16 tiles
constexpr int PH = TH + 3, PW = TW + 3;     // input patch
constexpr int CH = 64;                      // c_mid chunk
constexpr int YLD = 72;                     // y1 row pitch: an odd multiple of 16 bytes
constexpr int K2S = 4 * CH / 16;            // conv2 k16 steps a chunk (16)
constexpr int NT = 256;

// the patch's row pitch for C frame channels (16 C of conv1's K): an odd
// multiple of 16 bytes (56 at C = 3); shared memory of a CTA
__host__ __device__ constexpr int xld(int c) { return 16 * c + 8; }
constexpr size_t smem_bytes(int c) {
  return static_cast<size_t>(PH * PW * xld(c) + MPAD * YLD) * sizeof(__nv_bfloat16);
}

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

// p1: conv1's B fragments, uint4 [chunk][9 C][4 n16][32 lanes]; p2:
// conv2's, uint4 [chunk][16][c_out_p / 16][32 lanes] (ops/kernels/stem.py
// packs both).  NP2 = c_out_p / 32: the 16-column pairs each of conv2's two
// column warps owns.  CT: the frame's channels, or 0 to take them from cin.
template <typename TI, int NP2, int CT>
__global__ void __launch_bounds__(NT, NP2 <= 3 ? 2 : 1)
stem_tc(const TI* __restrict__ frame, const uint4* __restrict__ p1,
        const float* __restrict__ b1, const uint4* __restrict__ p2,
        const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H4,
        int W4, int cmid, int cout, int cin) {
  const int C = CT > 0 ? CT : cin;
  const int XLD = xld(C), K1S = 9 * C;      // conv1 k16 steps (27 at C = 3)
  extern __shared__ __align__(16) __nv_bfloat16 smem_tc[];
  __nv_bfloat16* xin = smem_tc;             // [PH * PW][XLD]
  __nv_bfloat16* y1s = smem_tc + PH * PW * XLD;   // [MPAD][YLD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int H = 4 * H4, W = 4 * W4;
  const int nch = (cmid + CH - 1) / CH;
  constexpr int NPT = 2 * NP2;              // 16-column pairs of c_out_p

  // input patch: quarter-grid rows r0-2 .. r0+TH, cols c0-2 .. c0+TW; an
  // item is one patch pixel's frame row 4U + a: 4 pixels x C channels
  for (int it = tid; it < PH * PW * 4; it += NT) {
    const int px = it >> 2, a = it & 3;
    const int U = r0 - 2 + px / PW, V = c0 - 2 + px % PW;
    __nv_bfloat16* dst = xin + px * XLD + (a >> 1) * 4 * C + (a & 1) * C;
    const bool in = U >= 0 && U < H4 && V >= 0 && V < W4;
    const TI* src = frame + ((size_t)(b * H + 4 * U + a) * W + 4 * V) * C;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)          // column offset 2q + s
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[(bb >> 1) * 8 * C + (bb & 1) * 2 * C + c] =
            in ? to_bf<TI>(src[bb * C + c]) : __float2bfloat16_rn(0.f);
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
      for (int j = 0; j < C; ++j) {
        const int ks = tap * C + j;
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

template <typename TI, int NP2, int CT>
int launch(const void* frame, const void* p1, const float* b1, const void* p2,
           const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
           int cin, cudaStream_t stream) {
  const size_t smem = smem_bytes(cin);
  if (smem > 48 * 1024) {                   // past the default cap of dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        stem_tc<TI, NP2, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W4 + TW - 1) / TW, (H4 + TH - 1) / TH, B);
  stem_tc<TI, NP2, CT><<<grid, NT, smem, stream>>>(
      static_cast<const TI*>(frame), static_cast<const uint4*>(p1), b1,
      static_cast<const uint4*>(p2), b2, static_cast<__nv_bfloat16*>(out), H4, W4,
      cmid, cout, cin);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, int CT>
int launch_np(const void* frame, const void* p1, const float* b1, const void* p2,
              const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
              int cin, cudaStream_t s) {
  switch ((cout + 31) / 32) {
    case 1: return launch<TI, 1, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 2: return launch<TI, 2, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 3: return launch<TI, 3, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 4: return launch<TI, 4, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 5: return launch<TI, 5, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = 3 (RGB) with the channels a template constant; any other C as an argument
template <typename TI>
int launch_c(const void* frame, const void* p1, const float* b1, const void* p2,
             const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
             int cin, cudaStream_t s) {
  if (cin == 3)
    return launch_np<TI, 3>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
  return launch_np<TI, 0>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
}

}  // namespace tc

// ------------------------------------------- float32, 3xTF32 on the tensor cores
namespace tf32 {

constexpr int TH = 8, TW = 16;              // output tile
constexpr int MH = TH + 1, MW = TW + 1;     // y1 tile incl. top/left halo
constexpr int MID = MH * MW, MPAD = 160;    // 153 y1 rows, padded to 10 m16 tiles
constexpr int PH = TH + 3, PW = TW + 3;     // input patch
constexpr int CH = 64;                      // c_mid chunk
constexpr int YLD = 68;                     // y1 row pitch in floats: 17 x 16 bytes
constexpr int K2S = 4 * CH / 8;             // conv2 k8 steps a chunk (32)
constexpr int NT = 256;

// the patch's row pitch in floats for C frame channels: an odd multiple of
// 16 bytes (52 at C = 3); shared memory of a CTA (43,472 + 43,520 bytes at
// C = 3)
__host__ __device__ constexpr int xld(int c) { return 16 * c + 4; }
constexpr size_t smem_bytes(int c) {
  return static_cast<size_t>(PH * PW * xld(c) + MPAD * YLD) * sizeof(float);
}

// One k8 step of 3xTF32 for the two n8 tiles of a 16-byte B load, chained
// in one tensor-core accumulator c that starts at zero: mma_lo adds a_lo *
// bh (for an A operand that is not exact in tf32), mma_hi adds a_hi * bl
// and then a_hi * bh, the large term, last; add4 adds c to the running sum
// by FADD, rounded to nearest.  The tensor core truncates its sums toward
// zero, ~2^-24.5 of a sum's value each time, so every truncation that the
// large terms pass biases the output toward zero.  Measured on pspv5x's
// stem (x width) against float64, as a gain on every output: chaining the
// whole sum in one accumulator (the first version of this form) read
// 1.2e-4 off stem_plain; chaining a pair of k8 steps, 1 - 1.6e-7; one k8
// step, as here, 1 - 9.8e-8 at an rms error of 3.6e-8 of the output's
// scale (float32 on the CPU: 3.4e-8, no gain error).  Flushing every mma
// by FADD halves the gain error (1 - 5e-8) but adds roundings (rms
// 4.8e-8) and costs 14% at s width.
__device__ __forceinline__ void mma_lo(float (&c0)[4], float (&c1)[4], const uint32_t (&lo)[4],
                                       const uint4& bh) {
  mk::mma1688_tf32(c0, lo, bh.x, bh.y);
  mk::mma1688_tf32(c1, lo, bh.z, bh.w);
}

__device__ __forceinline__ void mma_hi(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                       const uint4& bh, const uint4& bl) {
  mk::mma1688_tf32(c0, a, bl.x, bl.y);
  mk::mma1688_tf32(c1, a, bl.z, bl.w);
  mk::mma1688_tf32(c0, a, bh.x, bh.y);
  mk::mma1688_tf32(c1, a, bh.z, bh.w);
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += t[q];
}

// p1: conv1's B fragments, uint4 [chunk][18 C][4 n16][hi, lo][32 lanes];
// p2: conv2's, uint4 [chunk][32][c_out_p / 16][hi, lo][32 lanes]
// (ops/kernels/stem.py pack_weights_tf32 packs both).  NP2 = c_out_p / 32:
// the 16-column pairs each of conv2's two column warps owns.  CT: the
// frame's channels, or 0 to take them from cin.
template <typename TI, int NP2, int CT>
__global__ void __launch_bounds__(NT, NP2 <= 2 ? 2 : 1)
stem_tf32(const TI* __restrict__ frame, const uint4* __restrict__ p1,
          const float* __restrict__ b1, const uint4* __restrict__ p2,
          const float* __restrict__ b2, float* __restrict__ out, int H4, int W4,
          int cmid, int cout, int cin) {
  const int C = CT > 0 ? CT : cin;
  const int XLD = xld(C), K1S = 18 * C;     // conv1 k8 steps (54 at C = 3)
  extern __shared__ __align__(16) float smem[];
  float* xin = smem;                        // [PH * PW][XLD]
  float* y1s = smem + PH * PW * XLD;        // [MPAD][YLD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int H = 4 * H4, W = 4 * W4;
  const int nch = (cmid + CH - 1) / CH;
  constexpr int NPT = 2 * NP2;              // 16-column tiles of c_out_p
  // a uint8 or bfloat16 frame value is exact in tf32: conv1's A has no lo
  constexpr bool EXACT = !std::is_same<TI, float>::value;

  // input patch: quarter-grid rows r0-2 .. r0+TH, cols c0-2 .. c0+TW; an
  // item is one patch pixel's frame row 4U + a: 4 pixels x C channels
  for (int it = tid; it < PH * PW * 4; it += NT) {
    const int px = it >> 2, a = it & 3;
    const int U = r0 - 2 + px / PW, V = c0 - 2 + px % PW;
    float* dst = xin + px * XLD + (a >> 1) * 4 * C + (a & 1) * C;
    const bool in = U >= 0 && U < H4 && V >= 0 && V < W4;
    const TI* src = frame + ((size_t)(b * H + 4 * U + a) * W + 4 * V) * C;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)          // column offset 2q + s
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[(bb >> 1) * 8 * C + (bb & 1) * 2 * C + c] = in ? to_f<TI>(src[bb * C + c]) : 0.f;
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
  const int acol = (lane / 16) * 4;

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
    const uint4* q1 = p1 + (size_t)ch * K1S * 4 * 64 + wn1 * 64 + lane;
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * PW + tap % 3;
#pragma unroll
      for (int j = 0; j < 2 * C; ++j) {
        const uint4* q = q1 + (tap * 2 * C + j) * 256;
        const uint4 bh = __ldg(q), bl = __ldg(q + 32);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          uint32_t a[4];
          mk::ldsm_x4(a, xin + (pbase[i] + off) * XLD + j * 8 + acol);
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          if (!EXACT) {
            uint32_t lo[4];
            mk::tf32_split(a, lo);
            mma_lo(t0, t1, lo, bh);
          }
          mma_hi(t0, t1, a, bh, bl);
          add4(acc1[i][0], t0);
          add4(acc1[i][1], t1);
        }
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
          *reinterpret_cast<float2*>(y1s + m * YLD + n) =
              halo ? make_float2(0.f, 0.f) : make_float2(silu_f(v0), silu_f(v1));
        }
      }
    __syncthreads();

    // ---- conv2's partial sum over this chunk of c_mid
    const uint4* q2 = p2 + ((size_t)ch * K2S * NPT + wn2 * NP2) * 64 + lane;
#pragma unroll 2
    for (int ks = 0; ks < K2S; ++ks) {
      const int tap = ks / 8, c8 = ks % 8;
      const int off = (tap / 2) * MW + tap % 2;
      uint32_t a[2][4], lo[2][4];           // y1 is not exact in tf32: split it
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mk::ldsm_x4(a[i], y1s + (obase[i] + off) * YLD + c8 * 8 + acol);
        mk::tf32_split(a[i], lo[i]);
      }
#pragma unroll
      for (int j = 0; j < NP2; ++j) {
        const uint4* q = q2 + (ks * NPT + j) * 64;
        const uint4 bh = __ldg(q), bl = __ldg(q + 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_lo(t0, t1, lo[i], bh);
          mma_hi(t0, t1, a[i], bh, bl);
          add4(acc2[i][2 * j], t0);
          add4(acc2[i][2 * j + 1], t1);
        }
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
      float* dst = out + ((size_t)(b * H4 + r) * W4 + c) * cout;
#pragma unroll
      for (int nt = 0; nt < 2 * NP2; ++nt) {
        const int n = wn2 * NP2 * 16 + nt * 8 + 2 * t;
        if (n >= cout) continue;
        *reinterpret_cast<float2*>(dst + n) =
            make_float2(silu_f(acc2[i][nt][half * 2] + b2[n]),
                        silu_f(acc2[i][nt][half * 2 + 1] + b2[n + 1]));
      }
    }
}

template <typename TI, int NP2, int CT>
int launch(const void* frame, const void* p1, const float* b1, const void* p2,
           const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
           int cin, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(cin));
  cudaError_t e = cudaFuncSetAttribute(stem_tf32<TI, NP2, CT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(stem_tf32<TI, NP2, CT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((W4 + TW - 1) / TW, (H4 + TH - 1) / TH, B);
  stem_tf32<TI, NP2, CT><<<grid, NT, smem, stream>>>(
      static_cast<const TI*>(frame), static_cast<const uint4*>(p1), b1,
      static_cast<const uint4*>(p2), b2, static_cast<float*>(out), H4, W4, cmid, cout, cin);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, int CT>
int launch_np(const void* frame, const void* p1, const float* b1, const void* p2,
              const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
              int cin, cudaStream_t s) {
  switch ((cout + 31) / 32) {
    case 1: return launch<TI, 1, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 2: return launch<TI, 2, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 3: return launch<TI, 3, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 4: return launch<TI, 4, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    case 5: return launch<TI, 5, CT>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = 3 (RGB) with the channels a template constant; any other C as an argument
template <typename TI>
int launch_c(const void* frame, const void* p1, const float* b1, const void* p2,
             const float* b2, void* out, int B, int H4, int W4, int cmid, int cout,
             int cin, cudaStream_t s) {
  if (cin == 3)
    return launch_np<TI, 3>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
  return launch_np<TI, 0>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
}

}  // namespace tf32

}  // namespace

// The bfloat16-output form on the tensor cores: frame (B, 4 H4, 4 W4, cin)
// NHWC, 1 <= cin <= 13; p1 and p2 are the packed bf16 weights of
// ops/kernels/stem.py pack_weights (c_mid padded to a multiple of 64, c_out
// to a multiple of 32, cout <= 160); b1: (cmid,), b2: (cout,) float32; out:
// (B, H4, W4, cout) NHWC bfloat16.
extern "C" int mk_stem_tc(const void* frame, const void* p1, const float* b1,
                          const void* p2, const float* b2, void* out, int B,
                          int H4, int W4, int cmid, int cout, int cin, int in_dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == DT_U8)
    return tc::launch_c<uint8_t>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
  if (in_dtype == DT_BF16)
    return tc::launch_c<__nv_bfloat16>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid,
                                       cout, cin, s);
  return tc::launch_c<float>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
}

// The float32-output form, 3xTF32 on the tensor cores: frame (B, 4 H4,
// 4 W4, cin) NHWC, 1 <= cin <= 13; p1 and p2 are the packed tf32 hi / lo
// weights of ops/kernels/stem.py pack_weights_tf32 (c_mid padded to a
// multiple of 64, c_out to a multiple of 32, cout even and <= 160); b1:
// (cmid,), b2: (cout,) float32; out: (B, H4, W4, cout) NHWC float32.
extern "C" int mk_stem_tf32(const void* frame, const void* p1, const float* b1,
                            const void* p2, const float* b2, void* out, int B,
                            int H4, int W4, int cmid, int cout, int cin, int in_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == DT_U8)
    return tf32::launch_c<uint8_t>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin,
                                   s);
  if (in_dtype == DT_BF16)
    return tf32::launch_c<__nv_bfloat16>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid,
                                         cout, cin, s);
  return tf32::launch_c<float>(frame, p1, b1, p2, b2, out, B, H4, W4, cmid, cout, cin, s);
}
