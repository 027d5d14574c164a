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
// frame w1 is the fold itself.  The input type only changes the staged
// load: every mode computes in float32 with float32 weights.
//
// The space-to-depth is index arithmetic on the load: quarter-grid channel
// (p + 2q) * 12 + (r + 2s) * 3 + c holds frame pixel (4U + 2p + r,
// 4V + 2q + s), channel c — phase order [ee, oe, eo, oo], H-offset first,
// at both levels.  The TPU host packing (frame_to_stem96, and the
// (B, H/4, W/4, 48) s2d input of stem_apply_pallas) is not needed.
//
// A block owns an 8x8 tile of output pixels.  It stages the 11x11x48
// input patch it needs in shared memory, computes the 9x9 x c_mid map of
// y1 (the tile plus conv2's top/left halo) into shared memory, and zeroes
// the halo entries that lie above or left of the image: conv2's padding
// pads the *activated* y1 map, not conv1 applied to padded input.  Only
// the c_out output map is written to device memory.  Shared memory is
// (11*11*48 + 81*c_mid) * 4 bytes: 64 KB at s width (c_mid 128), 124 KB at
// x width (c_mid 320), one CTA an SM there.
//
// What bounds it on an H100: about 2.9 GMAC per 1024x512 frame (4*c_mid =
// 128 at s width; 11.2 GMAC at x width) on the fp32 CUDA cores, plus the
// 27% overlap recompute of the 9x9 mid tile; the frame read (1.5 MB uint8,
// 6 MB float32) and the output write are small.  Weights stay float32 and
// come through L1/L2.
#include "common.cuh"

namespace {

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

template <typename TI>
int launch_out(const void* frame, const float* w1, const float* b1,
               const float* w2, const float* b2, void* out, int B, int H4,
               int W4, int cmid, int cout, int out_dtype, cudaStream_t stream) {
  if (out_dtype == DT_BF16)
    return launch<TI, __nv_bfloat16>(frame, w1, b1, w2, b2, out, B, H4, W4,
                                     cmid, cout, stream);
  return launch<TI, float>(frame, w1, b1, w2, b2, out, B, H4, W4, cmid, cout,
                           stream);
}

}  // namespace

// frame: (B, 4*H4, 4*W4, 3) in `in_dtype` (DT_U8, or DT_F32 / DT_BF16 in
// [0, 1]); w1: (3, 3, 48, cmid) float32 HWIO, with the /255 folded in for
// a uint8 frame; b1: (cmid,); w2: (2, 2, cmid, cout) float32 HWIO;
// b2: (cout,); out: (B, H4, W4, cout) NHWC in `out_dtype`.
extern "C" int mk_stem(const void* frame, const float* w1, const float* b1,
                       const float* w2, const float* b2, void* out, int B,
                       int H4, int W4, int cmid, int cout, int in_dtype,
                       int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_U8)
    return launch_out<uint8_t>(frame, w1, b1, w2, b2, out, B, H4, W4, cmid,
                               cout, out_dtype, s);
  if (in_dtype == DT_BF16)
    return launch_out<__nv_bfloat16>(frame, w1, b1, w2, b2, out, B, H4, W4,
                                     cmid, cout, out_dtype, s);
  return launch_out<float>(frame, w1, b1, w2, b2, out, B, H4, W4, cmid, cout,
                           out_dtype, s);
}
