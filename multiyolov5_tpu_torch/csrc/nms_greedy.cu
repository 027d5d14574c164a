// K5: sequential greedy NMS truncated at max_det, over up to ~1.8 M
// score-sorted candidates per image, one CTA per image.
//
// Replaces nms_pallas (multiyolov5_tpu/ops/pallas/nms_kernel.py:87).  Same
// function (:26-83): picks are greedy and capped at max_det; each pick is
// the highest-scoring active row, the lowest index among ties; it removes
// itself and every active row with
//   inter / (area_i + area_p - inter + 1e-9) > t
// in that operation order, with 1e-9 and t as float32 constants.  The
// outputs are prefilled with -1 / invalid, and the loop stops at the first
// step that finds no active row.  Every product, sum and the quotient are
// rounded once (__f*_rn: nvcc may not contract them into an FMA), so the
// picks equal the TPU kernel's and the plain version's
// (ops/kernels/nms_greedy.py) index for index.
//
// The input must be sorted by descending score, with rows of score <= 0
// invalid: ops/nms.py's top_k guarantees it (ties lower index first, as
// lax.top_k).  The highest-scoring active row is then the first active
// row, so a pick is a find-first-set over the active bitmask, not an
// argmax over scores.  Rows before the previous pick are all inactive, so
// each search starts at the previous pick's word.
//
// Design: the active flags live as a bitmask in shared memory (4 KB at
// N = 30000); boxes and scores stay in device memory (480 KB per image,
// L2-resident) and are read as float4.  Per pick, warp 0 finds the first
// set bit with ballots; then the CTA's 1024 threads test the active rows
// after the pick against it, one warp per 32-row word, and clear the
// overlapping bits with one ballot per word (no atomics: each word has one
// writer).  Four rows per thread are loaded before any is tested, so four
// L2 reads are in flight per thread.
//
// What bounds it on an H100: latency.  The work is at most max_det dependent
// steps, each a block-wide pass over the remaining active rows (~30 loads a
// thread at N = 30000) between two barriers; the bytes (20 B a row) and the
// ~17 flops per IoU test are far below the card's rates.  One CTA per image
// uses a few SMs of 132: a blocked IoU-bitmask design over many CTAs is the
// faster, later form.
#include "common.cuh"

namespace {

constexpr int NT = 1024;
constexpr int UNROLL = 4;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(row, pick) > t in nms_kernel.py:68-72's form and operation order
__device__ __forceinline__ bool overlaps(float4 b, float4 p, float area_p, float t) {
  const float iw = fmaxf(__fsub_rn(fminf(b.z, p.z), fmaxf(b.x, p.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(b.w, p.w), fmaxf(b.y, p.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_of(b), area_p), inter), 1e-9f);
  return __fdiv_rn(inter, den) > t;
}

__global__ void __launch_bounds__(NT)
nms_greedy_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  int n, float t, int max_det, int* __restrict__ out_idx,
                  uint8_t* __restrict__ out_valid) {
  extern __shared__ uint32_t active[];   // bit j of word w: row 32 w + j is active
  __shared__ int s_end;                  // one past the last valid row
  __shared__ int s_pick;
  const int img = blockIdx.x;
  boxes += (size_t)img * n;
  scores += (size_t)img * n;
  out_idx += (size_t)img * max_det;
  out_valid += (size_t)img * max_det;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nw = (n + 31) >> 5;

  if (tid == 0) s_end = 0;
  for (int k = tid; k < max_det; k += NT) {
    out_idx[k] = -1;
    out_valid[k] = 0;
  }
  __syncthreads();
  int last = 0;
  // nw * 32 and NT are multiples of 32, so each warp covers whole words
  for (int i = tid; i < nw * 32; i += NT) {
    const bool v = i < n && scores[i] > 0.f;
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) active[i >> 5] = bits;
    if (v) last = i + 1;
  }
  if (last) atomicMax(&s_end, last);
  __syncthreads();
  const int end = s_end;
  const int end_w = (end + 31) >> 5;

  int start_w = 0;
  for (int k = 0; k < max_det; ++k) {
    if (tid < 32) {                      // first active row at or after start_w
      int pick = -1;
      for (int w0 = start_w; w0 < end_w; w0 += 32) {
        const int w = w0 + lane;
        const uint32_t word = w < end_w ? active[w] : 0u;
        const uint32_t nz = __ballot_sync(0xffffffffu, word != 0u);
        if (nz) {
          const int src = __ffs(nz) - 1;
          const uint32_t wv = __shfl_sync(0xffffffffu, word, src);
          pick = ((w0 + src) << 5) + __ffs(wv) - 1;
          break;
        }
      }
      if (lane == 0) s_pick = pick;
    }
    __syncthreads();
    const int p = s_pick;
    if (p < 0) break;                    // the same p in every thread
    if (tid == 0) {
      out_idx[k] = p;
      out_valid[k] = 1;
    }
    const float4 pb = boxes[p];
    const float pa = area_of(pb);
    const int lim = end_w * 32;
    for (int i0 = (p & ~31) + tid; i0 < lim; i0 += NT * UNROLL) {
      uint32_t word[UNROLL];
      bool act[UNROLL];
      float4 b[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * NT;
        word[u] = i < lim ? active[i >> 5] : 0u;
        act[u] = i < end && ((word[u] >> (i & 31)) & 1u);
        b[u] = act[u] ? boxes[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * NT;
        if (i >= lim) break;             // warp-uniform: lim and i - lane are multiples of 32
        const bool drop = act[u] && (i == p || overlaps(b[u], pb, pa, t));
        const uint32_t m = __ballot_sync(0xffffffffu, drop);
        if (lane == 0 && m) active[i >> 5] = word[u] & ~m;
      }
    }
    start_w = p >> 5;
    __syncthreads();
  }
}

}  // namespace

// boxes: (batch, n, 4) float32 xyxy with the class offset applied, 16-byte
// aligned; scores: (batch, n) float32, each row sorted descending, <= 0
// marking invalid rows.  out_idx: (batch, max_det) int32, -1 past the last
// pick; out_valid: (batch, max_det) uint8.
extern "C" int mk_nms_greedy(const float* boxes, const float* scores, int batch, int n,
                             float t, int max_det, int* out_idx, uint8_t* out_valid,
                             void* stream) {
  if (batch < 1 || n < 1 || max_det < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)((n + 31) / 32) * sizeof(uint32_t);
  if (smem > 220 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_greedy_kernel<<<batch, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(boxes), scores, n, t, max_det, out_idx, out_valid);
  return static_cast<int>(cudaGetLastError());
}
