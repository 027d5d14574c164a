// K3: exact greedy NMS over at most 1024 score-sorted candidates, with the
// kept rows packed into (idx, valid) in the same launch.
//
// Replaces nms_fixpoint_pallas (multiyolov5_tpu/ops/pallas/nms_fixpoint_kernel.py:77).
// Same function: keep[i] = valid[i] && !any_{j<i}(keep[j] && S[j][i]) over
// candidates sorted by descending score, valid = score > 0, and
//   S[j][i] = inter(j, i) * (1 + t) > t * (area_j + area_i)
// the division-free IoU > t test of the TPU kernel (:46-53).  The plain
// version (ops/kernels/nms.py) uses the same test, with every product and
// sum rounded once (the __f*_rn intrinsics forbid FMA contraction), so the
// two keep masks are bit-equal.  The JAX package's CPU scan tests
// inter / (a_i + a_j - inter + 1e-9) > t instead, which can differ for a
// pair within an ulp of the threshold.  The packed output is the JAX
// _pack_keep (multiyolov5_tpu/ops/nms.py:79-90): the first max_det kept rows
// in index order, -1 / invalid past them.
//
// What bounds it on an H100: latency.  The work is ~0.5 M pair tests of 13
// float32 operations (0.0001 ms at the card's rate) and a walk over 1024
// rows whose every kept row can remove later ones.  The first form
// built the mask on one SM with thread j testing every i > j alone (warp 0
// ~1000 tests, warp 31 ~16), then swept all n rows one by one in one warp,
// each step behind a global load: 0.153 ms, and 0.216 ms with the pack
// (nine more device operations) after it.
//
// Design.  S CTAs of 1024 threads (ops/kernels/nms.py `plan`) build the
// mask S as 32-bit words: word w of row j holds S[j][32 w + b] (bits for
// i > j only), in a [32][n + 1] word-major array.  The items (j, w) of word
// w are its rows j < 32 (w + 1); word w is paired with word nw - 1 - w so
// that every pair holds ~33 x 32 items, and CTA c takes pairs c, c + S, ...
// Every CTA holds all boxes and areas in shared memory; an item tests its
// row's box against the word's 32 boxes, which a warp reads as broadcasts.
// The S CTAs are one thread-block cluster: each stores its words straight
// into CTA 0's shared memory (DSMEM), and a cluster barrier hands the mask
// to CTA 0, which sweeps and packs, all in one launch.  (A grid of CTAs
// writing the mask to device memory for a second, sweeping launch read
// 0.009-0.015 ms slower at every CTA count.)
// The sweep is one warp, lane w holding word w of `removed`.  It walks the
// words in order: the word's candidates are its valid rows not yet removed
// (one shuffle); lane j holds row 32 W + j's bits of the word (its
// diagonal block).  One OR-reduction finds the candidates that another
// candidate of the word suppresses; the others are kept at once, and only
// where there are such candidates does a straight-line pass over the 32
// rows resolve them in order (their bits by shuffles off the chain, the
// chain a select a row).  Then only
// the kept rows that suppress a row of a later word (a bit a row, found by
// all threads before the sweep) OR their words into `removed`, a load per
// lane each.  A removed, invalid or harmless row costs nothing, and no
// global load sits on the chain.  The keep words' prefix counts place each
// kept row in the packed output.
#include <cooperative_groups.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXN = 1024;
constexpr int NT = 1024;                    // threads a CTA
constexpr int MAX_CTAS = 16;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of a CTA: boxes (16 B) and areas (4 B) of the n
// rows, then the [32][n + 1] mask (written and read in CTA 0 only).
size_t smem_bytes(int n) { return (size_t)n * 20 + (size_t)32 * (n + 1) * 4; }

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Stage the boxes and areas into shared memory.
__device__ __forceinline__ void load_boxes(const float4* __restrict__ boxes, int n,
                                           float4* sbox, float* sarea) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const float4 b = __ldg(boxes + i);
    sbox[i] = b;
    sarea[i] = area_of(b);
  }
}

// Row j's box (area aj) overlaps row i's beyond t: the division-free test.
__device__ __forceinline__ bool overlaps(float4 bj, float aj, float4 bi, float ai, float t,
                                         float one_plus_t) {
  const float iw = fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  return __fmul_rn(inter, one_plus_t) > __fmul_rn(t, __fadd_rn(aj, ai));
}

// Word w of row j of S: bit b set if row i = 32 w + b (j < i < n) overlaps
// row j beyond t, in the TPU kernel's order of operations.  A whole word
// past row j's own (every warp's case but the diagonal's) tests all 32
// rows without a bound check.
__device__ __forceinline__ uint32_t row_word(const float4* sbox, const float* sarea, int n,
                                             int j, int w, float t, float one_plus_t) {
  const float4 bj = sbox[j];
  const float aj = sarea[j];
  const int i0 = 32 * w;
  uint32_t bits = 0;
  if (i0 > j && i0 + 32 <= n) {
#pragma unroll 8
    for (int b = 0; b < 32; ++b)
      bits |= overlaps(bj, aj, sbox[i0 + b], sarea[i0 + b], t, one_plus_t) ? 1u << b : 0u;
    return bits;
  }
#pragma unroll 8
  for (int b = 0; b < 32; ++b) {
    const int i = i0 + b;
    if (i > j && i < n && overlaps(bj, aj, sbox[i], sarea[i], t, one_plus_t)) bits |= 1u << b;
  }
  return bits;
}

// CTA `rank` of `S` builds its pairs of words into mask[w][j] at `mask`
// (stride n + 1 words), CTA 0's shared memory.
__device__ __forceinline__ void build(const float4* sbox, const float* sarea, int n, int rank,
                                      int S, float t, float one_plus_t, uint32_t* mask) {
  const int nw = (n + 31) >> 5;
  for (int p = rank; p < (nw + 1) / 2; p += S) {
    const int wa = nw - 1 - p, wb = p;
    const int na = min(32 * (wa + 1), n);
    const int nb = wb == wa ? 0 : min(32 * (wb + 1), n);
    for (int k = threadIdx.x; k < na + nb; k += NT) {
      const int w = k < na ? wa : wb;
      const int j = k < na ? k : k - na;
      mask[w * (n + 1) + j] = row_word(sbox, sarea, n, j, w, t, one_plus_t);
    }
  }
}

// Each warp's valid bits (score > 0, row < n) into valid[warp].
__device__ __forceinline__ void load_valid(const float* __restrict__ scores, int n,
                                           uint32_t* valid) {
  const int t = threadIdx.x;
  const uint32_t bits = __ballot_sync(FULL, t < n && scores[t] > 0.f);
  if ((t & 31) == 0) valid[t >> 5] = bits;
}

// The sweep over the mask in shared memory (warp 0), then every thread
// writes the keep mask (if keep) and the packed (idx, valid) (if max_det).
__device__ void sweep_and_write(const uint32_t* mask, int n, const uint32_t* valid_w,
                                uint8_t* __restrict__ keep, int max_det,
                                long long* __restrict__ out_idx,
                                uint8_t* __restrict__ out_valid) {
  __shared__ uint32_t s_keep[32];
  __shared__ uint32_t s_any[32];
  __shared__ int s_off[32];
  __shared__ int s_total;
  const int stride = n + 1;
  const int nw = (n + 31) >> 5;
  const int tid = threadIdx.x, lane = tid & 31;
  {
    // the rows that suppress some row of a later word than their own
    uint32_t acc = 0u;
    if (tid < n)
      for (int w = (tid >> 5) + 1; w < nw; ++w) acc |= mask[w * stride + tid];
    const uint32_t b = __ballot_sync(FULL, acc != 0u);
    if (lane == 0) s_any[tid >> 5] = b;
  }
  __syncthreads();
  if (tid < 32) {
    uint32_t removed = 0, keepw = 0;
    const uint32_t validw = lane < nw ? valid_w[lane] : 0u;
    const uint32_t anyw = s_any[lane];
    for (int W = 0; W < nw; ++W) {
      const uint32_t cand = __shfl_sync(FULL, validw & ~removed, W);
      if (cand == 0u) continue;
      const int r = 32 * W + lane;                    // this lane's row
      const uint32_t d = r < n ? mask[W * stride + r] : 0u;   // its bits of word W
      // The word's greedy result: a candidate no candidate of the word
      // suppresses is kept; the rest (A) are walked in order, each kept
      // unless a kept row of the word suppresses it.
      const uint32_t own = (cand >> lane) & 1u ? d : 0u;
      const uint32_t A = cand & __reduce_or_sync(FULL, own);
      uint32_t kept = cand & ~A;
      if (A) {
        // straight-line over the 32 rows: the rows' bits come by shuffles
        // that do not wait on the walk, which is then a chain of selects
        uint32_t sup = __reduce_or_sync(FULL, (kept >> lane) & 1u ? d : 0u);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const uint32_t di = __shfl_sync(FULL, d, i);
          const bool take = ((A & ~sup) >> i) & 1u;
          kept |= take ? 1u << i : 0u;
          sup |= take ? di : 0u;
        }
      }
      if (lane == W) keepw = kept;
      // later words: OR in the words of the kept rows that suppress any.
      // Every lane loads (inside the mask: lane < 32); only words W + 1 ..
      // nw - 1 are ever read back.
      for (uint32_t s = kept & __shfl_sync(FULL, anyw, W); s; s &= s - 1)
        removed |= mask[lane * stride + 32 * W + __ffs(s) - 1];
    }
    const int cnt = __popc(keepw);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    s_keep[lane] = keepw;
    s_off[lane] = incl - cnt;
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
  for (int t = tid; t < n; t += NT) {
    const uint32_t kw = s_keep[t >> 5];
    const uint32_t kb = (kw >> (t & 31)) & 1u;
    if (keep) keep[t] = static_cast<uint8_t>(kb);
    if (kb && max_det > 0) {
      const int pos = s_off[t >> 5] + __popc(kw & ((1u << (t & 31)) - 1u));
      if (pos < max_det) out_idx[pos] = t;
    }
  }
  for (int t = tid; t < max_det; t += NT) {
    if (t >= s_total) out_idx[t] = -1;
    out_valid[t] = t < s_total;
  }
}

// The build over a cluster of S CTAs into CTA 0's shared memory, then CTA 0
// sweeps and packs.
__global__ void __launch_bounds__(NT)
nms_cluster_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int n,
                   float t, float one_plus_t, uint8_t* __restrict__ keep, int max_det,
                   long long* __restrict__ out_idx, uint8_t* __restrict__ out_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + (size_t)n * 16);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + (size_t)n * 20);
  __shared__ uint32_t valid_w[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // CTA 0's shared memory takes stores only once it runs: every CTA arrives
  // here and waits before its first store, the boxes loaded in between
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  load_boxes(boxes, n, sbox, sarea);
  if (rank == 0) load_valid(scores, n, valid_w);
  uint32_t* dst = S > 1 ? cluster.map_shared_rank(mask, 0) : mask;
  if (S > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
  __syncthreads();
  build(sbox, sarea, n, rank, S, t, one_plus_t, dst);
  if (S > 1)
    cluster.sync();                          // release / acquire: the mask is in CTA 0
  else
    __syncthreads();
  if (rank != 0) return;                     // no CTA reads another's memory from here
  sweep_and_write(mask, n, valid_w, keep, max_det, out_idx, out_valid);
}

// The shared-memory cap and the non-portable cluster sizes, set once, at
// the first launch.
cudaError_t set_attributes() {
  static std::mutex mu;
  static bool done = false;
  std::lock_guard<std::mutex> lock(mu);
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(nms_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(MAXN));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(nms_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// The dynamic shared memory of a CTA: ops/kernels/nms.py `smem_bytes`.
extern "C" int mk_nms_smem_bytes(int n) { return static_cast<int>(smem_bytes(n)); }

// boxes: (n, 4) float32 xyxy with the class offset applied, 16-byte
// aligned; scores: (n,) float32 sorted descending, <= 0 marking invalid
// rows.  keep: (n,) uint8 or null; out_idx (max_det,) int64 and out_valid
// (max_det,) uint8, written when max_det > 0.  The plan (ops/kernels/nms.py
// `plan`): a cluster of `ctas` CTAs, at most one a pair of mask words.
extern "C" int mk_nms(const float* boxes, const float* scores, int n, float t,
                      float one_plus_t, uint8_t* keep, int max_det, long long* out_idx,
                      uint8_t* out_valid, int ctas, void* stream) {
  const int pairs = ((n + 31) / 32 + 1) / 2;
  if (n < 1 || n > MAXN || max_det < 0 || ctas < 1 || ctas > MAX_CTAS || ctas > pairs ||
      (max_det > 0 && (!out_idx || !out_valid)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(n);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_cluster_kernel, reinterpret_cast<const float4*>(boxes),
                         scores, n, t, one_plus_t, keep, max_det, out_idx, out_valid);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
