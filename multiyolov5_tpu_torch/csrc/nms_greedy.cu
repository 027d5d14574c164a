// K5: sequential greedy NMS truncated at max_det, over up to ~1.8 M
// score-sorted candidates per image, one thread-block cluster per image.
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
// (ops/kernels/nms_greedy.py) index for index.  The comparison is decided
// without the division where that is exact (iou_above).
//
// The input must be sorted by descending score, with rows of score <= 0
// invalid: ops/nms.py's top_k guarantees it (ties lower index first, as
// lax.top_k).  The highest-scoring active row is then the first active
// row, so a pick is a find-first-set over the active rows, not an argmax
// over scores, and every row before a pick is inactive.
//
// Design.  An image's list is cut into S contiguous slices of `rows` rows
// (a multiple of 32), one per CTA of a cluster of S CTAs (S <= 16, on S
// SMs, NT = 512 threads a CTA); ops/kernels/nms_greedy.py `plan` picks S,
// `rows` and where the boxes live.  Each CTA keeps its slice's active
// flags as a bitmask in shared memory and, when they fit (`RESIDENT`), its
// boxes (float4) and their areas too; otherwise it reads the boxes from
// device memory as float4.  Thread `tid` owns rows tid + j NT of its slice,
// so warp w owns bitmask words w + j NT/32: no row or word has a second
// reader or writer inside the CTA, and no atomics touch the bitmask.
//
// A pick is the lowest first-active row over the slices (slices are in
// row order, so this is the list's first active row).  Per pick:
//   1. a __syncthreads: every warp has written its first active row (by
//      pick parity); warp 0 takes their minimum, this slice's candidate;
//   2. lanes r < S of warp 0 push the candidate (row and box, 32 bytes)
//      into CTA r's inbox with st.async, each store counted by CTA r's
//      mbarrier of this pick's parity (expecting S x 32 bytes);
//   3. every warp waits on its own CTA's mbarrier, then takes the minimum
//      row over the inbox and that row's box from it: every CTA computes
//      the same pick from the same candidates, so the stop ("no active
//      row") is uniform over the cluster.  One slice (S = 1) skips 2-3:
//      every warp takes the pick from the warps' rows directly;
//   4. each warp tests its slice's active rows at or after the pick
//      against it, clears the dropped bits with one ballot per word (the
//      pick drops itself) and writes the first row still set in its words.
//      Words with no active bit cost no box read and no test; a slice that
//      ends before the pick skips the pass.
// Inboxes, mbarriers and warp rows are double-buffered by pick parity.  A
// CTA pushes pick k + 2's candidate into a buffer only after it has every
// slice's pick k + 1 candidate, which each CTA sends after its warps read
// pick k's: no buffer is overwritten before it is read.  There is no
// cluster barrier a pick: one before the loop (every CTA runs and its
// mbarriers are initialised) and one after it.
//
// What bounds it on an H100: latency.  The work is at most max_det
// dependent steps; the bytes (20 B a row) and the ~17 flops per IoU test
// are far below the card's rates.  A step costs the pass (instruction
// issue over the slice's active words: ~60 instructions a word, ~59 words
// a CTA at 30000 rows over 16 CTAs), a __syncthreads, warp 0's reduction
// and push, and the one-way latency of the pushes; the first form (one
// CTA an image, boxes in L2, two __syncthreads and a find-first scan a
// step) passed over the whole list on one SM.
#include <cooperative_groups.h>

#include <climits>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;                       // threads a CTA
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_MAX = 227 * 1024 - 2048;   // dynamic, below the static inboxes
constexpr int NO_ROW = INT_MAX;
constexpr int UNROLL = 4;                     // words a warp has in flight

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// inter of IoU(row, pick), nms_kernel.py:68-70's form
__device__ __forceinline__ float intersection(float4 b, float4 p) {
  const float iw = fmaxf(__fsub_rn(fminf(b.z, p.z), fmaxf(b.x, p.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(b.w, p.w), fmaxf(b.y, p.y)), 0.f);
  return __fmul_rn(iw, ih);
}

// inter / (area_b + area_p - inter + 1e-9) > t in nms_kernel.py:71-72's
// operation order.  Where t, and t x den rounded, are normal floats (then
// den > 0), inter above t x den by 16 ulps or below it by 16 ulps decides
// the rounded quotient's side of t exactly (each of the three roundings
// moves a value by at most 1 ulp), so only the rows in between divide.
__device__ __forceinline__ bool iou_above(float inter, float area_b, float area_p, float t) {
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_b, area_p), inter), 1e-9f);
  const float td = __fmul_rn(t, den);
  if (t >= 1e-30f && td >= 1e-30f && td <= 1e30f) {
    if (inter > __fmul_rn(td, 1.000002f)) return true;
    if (inter < __fmul_rn(td, 0.999998f)) return false;
  }
  return __fdiv_rn(inter, den) > t;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into the shared memory of CTA `rank` of the cluster at the
// address `p` has in this CTA, counted by that CTA's mbarrier `bar`
__device__ __forceinline__ void push16(const void* p, const uint64_t* bar, int rank,
                                       uint4 v) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar) : "memory");
}

// Wait for the phase of `parity` of an mbarrier that remote stores
// complete.  A push that never arrives traps after ~2^22 polls rather than
// hang.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned n = 0; !done; ++n) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (n == (1u << 22)) __trap();
  }
}

// A slice's first active row (list index, NO_ROW if none) and its box
struct Cand {
  float4 box;
  int row;
  int pad[3];
};

// Dynamic shared memory of a CTA of `rows` rows: boxes (16 B) and areas
// (4 B) when resident, then the active bitmask (a bit a row).
size_t smem_bytes(int rows, bool resident) {
  return (resident ? (size_t)rows * 20 : 0) + (size_t)rows / 8;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(NT)
nms_cluster_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                   int n, int rows, float t, int max_det, int* __restrict__ out_idx,
                   uint8_t* __restrict__ out_valid) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + (size_t)rows * 16);
  uint32_t* active = reinterpret_cast<uint32_t*>(smem + (RESIDENT ? (size_t)rows * 20 : 0));
  __shared__ Cand inbox[2][MAX_CLUSTER];   // every slice's candidate, by pick parity
  __shared__ __align__(8) uint64_t full[2];  // completes when the S candidates are in
  __shared__ int wmin[2][NW];              // each warp's first active row in the slice

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / S;
  const int row0 = rank * rows;
  const int len = max(0, min(rows, n - row0));   // rows of this slice
  const int nw = rows >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  boxes += (size_t)img * n;
  scores += (size_t)img * n;
  out_idx += (size_t)img * max_det;
  out_valid += (size_t)img * max_det;

  if (rank == 0)
    for (int k = tid; k < max_det; k += NT) {
      out_idx[k] = -1;
      out_valid[k] = 0;
    }
  int first = NO_ROW;
  // rows is a multiple of 32 and NT of 32, so each warp covers whole words
  for (int i = tid; i < rows; i += NT) {
    const bool v = i < len && scores[row0 + i] > 0.f;
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) active[i >> 5] = bits;
    if (first == NO_ROW && bits) first = (i & ~31) + __ffs(bits) - 1;
    if (RESIDENT) {
      const float4 b = i < len ? __ldg(boxes + row0 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      sbox[i] = b;
      sarea[i] = area_of(b);
    }
  }
  if (lane == 0) wmin[0][warp] = first;
  if (S > 1) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&full[0])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&full[1])));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_barrier();                           // every CTA runs, its mbarriers ready
  }

  for (int k = 0;; ++k) {
    const int par = k & 1;
    __syncthreads();                             // every warp's row of wmin[par] is in
    if (k == max_det) break;
    int p;
    float4 pb;
    if (S == 1) {
      p = __reduce_min_sync(0xffffffffu, lane < NW ? wmin[par][lane] : NO_ROW);
      if (p == NO_ROW) break;
      pb = RESIDENT ? sbox[p] : __ldg(boxes + p);
    } else {
      if (warp == 0) {
        const int m = __reduce_min_sync(0xffffffffu, lane < NW ? wmin[par][lane] : NO_ROW);
        if (lane == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                       :: "r"(smem_u32(&full[par])), "r"(S * (int)sizeof(Cand)) : "memory");
        if (lane < S) {                          // lane r sends the candidate to rank r
          const float4 b = m == NO_ROW ? make_float4(0.f, 0.f, 0.f, 0.f)
                                       : RESIDENT ? sbox[m] : __ldg(boxes + row0 + m);
          Cand* dst = &inbox[par][rank];
          push16(&dst->box, &full[par], lane, make_uint4(__float_as_uint(b.x),
                 __float_as_uint(b.y), __float_as_uint(b.z), __float_as_uint(b.w)));
          push16(&dst->row, &full[par], lane,
                 make_uint4(m == NO_ROW ? NO_ROW : row0 + m, 0u, 0u, 0u));
        }
      }
      mbar_wait(&full[par], (k >> 1) & 1);
      const int row = lane < S ? inbox[par][lane].row : NO_ROW;
      p = __reduce_min_sync(0xffffffffu, row);
      if (p == NO_ROW) break;                    // the same p in every CTA of the cluster
      pb = inbox[par][__ffs(__ballot_sync(0xffffffffu, row == p)) - 1].box;
    }
    if (rank == 0 && tid == 0) {
      out_idx[k] = p;
      out_valid[k] = 1;
    }
    const int lp = p - row0;                     // the pick's row in this slice
    int found = NO_ROW;
    if (lp < len) {                              // else no row of this slice is active
      const float pa = area_of(pb);
      const int sw = max(lp, 0) >> 5;            // words before the pick's are empty
      const int w_start = warp + (max(sw - warp, 0) + NW - 1) / NW * NW;
      for (int w0 = w_start; w0 < nw; w0 += NW * UNROLL) {
        uint32_t word[UNROLL];
        float4 b[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int w = w0 + u * NW;
          word[u] = w < nw ? active[w] : 0u;
          b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if ((word[u] >> lane) & 1u)
            b[u] = RESIDENT ? sbox[(w << 5) + lane] : __ldg(boxes + row0 + (w << 5) + lane);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (word[u] == 0u) continue;           // warp-uniform
          const int w = w0 + u * NW;
          const int i = (w << 5) + lane;
          bool drop = false;
          if ((word[u] >> lane) & 1u) {
            const float inter = intersection(b[u], pb);
            // no overlap: the quotient is +-0 or NaN, never above t >= 0
            drop = i == lp || (!(inter == 0.f && t >= 0.f) &&
                               iou_above(inter, RESIDENT ? sarea[i] : area_of(b[u]), pa, t));
          }
          const uint32_t m = __ballot_sync(0xffffffffu, drop);
          const uint32_t left = word[u] & ~m;
          if (lane == 0 && m) active[w] = left;
          if (found == NO_ROW && left) found = (w << 5) + __ffs(left) - 1;
        }
      }
    }
    if (lane == 0) wmin[par ^ 1][warp] = found;
  }
  if (S > 1) cluster_barrier();                  // no CTA leaves while pushes may reach it
}

template <bool RESIDENT>
cudaError_t launch(const float* boxes, const float* scores, int batch, int n, float t,
                   int max_det, int* out_idx, uint8_t* out_valid, int cluster, int rows,
                   int smem, cudaStream_t s) {
  auto kernel = nms_cluster_kernel<RESIDENT>;
  // The host work is done once and kept, as the paths that launch K5 are
  // host-bound: the shared-memory cap and the non-portable cluster sizes are
  // set once per kernel and device, at its first launch (outside any
  // CUDA-graph capture that later launches may run under), and the card is
  // asked once per (device, cluster, smem) how many such clusters it places.
  static std::mutex mu;
  static std::map<int, bool> attr_set;
  static std::map<std::tuple<int, int, int>, int> placed;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attr_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto key = std::make_tuple(dev, cluster, smem);
  auto it = placed.find(key);
  if (it == placed.end()) {
    int fit = 0;                                 // clusters of this shape the card can place
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return e;
    it = placed.emplace(key, fit).first;
  }
  if (it->second < 1) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const float4*>(boxes), scores, n, rows,
                         t, max_det, out_idx, out_valid);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory a CTA of `rows` rows takes, boxes resident
// (resident != 0) or not: ops/kernels/nms_greedy.py `smem_bytes`.
extern "C" int mk_nms_greedy_smem_bytes(int rows, int resident) {
  return static_cast<int>(smem_bytes(rows, resident != 0));
}

// boxes: (batch, n, 4) float32 xyxy with the class offset applied, 16-byte
// aligned; scores: (batch, n) float32, each row sorted descending, <= 0
// marking invalid rows.  out_idx: (batch, max_det) int32, -1 past the last
// pick; out_valid: (batch, max_det) uint8.  The plan (ops/kernels/
// nms_greedy.py `plan`): `cluster` CTAs an image of NT threads, each
// over `rows` rows (a multiple of 32, no slice empty), `smem` dynamic
// shared-memory bytes, boxes in shared memory if `resident`.  A plan the
// kernel does not take, or a cluster the card cannot place, returns an
// error and launches nothing.
extern "C" int mk_nms_greedy(const float* boxes, const float* scores, int batch, int n,
                             float t, int max_det, int* out_idx, uint8_t* out_valid,
                             int cluster, int rows, int smem, int resident, void* stream) {
  if (batch < 1 || n < 1 || max_det < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
      rows < 32 || rows % 32 || (long long)rows * cluster < n ||
      (long long)rows * (cluster - 1) >= n || smem > SMEM_MAX ||
      (size_t)smem != smem_bytes(rows, resident != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      resident ? launch<true>(boxes, scores, batch, n, t, max_det, out_idx, out_valid, cluster,
                              rows, smem, s)
               : launch<false>(boxes, scores, batch, n, t, max_det, out_idx, out_valid, cluster,
                               rows, smem, s));
}
