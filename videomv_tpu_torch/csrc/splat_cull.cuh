// What the splat composite's two culled kernels share: the forward in
// splat_composite.cu and its backward in splat_composite_bwd.cu. A pair's
// alpha at a pixel, rounded op by op; the culling of a staged batch of
// (tile, Gaussian) pairs to the 8 x 4 pixel blocks its warps own; the
// cp.async staging; the (view, tile) items of the persistent grid and the
// heaviest-first order the C entry points form on the stream.
//
// The culling box (cull_box) and block test (block_meets). A pair is alive
// at a pixel only where o exp(power) >= 1/255, i.e. where
// Q = (1/2) q^T M q <= tau = ln(255 o) with M = [[a, b], [b, c]],
// q = (dx, dy). For a positive-definite M that set
// lies in |dx| <= sqrt(2 tau c / det M), |dy| <= sqrt(2 tau a / det M). The
// margin makes the box hold every point the rounded arithmetic of
// pair_alpha calls alive (u = 2^-24; the box's own arithmetic is rounded op
// by op, each step's error covered below):
//   * power is computed with 6 roundings; its error is at most
//     6u (a dx^2 + c dy^2) <= 12u (1 + 2 ac / det) Q on the level set of Q,
//     so the box is taken at level tau / (1 - k), k = 32u (1 + 2 ac / det);
//     a pair with k >= 1/2 is treated as degenerate;
//   * expf (2 ulp), the product with o and logf (1 ulp) move tau by a few u:
//     tau is taken as ln(255 o) (1 + 2^-12) + 2^-12;
//   * det is taken as ac - b^2 - 4u (ac + b^2), below the true determinant of
//     the stored a, b, c; the extents are widened by 2^-12 for the division
//     and square root;
//   * the box is tested against fl(x - mx), the very differences pair_alpha
//     forms (rounding is monotone), so the means' rounding needs no margin;
//   * a block the box meets is kept when Q's least value over it, evaluated
//     at the clamped minimizer of each edge (or 0 when it holds the mean) and
//     lowered by 16u of the magnitude of Q's terms (q_low: 6 roundings, and
//     the second-order excess of a minimizer found with rounding), is at most
//     the level (1 + 2^-12) tau / (1 - k);
//   * a pair with o < (1/255)(1 - 2^-10) reaches no pixel (with exp(power)
//     <= 1, o exp(power) stays below the cut through 5u of rounding);
//   * a degenerate pair (a <= 0, c <= 0, det <= 0, a non-finite ac or b^2,
//     k >= 1/2, a mean beyond 2^20 pixels, or a NaN in the geometry or the
//     opacity) meets every block: with a NaN opacity alpha is 0.99 wherever
//     power <= 0.
// The plain PyTorch mirror is videomv_tpu_torch/ops/splat.py::cull_masks. It
// does the same fp32 operations in the same order: every product that feeds
// a sum is written as __fmul_rn / __fadd_rn, so nvcc contracts none into an
// FMA. Only logf may differ from torch.log by an ulp, so the mirror's tests
// check the margin analysis on the CPU; the kernels' own masks are checked on
// the card against the per-tile kernels, which cull nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each kernel source gets its own copy (no -rdc).
namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPixels / 32;
constexpr int kBlockW = 8, kBlockH = 4;  // a warp's pixel block in the culled kernels
constexpr float kAlphaMin = 1.f / 255.f;
// the culling box's margins (see the header), exact powers of two
constexpr float kCutMargin = 9.765625e-4f;           // 2^-10: the opacity cut
constexpr float kTauMargin = 2.44140625e-4f;         // 2^-12: tau and the extents
constexpr float kPowerErr = 1.9073486328125e-6f;     // 2^-19 = 32u: the power's rounding
constexpr float kDetErr = 2.384185791015625e-7f;     // 2^-22 = 4u: the determinant's
constexpr float kQErr = 9.5367431640625e-7f;         // 2^-20 = 16u: Q at a point
constexpr float kMeanMax = 1048576.f;                // 2^20 pixels

// power = -1/2 (a dx^2 + c dy^2) - b dx dy at one (pixel, pair) point, with
// the forward's roundings in its order (a contracted FMA would move alpha
// across the 1/255 cut at some points)
__device__ __forceinline__ float pair_power(float dx, float dy, float a, float b, float c) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
}

// alpha of one (pixel, pair) point, 0 where the pair is dead there
__device__ __forceinline__ float pair_alpha(float px, float py, float mx, float my, float a,
                                            float b, float c, float op) {
  const float power = pair_power(px - mx, py - my, a, b, c);
  const float alpha = fminf(0.99f, __fmul_rn(op, expf(power)));
  return (power > 0.f || alpha < kAlphaMin) ? 0.f : alpha;
}

__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// A lower bound of Q = (1/2)(a x^2 + c y^2) + b x y at the point (x, y):
// its fp32 value less 16u of the sum of its terms' magnitudes, which covers
// the 6 roundings of the evaluation (and the second-order error of taking an
// edge's minimizer with rounding).
__device__ __forceinline__ float q_low(float a, float b, float c, float x, float y) {
  const float half =
      __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, x), x), __fmul_rn(__fmul_rn(c, y), y)));
  const float bxy = __fmul_rn(__fmul_rn(b, x), y);
  return __fsub_rn(__fadd_rn(half, bxy), __fmul_rn(kQErr, __fadd_rn(half, fabsf(bxy))));
}

// The pair's conservative box, as the 8-bit mask of the warp blocks (bit
// by * 2 + bx: bx the block column 0-1, by the block row 0-3) of the tile
// whose top-left pixel is (x0, y0) that it meets, and the level *t of Q that
// bounds its alive points (+inf for a degenerate pair, whose blocks all stay;
// see the header for the margin).
__device__ __forceinline__ uint32_t cull_box(float mx, float my, float a, float b, float c,
                                             float op, float x0, float y0, float* t) {
  *t = __int_as_float(0x7F800000);  // +inf
  if (op < kAlphaMin * (1.f - kCutMargin)) return 0u;
  const float tau =
      __fadd_rn(__fmul_rn(fmaxf(logf(op / kAlphaMin), 0.f), 1.f + kTauMargin), kTauMargin);
  const float ac = a * c, bb = b * b;
  const float det = __fsub_rn(__fsub_rn(ac, bb), __fmul_rn(kDetErr, __fadd_rn(ac, bb)));
  const float k = kPowerErr * (1.f + 2.f * ac / det);
  const bool ok = op == op && a > 0.f && c > 0.f && det > 0.f && ac <= 3.0e38f &&
                  bb <= 3.0e38f && k < 0.5f && fabsf(mx) < kMeanMax && fabsf(my) < kMeanMax;
  if (!ok) return 0xFFu;
  const float level = tau / (1.f - k);
  const float ex = sqrtf(2.f * level * c / det) * (1.f + kTauMargin);
  const float ey = sqrtf(2.f * level * a / det) * (1.f + kTauMargin);
  *t = level * (1.f + kTauMargin);
  uint32_t cols = 0u, mask = 0u;
#pragma unroll
  for (int bx = 0; bx < kTile / kBlockW; ++bx) {
    const float lo = x0 + float(bx * kBlockW);
    // "not outside": a NaN extent or difference keeps the block
    if (!((lo - mx) > ex) && !((lo + float(kBlockW - 1) - mx) < -ex)) cols |= 1u << bx;
  }
#pragma unroll
  for (int by = 0; by < kTile / kBlockH; ++by) {
    const float lo = y0 + float(by * kBlockH);
    if (!((lo - my) > ey) && !((lo + float(kBlockH - 1) - my) < -ey))
      mask |= cols << (by * (kTile / kBlockW));
  }
  return mask;
}

// The exact test of one block the box meets: Q's least value over the
// block's rectangle of differences [X0, X1] x [Y0, Y1] (0 if it holds the
// mean, else on an edge, at the edge's clamped 1-D minimizer; ba = -b / a and
// bc = -b / c give dx* = ba dy, dy* = bc dx), bounded from below through the
// rounding, against the level t. A NaN keeps the block.
__device__ __forceinline__ bool block_meets(float mx, float my, float a, float b, float c,
                                            float t, float ba, float bc, float xl, float yl) {
  const float X0 = xl - mx, X1 = xl + float(kBlockW - 1) - mx;
  const float Y0 = yl - my, Y1 = yl + float(kBlockH - 1) - my;
  if (X0 <= 0.f && X1 >= 0.f && Y0 <= 0.f && Y1 >= 0.f) return true;
  return !(q_low(a, b, c, X0, clamp_to(bc * X0, Y0, Y1)) > t &&
           q_low(a, b, c, X1, clamp_to(bc * X1, Y0, Y1)) > t &&
           q_low(a, b, c, clamp_to(ba * Y0, X0, X1), Y0) > t &&
           q_low(a, b, c, clamp_to(ba * Y1, X0, X1), Y1) > t);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Item {
  int view, tile, count;
  long long start;
};

__device__ __forceinline__ Item item_at(int i, const int* order, const int* tile_start,
                                        const int* tile_count, int n_tiles) {
  const int flat = __ldg(order + i);
  return Item{flat / n_tiles, flat % n_tiles, __ldg(tile_count + flat), __ldg(tile_start + flat)};
}

// The culling state of one staged batch of kBatch pairs, in shared memory.
template <int kBatch>
struct CullSmem {
  float4 rec[kBatch][3];            // mx my a b | c op r g | b depth - -
  float4 cull[kBatch];              // t, -b / a, -b / c of the exact tests
  uint32_t keep[kBatch];            // the blocks that pass the exact test, by pair
  uint16_t tests[kBatch * kWarps];  // (pair << 3 | block) to test exactly
  uint32_t words[kWarps][kBatch / 32];  // by warp: its bit of each pair, 32 pairs a word
  uint8_t list[kWarps][kBatch];     // each warp's pairs of the batch, in order
  int n_tests;                      // zero on entry to cull_batch, and on return
};

// Culls a staged batch of n pairs of the tile whose top-left pixel is
// (x0, y0) to the warp blocks they may reach. Thread tid < n brings pair
// tid's fields: it writes the pair's record and forms its conservative box;
// each (block, pair) the box meets is queued, and the CTA's threads share the
// queue to test each block exactly, which clears the blocks an elongated or
// tilted splat's box meets but the splat does not. Ballots then turn the
// masks into one 32-bit word per (warp, 32 pairs). Holds four barriers; the
// last makes the records, masks and words visible to every thread.
template <int kBatch>
__device__ __forceinline__ void cull_batch(CullSmem<kBatch>& cs, int tid, int n, float x0,
                                           float y0, float mx, float my, float a, float b,
                                           float c, float op, float r, float g, float bl,
                                           float d) {
  static_assert(kBatch % 32 == 0 && kBatch <= kPixels, "one thread a pair, whole warps");
  const int warp = tid >> 5, lane = tid & 31;
  uint32_t box = 0u;
  float t = 0.f;
  if (tid < n) {
    box = cull_box(mx, my, a, b, c, op, x0, y0, &t);
    cs.rec[tid][0] = make_float4(mx, my, a, b);
    cs.rec[tid][1] = make_float4(c, op, r, g);
    cs.rec[tid][2] = make_float4(bl, d, 0.f, 0.f);
    cs.cull[tid] = make_float4(t, -b / a, -b / c, 0.f);
  }
  // a degenerate pair (t = +inf) keeps its blocks untested
  const bool test = t < __int_as_float(0x7F800000);
  if (tid < kBatch) cs.keep[tid] = test ? 0u : box;
  {
    // queue slots: a warp-aggregated add, then each lane's prefix
    const int mine = test ? __popc(box) : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += v;
    }
    int base0 = 0;
    if (lane == 31) base0 = atomicAdd(&cs.n_tests, incl);
    base0 = __shfl_sync(0xFFFFFFFFu, base0, 31);
    int slot = base0 + incl - mine;
    for (uint32_t m = test ? box : 0u; m; m &= m - 1)
      cs.tests[slot++] = uint16_t((tid << 3) | (__ffs(m) - 1));
  }
  __syncthreads();  // the queue is written
  for (int q = tid; q < cs.n_tests; q += kPixels) {
    const int e = cs.tests[q], i = e >> 3, w = e & 7;
    const float4 r0 = cs.rec[i][0], cl = cs.cull[i];
    if (block_meets(r0.x, r0.y, r0.z, r0.w, cs.rec[i][1].x, cl.x, cl.y, cl.z,
                    x0 + float((w & 1) * kBlockW), y0 + float((w >> 1) * kBlockH)))
      atomicOr(&cs.keep[i], 1u << w);
  }
  __syncthreads();  // the tests are done
  const uint32_t mask = tid < n ? cs.keep[tid] : 0u;
  uint32_t mine = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, (mask >> w) & 1u);
    if (lane == w) mine = word;
  }
  if (lane < kWarps && warp < kBatch / 32) cs.words[lane][warp] = mine;
  __syncthreads();  // records, masks and words visible
  if (tid == 0) cs.n_tests = 0;  // the queue is consumed
}

// This warp's pairs of the batch (its bit set), compacted into cs.list in
// pair order, so the walk is a counted loop the compiler can unroll and run
// ahead in. Returns their number.
template <int kBatch>
__device__ __forceinline__ int warp_pairs(CullSmem<kBatch>& cs, int warp, int lane, int n) {
  int cnt = 0;
  const int nw = (n + 31) >> 5;
  for (int k = 0; k < nw; ++k) {
    const uint32_t word = cs.words[warp][k];
    if ((word >> lane) & 1u)
      cs.list[warp][cnt + __popc(word & ((1u << lane) - 1u))] = uint8_t((k << 5) + lane);
    cnt += __popc(word);
  }
  __syncwarp();
  return cnt;
}

// The persistent grid of a culled kernel: as many CTAs of kPixels threads as
// fit on every SM at once, at most one an item.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t dyn_smem, int n_items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPixels, dyn_smem);
  *grid = max(1, min(n_items, sms * max(per_sm, 1)));
  return e;
}

// ------------------------------------------------------ heaviest-first order

constexpr int kRankThreads = 256;  // items i of one CTA
constexpr int kRankSpan = 512;     // items j one CTA compares them with

// rank[i] += #{j in this CTA's span: c_j > c_i, or c_j == c_i and j < i},
// summed over the spans by integer atomics (the sum does not depend on their
// order): rank[i] is item i's place by descending count, ties in index order.
__global__ void __launch_bounds__(kRankThreads)
order_rank_kernel(const int* __restrict__ tile_count, int* __restrict__ rank, int n) {
  __shared__ int s_count[kRankSpan];
  const int j0 = blockIdx.y * kRankSpan;
  const int span = min(kRankSpan, n - j0);
  for (int t = threadIdx.x; t < span; t += kRankThreads) s_count[t] = tile_count[j0 + t];
  __syncthreads();
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  if (i >= n) return;
  const int ci = tile_count[i];
  int r = 0;
#pragma unroll 8
  for (int t = 0; t < span; ++t) {
    const int cj = s_count[t];
    r += (cj > ci) | ((cj == ci) & (j0 + t < i));
  }
  if (r) atomicAdd(rank + i, r);
}

__global__ void __launch_bounds__(kRankThreads)
order_scatter_kernel(const int* __restrict__ rank, int* __restrict__ order, int n) {
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  if (i < n) order[rank[i]] = i;
}

// The heaviest-first order of n items into order[n], on the stream: every
// item's place counted by comparing it with every other (rank[n] is scratch).
// n at most 65535 * kRankSpan.
inline cudaError_t launch_order(const int* tile_count, int* order, int* rank, int n,
                                cudaStream_t st) {
  const int blocks = (n + kRankThreads - 1) / kRankThreads;
  const int spans = (n + kRankSpan - 1) / kRankSpan;
  const cudaError_t e = cudaMemsetAsync(rank, 0, size_t(n) * sizeof(int), st);
  if (e != cudaSuccess) return e;
  order_rank_kernel<<<dim3(blocks, spans), kRankThreads, 0, st>>>(tile_count, rank, n);
  order_scatter_kernel<<<blocks, kRankThreads, 0, st>>>(rank, order, n);
  return cudaGetLastError();
}

// The scratch of a culled kernel's C entry point, int32 [2 n + 1]: the
// counter (zeroed here), then, when the caller gives no order, the
// heaviest-first order and its ranks, formed here. *ord is the order the
// kernel walks.
inline cudaError_t prepare_items(const int* tile_count, const int** ord, int* scratch, int n,
                                 cudaStream_t st) {
  if (*ord == nullptr) {
    const cudaError_t e = launch_order(tile_count, scratch + 1, scratch + 1 + n, n, st);
    if (e != cudaSuccess) return e;
    *ord = scratch + 1;
  }
  return cudaMemsetAsync(scratch, 0, sizeof(int), st);
}

}  // namespace
