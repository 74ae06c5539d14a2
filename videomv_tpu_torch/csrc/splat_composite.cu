// Tile composite of the Gaussian-splat rasterizer, forward (fp32).
//
// Replaces: videomv_tpu/ops/splat_pallas.py::_tile_kernel (launched by
// _composite_call). For each 16x16 pixel tile of each view it walks the
// tile's depth-ordered (tile, Gaussian) pairs front to back:
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy
//   alpha = min(0.99, o exp(power)), zeroed where power > 0 or alpha < 1/255
//   C += alpha T (r, g, b, depth);  T *= 1 - alpha
// and writes [5, 256] rows per tile: RGB before the background, 1 - T, depth.
// No early termination (the TPU kernel has none; adding one changes the
// output).
//
// The TPU kernel walks 512-pair chunks aligned to global 512 boundaries
// (masking each tile's head/tail overhang), runs its grid in order with one
// VMEM scratch, and takes the transmittance inside a chunk as an exclusive
// prefix of log(1 - alpha), one triangular MXU matmul. None of that is
// needed on Hopper: a pixel's running product is a register.
//
// What bounds it on the H100. The least work is the alpha rebuild (16 fp32
// operations) and the blend (11) at the alive (pixel, pair) points only, each
// live pair's payload read once (32 B packed, 40 B of the fp32 payload's
// rows) and the [5, 256] output of every tile. At the refine's 24 views of
// 256² 9 % of a segment's points are alive, and that bound is set by the
// bytes: 0.053 ms (packed) on an H100, against 0.30 ms for the work of
// walking every pixel against every pair of its tile. What stands between a
// kernel and it: the points that are not alive (a splat a few pixels across
// reaches a few rows of its tile), load imbalance (a tile's work is its pair
// count: 745 pairs a tile on average at 256², up to 2,285), staging that
// stalls the compositing, and, per alive point, the lanes of its warp that
// evaluate their pixel in lockstep for nothing.
//
// Two variants behind one C entry point, chosen by the caller:
//
// kCulled (served): a persistent grid (as many CTAs of 256 threads an SM as
//   fit: 3 at 80 registers) takes (view, tile) items from a global atomic
//   counter over an order by descending pair count, so the heaviest tiles
//   start first and the light ones fill the tail. The entry point forms that
//   order before the launch, on the stream (launch_order: every item's place
//   counted by comparing it with every other, a memset and two small
//   kernels). Each warp owns a compact 8-column x 4-row pixel block (8
//   blocks a tile). The tile's pairs are staged in batches of 256 by cp.async, double-buffered: the next
//   batch (or the next item's first) is in flight while the warps composite
//   the current one. Once a batch has landed, each thread takes one pair: it
//   unpacks the pair into a 12-float record (read back as three broadcast
//   float4 loads) and forms its conservative box, the 8-bit mask of the warp
//   blocks the box meets; each such (pair, block) is queued, and the CTA's
//   threads share the queue to test each block exactly (Q's least value over
//   the block), which clears the blocks an elongated or tilted splat's box
//   meets but the splat does not. Ballots turn the masks into one 32-bit word
//   per (warp, 32 pairs), each warp compacts its set bits into an index list
//   and walks it in pair order, a counted loop the compiler unrolls by 4. A pair
//   left out is dead at every pixel of the warp's block: alpha = 0 gives
//   w = 0 and T * 1 = T, so skipping it changes no bit, and the output is
//   bit-equal to kPerTile's. So is stopping a warp once all its pixels have
//   T == 0 exactly, checked once a batch.
// kPerTile (the first port): one CTA per (tile, view), one thread per
//   pixel, every pixel against every pair of its tile, batches of 256 pairs
//   staged by plain loads between two barriers. Kept for comparison; no
//   served path launches it.
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
// does the same fp32 operations in the same order: the kernel writes every
// product that feeds a sum as __fmul_rn / __fadd_rn, so nvcc contracts none
// into an FMA. Only logf may differ from torch.log by an ulp, so the mirror's
// tests check the margin analysis on the CPU; the kernel's own masks are
// checked on the card by its bit-equality with kPerTile.
//
// Both variants compute alpha with explicitly rounded operations in the
// plain version's order (a contracted FMA moves alpha across the 1/255 cut
// at some points, a jump of up to 1/255 in the output) and blend through the
// same function, so the two are bit-equal. fp32 throughout, accurate expf.
// Requirements (checked by the Python wrapper): fp32 payload [R, 8 or 16, P]
// contiguous, int32 tile_start / tile_count [R, T], every segment inside
// [0, P), R T <= 65535 * 512 items for kCulled (the order kernel's spans);
// for kCulled int32 scratch [2 R T + 1] (the counter, which the entry point
// zeroes, then the order and its ranks), or a caller's order [R T] of flat
// indices view * T + tile (to measure the schedule).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPerTile = 0;
constexpr int kCulled = 1;

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kBatch = kPixels;         // pairs staged per round
constexpr int kWarps = kPixels / 32;
constexpr int kBlockW = 8, kBlockH = 4;  // a warp's pixel block (kCulled)
constexpr int kWords = kBatch / 32;      // mask words per warp and batch
constexpr float kAlphaMin = 1.f / 255.f;
// the culling box's margins (see the header), exact powers of two
constexpr float kCutMargin = 9.765625e-4f;           // 2^-10: the opacity cut
constexpr float kTauMargin = 2.44140625e-4f;         // 2^-12: tau and the extents
constexpr float kPowerErr = 1.9073486328125e-6f;     // 2^-19 = 32u: the power's rounding
constexpr float kDetErr = 2.384185791015625e-7f;     // 2^-22 = 4u: the determinant's
constexpr float kQErr = 9.5367431640625e-7f;         // 2^-20 = 16u: Q at a point
constexpr float kMeanMax = 1048576.f;                // 2^20 pixels

__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }

// alpha of one (pixel, pair) point, 0 where the pair is dead there
__device__ __forceinline__ float pair_alpha(float px, float py, float mx, float my, float a,
                                            float b, float c, float op) {
  const float dx = px - mx;
  const float dy = py - my;
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
  const float alpha = fminf(0.99f, __fmul_rn(op, expf(power)));
  return (power > 0.f || alpha < kAlphaMin) ? 0.f : alpha;
}

struct Accum {
  float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f;
};

__device__ __forceinline__ void blend(Accum& s, float alpha, float r, float g, float bl,
                                      float d) {
  const float w = __fmul_rn(alpha, s.trans);
  s.cr = __fmaf_rn(w, r, s.cr);
  s.cg = __fmaf_rn(w, g, s.cg);
  s.cb = __fmaf_rn(w, bl, s.cb);
  s.cd = __fmaf_rn(w, d, s.cd);
  s.trans = __fmul_rn(s.trans, __fsub_rn(1.f, alpha));
}

__device__ __forceinline__ void store(const Accum& s, float* o) {
  o[0] = s.cr;
  o[kPixels] = s.cg;
  o[2 * kPixels] = s.cb;
  o[3 * kPixels] = 1.f - s.trans;
  o[4 * kPixels] = s.cd;
}

template <bool kPacked>
__global__ void __launch_bounds__(kPixels)
splat_composite_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count, float* __restrict__ out,
                       int rows, long long capacity, int n_tiles_side) {
  __shared__ float s_mx[kBatch], s_my[kBatch], s_a[kBatch], s_b[kBatch], s_c[kBatch];
  __shared__ float s_op[kBatch], s_r[kBatch], s_g[kBatch], s_bl[kBatch], s_d[kBatch];

  const int tile = blockIdx.x;
  const int view = blockIdx.y;
  const int n_tiles = n_tiles_side * n_tiles_side;
  const int p = threadIdx.x;
  const float px = float(p % kTile + (tile % n_tiles_side) * kTile);
  const float py = float(p / kTile + (tile / n_tiles_side) * kTile);
  const long long start = tile_start[(long long)view * n_tiles + tile];
  const int count = tile_count[(long long)view * n_tiles + tile];
  const float* pay = payload + (long long)view * rows * capacity + start;

  Accum acc;
  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);
    __syncthreads();  // the previous batch is consumed
    if (p < n) {
      const float* q = pay + base + p;
      s_mx[p] = q[0];
      s_my[p] = q[capacity];
      s_a[p] = q[2 * capacity];
      s_b[p] = q[3 * capacity];
      s_c[p] = q[4 * capacity];
      if (kPacked) {
        const uint32_t rg = __float_as_uint(q[5 * capacity]);
        const uint32_t bo = __float_as_uint(q[6 * capacity]);
        const uint32_t dz = __float_as_uint(q[7 * capacity]);
        s_r[p] = hi_half(rg);
        s_g[p] = lo_half(rg);
        s_bl[p] = hi_half(bo);
        s_op[p] = lo_half(bo);
        s_d[p] = hi_half(dz);
      } else {
        s_r[p] = q[5 * capacity];
        s_g[p] = q[6 * capacity];
        s_bl[p] = q[7 * capacity];
        s_op[p] = q[8 * capacity];
        s_d[p] = q[9 * capacity];
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float alpha = pair_alpha(px, py, s_mx[i], s_my[i], s_a[i], s_b[i], s_c[i], s_op[i]);
      blend(acc, alpha, s_r[i], s_g[i], s_bl[i], s_d[i]);
    }
  }
  store(acc, out + ((long long)view * n_tiles + tile) * 5 * kPixels + p);
}

// ---------------------------------------------------------------- kCulled

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

template <int kRows>
struct CulledSmem {
  float raw[2][kRows][kBatch];  // payload rows as they lie in memory, two batches
  float4 rec[kBatch][3];        // mx my a b | c op r g | b depth - -
  float4 cull[kBatch];          // t, -b / a, -b / c of the exact tests
  uint32_t keep[kBatch];        // the blocks that pass the exact test, by pair
  uint16_t tests[kBatch * kWarps];  // (pair << 3 | block) to test exactly
  uint32_t words[kWarps][kWords];
  uint8_t list[kWarps][kBatch];  // each warp's pairs of the batch, in order
  int n_tests;
  int next;                     // the item claimed for after the current one
};

// No minimum of CTAs an SM: ptxas takes 80 registers, 3 CTAs an SM fit; built
// for 4 or 5 (64 or 48 registers) it measured no faster on an H100.
template <bool kPacked>
__global__ void __launch_bounds__(kPixels, 1)
splat_composite_culled_kernel(const float* __restrict__ payload,
                              const int* __restrict__ tile_start,
                              const int* __restrict__ tile_count, const int* __restrict__ order,
                              int* __restrict__ counter, float* __restrict__ out, int rows,
                              long long capacity, int n_tiles_side, int n_items) {
  constexpr int kRows = kPacked ? 8 : 10;  // rows read: 5 geometry + colour, opacity, depth
  __shared__ CulledSmem<kRows> sm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_tiles = n_tiles_side * n_tiles_side;
  // this thread's pixel: warp block (bx, by), 8 x 4 pixels in it
  const int ix = (warp & 1) * kBlockW + (lane & (kBlockW - 1));
  const int iy = (warp >> 1) * kBlockH + (lane >> 3);

  // one batch of an item's pairs into sm.raw[buf]: thread t copies pair t of
  // each row (the thread that reads it back in the mask pass)
  auto stage = [&](const Item& it, int base, int buf) {
    const int n = min(kBatch, it.count - base);
    if (tid < n) {
      const float* q = payload + (long long)it.view * rows * capacity + it.start + base + tid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) cp_async4(&sm.raw[buf][r][tid], q + r * capacity);
    }
    cp_async_commit();
  };

  if (tid == 0) {
    sm.next = atomicAdd(counter, 1);
    sm.n_tests = 0;
  }
  __syncthreads();
  int i_item = sm.next;
  int buf = 0;
  bool staged = false;  // the item's first batch is already in flight
  while (i_item < n_items) {
    const Item it = item_at(i_item, order, tile_start, tile_count, n_tiles);
    if (!staged && it.count > 0) stage(it, 0, buf);
    __syncthreads();  // every thread has read sm.next
    if (tid == 0) sm.next = atomicAdd(counter, 1);
    const float px = float((it.tile % n_tiles_side) * kTile + ix);
    const float py = float((it.tile / n_tiles_side) * kTile + iy);
    const float x0 = float((it.tile % n_tiles_side) * kTile);
    const float y0 = float((it.tile / n_tiles_side) * kTile);
    staged = false;
    Accum acc;
    for (int base = 0; base < it.count; base += kBatch) {
      const int n = min(kBatch, it.count - base);
      cp_async_wait_all();
      __syncthreads();  // batch landed; the previous batch's records are consumed
      // the mask pass: one pair a thread forms its box and queues its blocks
      // for the exact test, which all threads then share
      uint32_t box = 0u;
      float t = 0.f;
      if (tid < n) {
        const float(*raw)[kBatch] = sm.raw[buf];
        const float mx = raw[0][tid], my = raw[1][tid], a = raw[2][tid], b = raw[3][tid],
                    c = raw[4][tid];
        float r, g, bl, op, d;
        if (kPacked) {
          const uint32_t rg = __float_as_uint(raw[5][tid]);
          const uint32_t bo = __float_as_uint(raw[6][tid]);
          r = hi_half(rg);
          g = lo_half(rg);
          bl = hi_half(bo);
          op = lo_half(bo);
          d = hi_half(__float_as_uint(raw[7][tid]));
        } else {
          r = raw[5][tid];
          g = raw[6][tid];
          bl = raw[7][tid];
          op = raw[8][tid];
          d = raw[9][tid];
        }
        box = cull_box(mx, my, a, b, c, op, x0, y0, &t);
        sm.rec[tid][0] = make_float4(mx, my, a, b);
        sm.rec[tid][1] = make_float4(c, op, r, g);
        sm.rec[tid][2] = make_float4(bl, d, 0.f, 0.f);
        sm.cull[tid] = make_float4(t, -b / a, -b / c, 0.f);
      }
      // a degenerate pair (t = +inf) keeps its blocks untested
      const bool test = t < __int_as_float(0x7F800000);
      if (tid < kBatch) sm.keep[tid] = test ? 0u : box;
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
        if (lane == 31) base0 = atomicAdd(&sm.n_tests, incl);
        base0 = __shfl_sync(0xFFFFFFFFu, base0, 31);
        int slot = base0 + incl - mine;
        for (uint32_t m = test ? box : 0u; m; m &= m - 1)
          sm.tests[slot++] = uint16_t((tid << 3) | (__ffs(m) - 1));
      }
      __syncthreads();  // the queue is written
      for (int q = tid; q < sm.n_tests; q += kPixels) {
        const int e = sm.tests[q], i = e >> 3, w = e & 7;
        const float4 r0 = sm.rec[i][0], cl = sm.cull[i];
        if (block_meets(r0.x, r0.y, r0.z, r0.w, sm.rec[i][1].x, cl.x, cl.y, cl.z,
                        x0 + float((w & 1) * kBlockW), y0 + float((w >> 1) * kBlockH)))
          atomicOr(&sm.keep[i], 1u << w);
      }
      __syncthreads();  // the tests are done
      const uint32_t mask = tid < n ? sm.keep[tid] : 0u;
      uint32_t mine = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t word = __ballot_sync(0xFFFFFFFFu, (mask >> w) & 1u);
        if (lane == w) mine = word;
      }
      if (lane < kWarps) sm.words[lane][warp] = mine;
      __syncthreads();  // records, words and sm.next visible
      if (tid == 0) sm.n_tests = 0;  // the queue is consumed
      // stage the next batch, or the next item's first, under the compositing
      if (base + kBatch < it.count) {
        stage(it, base + kBatch, buf ^ 1);
      } else if (sm.next < n_items) {
        const Item nx = item_at(sm.next, order, tile_start, tile_count, n_tiles);
        if (nx.count > 0) {
          stage(nx, 0, buf ^ 1);
          staged = true;
        }
      }
      buf ^= 1;
      // once every pixel of the warp has T == 0 exactly, no later pair changes
      // a bit (w = alpha * 0, T * (1 - alpha) = 0)
      if (__all_sync(0xFFFFFFFFu, acc.trans == 0.f)) continue;
      // this warp's pairs of the batch compacted into a list, so the walk is a
      // counted loop the compiler can unroll and run ahead in
      int cnt = 0;
      const int nw = (n + 31) >> 5;
      for (int k = 0; k < nw; ++k) {
        const uint32_t word = sm.words[warp][k];
        if ((word >> lane) & 1u)
          sm.list[warp][cnt + __popc(word & ((1u << lane) - 1u))] = uint8_t((k << 5) + lane);
        cnt += __popc(word);
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int i = sm.list[warp][j];
        const float4 r0 = sm.rec[i][0], r1 = sm.rec[i][1], r2 = sm.rec[i][2];
        blend(acc, pair_alpha(px, py, r0.x, r0.y, r0.z, r0.w, r1.x, r1.y), r1.z, r1.w, r2.x,
              r2.y);
      }
    }
    store(acc, out + ((long long)it.view * n_tiles + it.tile) * 5 * kPixels + iy * kTile + ix);
    __syncthreads();  // sm.next visible when the item had no pairs; records consumed
    i_item = sm.next;
  }
  cp_async_wait_all();
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

cudaError_t launch_order(const int* tile_count, int* order, int* rank, int n, cudaStream_t st) {
  const int blocks = (n + kRankThreads - 1) / kRankThreads;
  const int spans = (n + kRankSpan - 1) / kRankSpan;  // at most 65535 (the entry checks)
  const cudaError_t e = cudaMemsetAsync(rank, 0, size_t(n) * sizeof(int), st);
  if (e != cudaSuccess) return e;
  order_rank_kernel<<<dim3(blocks, spans), kRankThreads, 0, st>>>(tile_count, rank, n);
  order_scatter_kernel<<<blocks, kRankThreads, 0, st>>>(rank, order, n);
  return cudaGetLastError();
}

template <bool kPacked>
cudaError_t launch_culled(const float* pay, const int* ts, const int* tc, const int* ord,
                          int* ctr, float* o, int rows, int capacity, int n_tiles_side,
                          int n_items, cudaStream_t st) {
  // the persistent grid: as many CTAs as fit on every SM at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, splat_composite_culled_kernel<kPacked>, kPixels, 0);
  if (e != cudaSuccess) return e;
  const int grid = max(1, min(n_items, sms * max(per_sm, 1)));
  splat_composite_culled_kernel<kPacked><<<grid, kPixels, 0, st>>>(
      pay, ts, tc, ord, ctr, o, rows, capacity, n_tiles_side, n_items);
  return cudaGetLastError();
}

}  // namespace

// payload [R, rows, capacity] fp32; tile_start / tile_count [R, T] int32,
// T = n_tiles_side^2; out [R, T, 5, 256] fp32. variant 1 (kCulled) also
// takes scratch, int32 [2 R T + 1] of device memory (the counter and, when
// order is null, the heaviest-first order and its ranks, formed here; R T at
// most 65535 * 512), and optionally an order [R T] int32 of the caller's;
// variant 0 (kPerTile) ignores both. Returns a cudaError_t.
extern "C" int vmv_splat_composite_fwd(const void* payload, const void* tile_start,
                                       const void* tile_count, const void* order, void* scratch,
                                       void* out, int R, int rows, int capacity,
                                       int n_tiles_side, int variant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 65535 || n_tiles_side <= 0 || capacity <= 0 || (rows != 8 && rows != 16))
    return int(cudaErrorInvalidValue);
  const float* pay = static_cast<const float*>(payload);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  float* o = static_cast<float*>(out);
  const bool packed = rows == 8;
  if (variant == kPerTile) {
    const dim3 grid(n_tiles_side * n_tiles_side, R);
    if (packed)
      splat_composite_kernel<true><<<grid, kPixels, 0, st>>>(pay, ts, tc, o, rows, capacity,
                                                             n_tiles_side);
    else
      splat_composite_kernel<false><<<grid, kPixels, 0, st>>>(pay, ts, tc, o, rows, capacity,
                                                              n_tiles_side);
    return int(cudaGetLastError());
  }
  if (variant != kCulled || scratch == nullptr) return int(cudaErrorInvalidValue);
  const long long items = (long long)R * n_tiles_side * n_tiles_side;
  if (items > 65535LL * kRankSpan) return int(cudaErrorInvalidValue);
  const int n_items = int(items);
  int* ctr = static_cast<int*>(scratch);
  const int* ord = static_cast<const int*>(order);
  if (ord == nullptr) {
    const cudaError_t e = launch_order(tc, ctr + 1, ctr + 1 + n_items, n_items, st);
    if (e != cudaSuccess) return int(e);
    ord = ctr + 1;
  }
  const cudaError_t e = cudaMemsetAsync(ctr, 0, sizeof(int), st);
  if (e != cudaSuccess) return int(e);
  return int(packed ? launch_culled<true>(pay, ts, tc, ord, ctr, o, rows, capacity,
                                          n_tiles_side, n_items, st)
                    : launch_culled<false>(pay, ts, tc, ord, ctr, o, rows, capacity,
                                           n_tiles_side, n_items, st));
}
