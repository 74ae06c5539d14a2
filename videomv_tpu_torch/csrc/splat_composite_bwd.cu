// Tile composite of the Gaussian-splat rasterizer, backward (fp32).
//
// Replaces: videomv_tpu/ops/splat_pallas.py::_tile_bwd_kernel (launched by
// _composite_bwd_call), the VJP of the forward composite in
// splat_composite.cu. Given the 16-row payload, each tile's segment, the
// forward's output (C_rgb, A = 1 - T_N, D) and its gradient (gC_rgb, gA, gD),
// it writes dpayload [R, 16, P]: rows 0-1 d mean2d, 2-4 d inv_cov (a, b, c),
// 5-7 d rgb, 8 d opacity, 9 d depth, rows 10-15 and every pair outside a
// tile's segment zero. Per tile it walks the segment front to back, rebuilds
// alpha_i and the transmittance T_i exactly as the forward does, and per
// (pixel, pair) forms, with c_i = (r, g, b, depth)_i and gC = (gC_rgb, gD):
//   w_i     = alpha_i T_i                      d c_i    = sum_px gC w_i
//   Cum_i   = sum_{j <= i} (gC . c_j) w_j      (inclusive prefix)
//   dalpha  = (gC . c_i) T_i - (gC . C_tot - Cum_i - gA T_N) / max(1 - alpha_i, 0.01)
//   dpower  = dalpha alpha_i,  dopacity = dalpha exp(power)
// both zero where the pair is dead at that pixel (power > 0 or alpha < 1/255)
// or alpha sits on its 0.99 clamp, then d mean2d / d inv_cov by the chain
// rule through power = -1/2 (a dx^2 + c dy^2) - b dx dy, and sums over the
// tile's 256 pixels.
//
// The TPU kernel accumulates into 512-pair chunks that two neighbouring
// tiles share, by read-modify-write, which is safe only on its sequential
// grid. Here a CTA owns exactly its tile's segment and a pair belongs to one
// tile, so every dpayload column has one writer: plain stores, no atomics, a
// deterministic result (two launches give the same bits).
//
// What bounds it on the H100. The least work is the alpha rebuild (16 fp32
// operations) and the gradient terms (42) at the alive (pixel, pair) points
// only, with their 10 values added into the sums over pixels; against that
// each live pair's 10 payload rows are read once and all of dpayload written
// once. At the train step's 2 views of 512² (19 % of a segment's points
// alive) that bound is set by the operations, at the refine's 24 views of
// 256² (9 % alive) by the bytes. What stands between a kernel and it: the
// points that are not alive, the 32-lane sums (five shuffles a value in a
// plain butterfly: 50 a (warp, pair)), the imbalance between tiles, and
// staging that stalls the walk.
//
// Three variants behind one C entry point, chosen by the caller:
//
// kCulled (served): the culled forward's schedule and culling (the shared
// code is in splat_cull.cuh). A persistent grid takes (view, tile) items
// from a global atomic counter over a heaviest-first order that the entry
// point forms on the stream; each warp owns an 8 x 4 pixel block. The
// tile's pairs are staged in batches of 128 by cp.async, double-buffered
// (rows 0-9 only, 40 B a pair; the next batch, or the next item's first, is
// in flight under the walk); cull_batch gives each pair the mask of the warp
// blocks where it may be alive. Each warp walks only its kept pairs, in pair
// order, carrying T and Cum per pixel: a pair whose bit is clear is dead at
// every pixel of the block, where it contributes an exact zero and leaves T
// and Cum as they are (w = 0, T * 1 = T), so skipping it changes no sum but
// for the order of the additions. Per kept pair the warp's 10 sums take a
// transposed reduction (transposed_sum: each butterfly step halves the
// values a lane carries; 5 + 3 + 2 + 1 + 1 = 12 shuffles, one sum left on
// each of 10 lanes), whose lanes write the warp's partial
// part[value][warp][pair]. Grouping three pairs into one 32-slot reduction
// would take 10 shuffles a pair, for 30 live values a lane and a walk that
// holds results back: not worth it at 12. After the walk each (value, pair)
// is summed over the warps whose bit is set, in warp order, and stored
// coalesced along the pair axis; a pair no warp kept gets an exact 0. (Doing
// those sums with the upper 128 threads under the next batch's mask pass, a
// barrier less, measured no faster.) dalpha divides by the fast __fdividef
// (2 ulp; the IEEE divide costs 13 % of the kernel). 63 KB of dynamic shared
// memory a CTA, at most 80 registers: 3 CTAs an SM.
// kPerTile (the first port): one CTA per (tile, view), one thread per
// pixel, every pixel against every pair of its tile in batches of 64 staged
// by plain loads; a warp (two pixel rows) in which the pair is dead at all
// 32 pixels skips it and stores zeros, the others take 10 butterfly sums.
// Kept for comparison; no served path launches it.
// Both zero the whole of dpayload by one memset before the launch, for rows
// 10-15 and the columns outside every segment, which no tile writes (a pass
// that wrote only those measured no faster on an H100).
//
// VMV_BWD_* switches (off in every served build; `chip_smoke.py --phases
// env,splat_bwd_ablation` times builds with them): NOWALK skips the walk,
// NOREDUCE sums a lane's 10 values in place of the reduction, NOEXP takes
// the fast exponential, NOMEMSET leaves dpayload unzeroed, IEEEDIV divides
// as the per-tile kernel does. The results are wrong but for IEEEDIV; the
// times say what each part costs.
//
// Both variants rebuild alpha with the forward's explicitly rounded
// operations (pair_power), so the 1/255 cut, the power > 0 cut and the 0.99
// clamp fall on the same (pixel, pair) points in both passes, and form every
// per-pixel term by the same expressions but for that divide: they differ by
// rounding only, in the divide and the order of the 256-pixel sums. With a
// non-finite colour (or gradient) they differ more: at a dead point
// g1 * w = inf * 0 = NaN enters Cum, and the per-tile kernel lets it into
// every pixel of a warp where the pair is alive at some lane, the culled
// kernel into every pixel of a block whose bit is set.
// Requirements (checked by the Python wrapper): fp32 payload [R, 16, P]
// contiguous, int32 tile_start / tile_count [R, T], saved and grad
// [R, T, 5, 256] fp32 contiguous, every segment inside [0, P); for kCulled
// int32 scratch [2 R T + 1] and optionally a caller's order, as the culled
// forward takes them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_cull.cuh"

namespace {

constexpr int kPerTile = 0;
constexpr int kCulled = 1;

constexpr int kVals = 10;  // gradient rows per pair
constexpr int kRows = 16;  // payload rows

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- kPerTile

constexpr int kTileBatch = 64;  // pairs staged per round

__global__ void __launch_bounds__(kPixels)
splat_composite_bwd_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                           const int* __restrict__ tile_count, const float* __restrict__ saved,
                           const float* __restrict__ grad, float* __restrict__ dpayload,
                           long long capacity, int n_tiles_side) {
  __shared__ float s_in[kVals][kTileBatch];            // mx my a b c r g bl op d
  __shared__ float s_part[kVals][kWarps][kTileBatch];  // per-warp partial sums

  const int tile = blockIdx.x;
  const int view = blockIdx.y;
  const int n_tiles = n_tiles_side * n_tiles_side;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = float(p % kTile + (tile % n_tiles_side) * kTile);
  const float py = float(p / kTile + (tile / n_tiles_side) * kTile);
  const long long cell = (long long)view * n_tiles + tile;
  const long long start = tile_start[cell];
  const int count = tile_count[cell];
  const float* pay = payload + (long long)view * kRows * capacity + start;
  float* dpay = dpayload + (long long)view * kRows * capacity + start;

  // this pixel's forward results and their gradients
  const float* sv = saved + cell * 5 * kPixels + p;
  const float* gr = grad + cell * 5 * kPixels + p;
  const float g_r = gr[0], g_g = gr[kPixels], g_b = gr[2 * kPixels];
  const float g_a = gr[3 * kPixels], g_d = gr[4 * kPixels];
  // gC . C_tot - gA T_N: the part of the suffix term that no pair changes
  const float tail = g_r * sv[0] + g_g * sv[kPixels] + g_b * sv[2 * kPixels] +
                     g_d * sv[4 * kPixels] - g_a * (1.f - sv[3 * kPixels]);

  float trans = 1.f;  // T_i, the transmittance in front of pair i
  float cum = 0.f;    // Cum_i
  for (int base = 0; base < count; base += kTileBatch) {
    const int n = min(kTileBatch, count - base);
    __syncthreads();  // the previous batch's partials are stored
    for (int o = p; o < kVals * kTileBatch; o += kPixels) {
      const int v = o / kTileBatch, i = o % kTileBatch;
      if (i < n) s_in[v][i] = pay[(long long)v * capacity + base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float ia = s_in[2][i], ib = s_in[3][i], ic = s_in[4][i];
      const float dx = px - s_in[0][i];
      const float dy = py - s_in[1][i];
      const float power = pair_power(dx, dy, ia, ib, ic);
      const float expp = expf(power);
      const float raw = __fmul_rn(s_in[8][i], expp);
      float alpha = fminf(0.99f, raw);
      const bool dead = power > 0.f || alpha < kAlphaMin;
      if (dead) alpha = 0.f;
      if (!__any_sync(0xffffffffu, !dead)) {  // nothing of this pair in these 32 pixels
        if (lane == 0) {
#pragma unroll
          for (int v = 0; v < kVals; ++v) s_part[v][warp][i] = 0.f;
        }
        continue;
      }
      const float cr = s_in[5][i], cg = s_in[6][i], cb = s_in[7][i], cd = s_in[9][i];
      const float w = alpha * trans;
      const float g1 = g_r * cr + g_g * cg + g_b * cb + g_d * cd;  // gC . c_i
      cum += g1 * w;
      const float one_minus = fmaxf(1.f - alpha, 0.01f);
      const float dalpha = g1 * trans - (tail - cum) / one_minus;
      // where alpha is clamped at 0.99 it no longer depends on (o, power)
      const bool gmask = !dead && raw < 0.99f;
      const float dpower = gmask ? dalpha * alpha : 0.f;
      const float dop = gmask ? dalpha * expp : 0.f;
      float vals[kVals];
      vals[0] = dpower * (ia * dx + ib * dy);
      vals[1] = dpower * (ic * dy + ib * dx);
      vals[2] = dpower * (-0.5f * dx * dx);
      vals[3] = dpower * (-dx * dy);
      vals[4] = dpower * (-0.5f * dy * dy);
      vals[5] = g_r * w;
      vals[6] = g_g * w;
      vals[7] = g_b * w;
      vals[8] = dop;
      vals[9] = g_d * w;
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        const float s = warp_sum(vals[v]);
        if (lane == 0) s_part[v][warp][i] = s;
      }
      trans *= 1.f - alpha;
    }
    __syncthreads();
    for (int o = p; o < kVals * kTileBatch; o += kPixels) {
      const int v = o / kTileBatch, i = o % kTileBatch;
      if (i < n) {
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += s_part[v][wi][i];
        dpay[(long long)v * capacity + base + i] = s;
      }
    }
  }
}

// ----------------------------------------------------------------- kCulled

constexpr int kBatch = 128;  // pairs staged per round (64 measured slower)

struct BwdSmem {
  float raw[2][kVals][kBatch];  // payload rows 0-9 as they lie in memory, two batches
  CullSmem<kBatch> cs;
  float part[kVals][kWarps][kBatch];  // each kept (warp, pair)'s 10 sums over its 32 pixels
  int next;                           // the item claimed for after the current one
};

// One butterfly step of the transposed reduction: a lane whose `bit` is clear
// keeps the lower half of its K values, one whose bit is set the upper half
// (zero-padded to (K + 1) / 2), and adds its partner's copy of the half it
// keeps, received for the half it gives away: (K + 1) / 2 shuffles.
template <int K>
__device__ __forceinline__ void fold(const float (&in)[K], float (&out)[(K + 1) / 2], int lane,
                                     int bit) {
  constexpr int H = (K + 1) / 2;
  const bool up = (lane & bit) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = in[j];
    const float hi = j + H < K ? in[min(j + H, K - 1)] : 0.f;
    const float give = up ? lo : hi;
    out[j] = (up ? hi : lo) + __shfl_xor_sync(0xFFFFFFFFu, give, bit);
  }
}

// The 10 sums over the warp's 32 lanes in 12 shuffles (10 -> 5 -> 3 -> 2 -> 1
// values a lane over the xor-16, 8, 4, 2 steps, then one xor-1 step): the
// lane's result is the sum of value bwd_slot(lane), on the even lanes whose
// slot is real.
__device__ __forceinline__ float transposed_sum(const float (&v)[kVals], int lane) {
  float a[5], b[3], c[2], d[1];
  fold<10>(v, a, lane, 16);
  fold<5>(a, b, lane, 8);
  fold<3>(b, c, lane, 4);
  fold<2>(c, d, lane, 2);
  return d[0] + __shfl_xor_sync(0xFFFFFFFFu, d[0], 1);
}

// The value whose sum transposed_sum leaves on `lane`, or -1 where the lane
// holds padding or is odd (its even partner writes the same sum).
__device__ __forceinline__ int bwd_slot(int lane) {
  int slot = 0, k = kVals, real = kVals;
#pragma unroll
  for (int bit = 16; bit >= 2; bit >>= 1) {
    const int h = (k + 1) / 2;
    if (lane & bit) {
      slot += h;
      real = max(0, real - h);
    } else {
      real = min(real, h);
    }
    k = h;
  }
  return real == 1 && !(lane & 1) ? slot : -1;
}

// 3 CTAs an SM: shared memory allows 3, and the bound keeps the registers
// at or under the 80 that 3 need.
__global__ void __launch_bounds__(kPixels, 3)
splat_composite_bwd_culled_kernel(const float* __restrict__ payload,
                                  const int* __restrict__ tile_start,
                                  const int* __restrict__ tile_count,
                                  const float* __restrict__ saved, const float* __restrict__ grad,
                                  const int* __restrict__ order, int* __restrict__ counter,
                                  float* __restrict__ dpayload, long long capacity,
                                  int n_tiles_side, int n_items) {
  extern __shared__ float4 smem_f4[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_f4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_tiles = n_tiles_side * n_tiles_side;
  // this thread's pixel: warp block (bx, by), 8 x 4 pixels in it
  const int ix = (warp & 1) * kBlockW + (lane & (kBlockW - 1));
  const int iy = (warp >> 1) * kBlockH + (lane >> 3);
  const int slot = bwd_slot(lane);

  // one batch of an item's pairs into sm.raw[buf], the CTA's threads along
  // each row in turn
  auto stage = [&](const Item& it, int base, int buf) {
    const int n = min(kBatch, it.count - base);
    const float* q = payload + (long long)it.view * kRows * capacity + it.start + base;
#pragma unroll
    for (int o = tid; o < kVals * kBatch; o += kPixels) {
      const int r = o / kBatch, i = o % kBatch;
      if (i < n) cp_async4(&sm.raw[buf][r][i], q + r * capacity + i);
    }
    cp_async_commit();
  };

  if (tid == 0) {
    sm.next = atomicAdd(counter, 1);
    sm.cs.n_tests = 0;
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
    staged = false;
    if (it.count > 0) {
      const float x0 = float((it.tile % n_tiles_side) * kTile);
      const float y0 = float((it.tile / n_tiles_side) * kTile);
      const float px = x0 + float(ix), py = y0 + float(iy);
      // this pixel's forward results and their gradients
      const long long cell = (long long)it.view * n_tiles + it.tile;
      const float* sv = saved + cell * 5 * kPixels + iy * kTile + ix;
      const float* gr = grad + cell * 5 * kPixels + iy * kTile + ix;
      const float g_r = gr[0], g_g = gr[kPixels], g_b = gr[2 * kPixels];
      const float g_a = gr[3 * kPixels], g_d = gr[4 * kPixels];
      // gC . C_tot - gA T_N: the part of the suffix term that no pair changes
      const float tail = g_r * sv[0] + g_g * sv[kPixels] + g_b * sv[2 * kPixels] +
                         g_d * sv[4 * kPixels] - g_a * (1.f - sv[3 * kPixels]);
      float* dpay = dpayload + (long long)it.view * kRows * capacity + it.start;
      float trans = 1.f;  // T_i, the transmittance in front of pair i
      float cum = 0.f;    // Cum_i
      for (int base = 0; base < it.count; base += kBatch) {
        const int n = min(kBatch, it.count - base);
        cp_async_wait_all();
        __syncthreads();  // batch landed; the previous batch's records and partials consumed
        // the mask pass: one pair a thread, its blocks tested by the CTA
        float f[kVals] = {};  // mx my a b c r g bl op d
        if (tid < n) {
#pragma unroll
          for (int r = 0; r < kVals; ++r) f[r] = sm.raw[buf][r][tid];
        }
        cull_batch(sm.cs, tid, n, x0, y0, f[0], f[1], f[2], f[3], f[4], f[8], f[5], f[6], f[7],
                   f[9]);  // sm.next visible
        // stage the next batch, or the next item's first, under the walk
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
#ifdef VMV_BWD_NOWALK
        const int cnt = 0 * warp_pairs(sm.cs, warp, lane, n);
#else
        const int cnt = warp_pairs(sm.cs, warp, lane, n);
#endif
        for (int j = 0; j < cnt; ++j) {
          const int i = sm.cs.list[warp][j];
          const float4 r0 = sm.cs.rec[i][0], r1 = sm.cs.rec[i][1], r2 = sm.cs.rec[i][2];
          const float ia = r0.z, ib = r0.w, ic = r1.x;
          const float dx = px - r0.x;
          const float dy = py - r0.y;
          const float power = pair_power(dx, dy, ia, ib, ic);
#ifdef VMV_BWD_NOEXP
          const float expp = __expf(power);
#else
          const float expp = expf(power);
#endif
          const float raw = __fmul_rn(r1.y, expp);
          float alpha = fminf(0.99f, raw);
          const bool dead = power > 0.f || alpha < kAlphaMin;
          if (dead) alpha = 0.f;
          const float w = alpha * trans;
          const float g1 = g_r * r1.z + g_g * r1.w + g_b * r2.x + g_d * r2.y;  // gC . c_i
          cum += g1 * w;
          const float one_minus = fmaxf(1.f - alpha, 0.01f);
#ifdef VMV_BWD_IEEEDIV
          const float dalpha = g1 * trans - (tail - cum) / one_minus;
#else
          // the fast divide (2 ulp) for one_minus in [0.01, 1]: the IEEE one
          // costs 13 % of the kernel
          const float dalpha = g1 * trans - __fdividef(tail - cum, one_minus);
#endif
          // where alpha is clamped at 0.99 it no longer depends on (o, power)
          const bool gmask = !dead && raw < 0.99f;
          const float dpower = gmask ? dalpha * alpha : 0.f;
          const float dop = gmask ? dalpha * expp : 0.f;
          float vals[kVals];
          vals[0] = dpower * (ia * dx + ib * dy);
          vals[1] = dpower * (ic * dy + ib * dx);
          vals[2] = dpower * (-0.5f * dx * dx);
          vals[3] = dpower * (-dx * dy);
          vals[4] = dpower * (-0.5f * dy * dy);
          vals[5] = g_r * w;
          vals[6] = g_g * w;
          vals[7] = g_b * w;
          vals[8] = dop;
          vals[9] = g_d * w;
#ifdef VMV_BWD_NOREDUCE
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < kVals; ++v) s += vals[v];
#else
          const float s = transposed_sum(vals, lane);
#endif
          if (slot >= 0) sm.part[slot][warp][i] = s;
          trans *= 1.f - alpha;
        }
        __syncthreads();  // the partials are written
        // each (value, pair) summed over the warps that kept the pair, in warp
        // order, and stored along the pair axis
        for (int o = tid; o < kVals * kBatch; o += kPixels) {
          const int v = o / kBatch, i = o % kBatch;
          if (i < n) {
            const uint32_t keep = sm.cs.keep[i];
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              if ((keep >> w) & 1u) s += sm.part[v][w][i];
            dpay[(long long)v * capacity + base + i] = s;
          }
        }
      }
    }
    __syncthreads();  // sm.next visible when the item had no pairs; partials consumed
    i_item = sm.next;
  }
  cp_async_wait_all();
}

cudaError_t launch_culled(const float* pay, const int* ts, const int* tc, const float* sv,
                          const float* gr, const int* ord, int* ctr, float* dp, int capacity,
                          int n_tiles_side, int n_items, cudaStream_t st) {
  const size_t smem = sizeof(BwdSmem);
  cudaError_t e = cudaFuncSetAttribute(splat_composite_bwd_culled_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid(splat_composite_bwd_culled_kernel, smem, n_items, &grid);
  if (e != cudaSuccess) return e;
  splat_composite_bwd_culled_kernel<<<grid, kPixels, smem, st>>>(
      pay, ts, tc, sv, gr, ord, ctr, dp, capacity, n_tiles_side, n_items);
  return cudaGetLastError();
}

}  // namespace

// payload [R, 16, capacity] fp32; tile_start / tile_count [R, T] int32,
// T = n_tiles_side^2; saved, grad [R, T, 5, 256] fp32; dpayload
// [R, 16, capacity] fp32, zeroed here before the launch. variant 1 (kCulled)
// also takes scratch, int32 [2 R T + 1] of device memory (the counter and,
// when order is null, the heaviest-first order and its ranks, formed here;
// R T at most 65535 * 512), and optionally an order [R T] int32 of the
// caller's; variant 0 (kPerTile) ignores both. Returns a cudaError_t.
extern "C" int vmv_splat_composite_bwd(const void* payload, const void* tile_start,
                                       const void* tile_count, const void* saved,
                                       const void* grad, const void* order, void* scratch,
                                       void* dpayload, int R, int capacity, int n_tiles_side,
                                       int variant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 65535 || n_tiles_side <= 0 || capacity <= 0) return int(cudaErrorInvalidValue);
  const float* pay = static_cast<const float*>(payload);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const float* sv = static_cast<const float*>(saved);
  const float* gr = static_cast<const float*>(grad);
  float* dp = static_cast<float*>(dpayload);
  const long long items = (long long)R * n_tiles_side * n_tiles_side;
  if (variant != kPerTile &&
      (variant != kCulled || scratch == nullptr || items > 65535LL * kRankSpan))
    return int(cudaErrorInvalidValue);
  // rows 10-15 and every column outside the segments: zero (no tile writes them)
#ifndef VMV_BWD_NOMEMSET
  const cudaError_t err =
      cudaMemsetAsync(dp, 0, sizeof(float) * size_t(R) * kRows * size_t(capacity), st);
  if (err != cudaSuccess) return int(err);
#endif
  if (variant == kPerTile) {
    const dim3 grid(n_tiles_side * n_tiles_side, R);
    splat_composite_bwd_kernel<<<grid, kPixels, 0, st>>>(pay, ts, tc, sv, gr, dp, capacity,
                                                         n_tiles_side);
    return int(cudaGetLastError());
  }
  const int n_items = int(items);
  int* ctr = static_cast<int*>(scratch);
  const int* ord = static_cast<const int*>(order);
  const cudaError_t e = prepare_items(tc, &ord, ctr, n_items, st);
  if (e != cudaSuccess) return int(e);
  return int(launch_culled(pay, ts, tc, sv, gr, ord, ctr, dp, capacity, n_tiles_side, n_items,
                           st));
}

// Bytes of dynamic shared memory a CTA of the culled kernel takes.
extern "C" int vmv_splat_composite_bwd_smem() { return int(sizeof(BwdSmem)); }
