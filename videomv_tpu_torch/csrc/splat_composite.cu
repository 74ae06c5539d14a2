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
// The culling box (cull_box), the exact block test (block_meets), their
// margins and the batch's culling pass (cull_batch) are in splat_cull.cuh,
// shared with the backward kernel; the plain PyTorch mirror is
// videomv_tpu_torch/ops/splat.py::cull_masks.
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

#include "splat_cull.cuh"

namespace {

constexpr int kPerTile = 0;
constexpr int kCulled = 1;

constexpr int kBatch = kPixels;     // pairs staged per round

__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }

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

template <int kRows>
struct CulledSmem {
  float raw[2][kRows][kBatch];  // payload rows as they lie in memory, two batches
  CullSmem<kBatch> cs;
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
      // the mask pass: one pair a thread, its blocks tested by the CTA
      float mx = 0.f, my = 0.f, a = 0.f, b = 0.f, c = 0.f, r = 0.f, g = 0.f, bl = 0.f,
            op = 0.f, d = 0.f;
      if (tid < n) {
        const float(*raw)[kBatch] = sm.raw[buf];
        mx = raw[0][tid], my = raw[1][tid], a = raw[2][tid], b = raw[3][tid], c = raw[4][tid];
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
      }
      cull_batch(sm.cs, tid, n, x0, y0, mx, my, a, b, c, op, r, g, bl, d);  // sm.next visible
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
      const int cnt = warp_pairs(sm.cs, warp, lane, n);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int i = sm.cs.list[warp][j];
        const float4 r0 = sm.cs.rec[i][0], r1 = sm.cs.rec[i][1], r2 = sm.cs.rec[i][2];
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

template <bool kPacked>
cudaError_t launch_culled(const float* pay, const int* ts, const int* tc, const int* ord,
                          int* ctr, float* o, int rows, int capacity, int n_tiles_side,
                          int n_items, cudaStream_t st) {
  int grid = 0;
  const cudaError_t e =
      persistent_grid(splat_composite_culled_kernel<kPacked>, 0, n_items, &grid);
  if (e != cudaSuccess) return e;
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
  const cudaError_t e = prepare_items(tc, &ord, ctr, n_items, st);
  if (e != cudaSuccess) return int(e);
  return int(packed ? launch_culled<true>(pay, ts, tc, ord, ctr, o, rows, capacity,
                                          n_tiles_side, n_items, st)
                    : launch_culled<false>(pay, ts, tc, ord, ctr, o, rows, capacity,
                                           n_tiles_side, n_items, st));
}
