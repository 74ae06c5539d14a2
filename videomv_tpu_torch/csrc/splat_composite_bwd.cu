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
// deterministic result. The region no tile owns is zeroed by one memset
// before the launch.
//
// What bounds it on the H100: operations. Per (pixel, pair) it repeats the
// forward's ~20 fp32 operations and one expf, adds ~45 for the gradient
// terms, and reduces 10 values over the 256 pixels; against that each pair
// moves 40 bytes in and 40 out once per tile. Its design:
//   * one CTA of 256 threads (one per pixel) per (tile, view), grid tiles x
//     views, as the forward; pairs staged through shared memory in batches
//     of 64 by coalesced loads;
//   * the per-pair sum over pixels is a warp-shuffle reduction of the 10
//     values, then one partial per warp in shared memory ([value][warp]
//     [pair]); a warp in which the pair is dead at all 32 pixels (most warps
//     of most pairs: a splat covers few of a tile's rows) skips the
//     reduction and stores zeros;
//   * after each batch the 8 partials of each (value, pair) are summed in a
//     fixed order and stored, coalesced along the pair axis;
//   * alpha is rebuilt with the forward's explicitly rounded operations, so
//     the 1/255 cut, the power > 0 cut and the 0.99 clamp fall on the same
//     (pixel, pair) points in both passes.
// Requirements (checked by the Python wrapper): fp32 payload [R, 16, P]
// contiguous, int32 tile_start / tile_count [R, T], saved and grad
// [R, T, 5, 256] fp32 contiguous, every segment inside [0, P).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 64;              // pairs staged per round
constexpr int kVals = 10;               // gradient rows per pair
constexpr int kRows = 16;               // payload rows

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kPixels)
splat_composite_bwd_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                           const int* __restrict__ tile_count, const float* __restrict__ saved,
                           const float* __restrict__ grad, float* __restrict__ dpayload,
                           long long capacity, int n_tiles_side) {
  __shared__ float s_in[kVals][kBatch];             // mx my a b c r g bl op d
  __shared__ float s_part[kVals][kWarps][kBatch];   // per-warp partial sums

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
  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);
    __syncthreads();  // the previous batch's partials are stored
    for (int o = p; o < kVals * kBatch; o += kPixels) {
      const int v = o / kBatch, i = o % kBatch;
      if (i < n) s_in[v][i] = pay[(long long)v * capacity + base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float ia = s_in[2][i], ib = s_in[3][i], ic = s_in[4][i];
      const float dx = px - s_in[0][i];
      const float dy = py - s_in[1][i];
      // the forward's operations, rounded one by one in its order
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ia, dx), dx),
                                   __fmul_rn(__fmul_rn(ic, dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(ib, dx), dy));
      const float expp = expf(power);
      const float raw = __fmul_rn(s_in[8][i], expp);
      float alpha = fminf(0.99f, raw);
      const bool dead = power > 0.f || alpha < 1.f / 255.f;
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
    for (int o = p; o < kVals * kBatch; o += kPixels) {
      const int v = o / kBatch, i = o % kBatch;
      if (i < n) {
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += s_part[v][wi][i];
        dpay[(long long)v * capacity + base + i] = s;
      }
    }
  }
}

}  // namespace

// payload [R, 16, capacity] fp32; tile_start / tile_count [R, T] int32,
// T = n_tiles_side^2; saved, grad [R, T, 5, 256] fp32; dpayload
// [R, 16, capacity] fp32, zeroed here before the launch. Returns a
// cudaError_t.
extern "C" int vmv_splat_composite_bwd(const void* payload, const void* tile_start,
                                       const void* tile_count, const void* saved,
                                       const void* grad, void* dpayload, int R, int capacity,
                                       int n_tiles_side, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 65535 || n_tiles_side <= 0 || capacity <= 0) return int(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaMemsetAsync(dpayload, 0, sizeof(float) * size_t(R) * kRows * size_t(capacity), st);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_tiles_side * n_tiles_side, R);
  splat_composite_bwd_kernel<<<grid, kPixels, 0, st>>>(
      static_cast<const float*>(payload), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_count), static_cast<const float*>(saved),
      static_cast<const float*>(grad), static_cast<float*>(dpayload), capacity, n_tiles_side);
  return int(cudaGetLastError());
}
