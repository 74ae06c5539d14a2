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
// (masking each tile's head/tail overhang) and runs its grid in order with
// one VMEM scratch; the transmittance inside a chunk is an exclusive prefix
// of log(1 - alpha) as one triangular MXU matmul. None of that is needed on
// Hopper: every CTA reads exactly its own segment, and a pixel's running
// product is a register.
//
// What bounds it on the H100: each pair costs ~20 fp32 operations and one
// expf per pixel, against 32 (packed) or 40 (fp32 payload) bytes read once
// per tile. At the refine shapes (24 views x 256 tiles, up to 294,912 pairs
// per view) that is ~20 operations per byte of L2 traffic, so the kernel is
// bound by fp32/SFU issue, and by load imbalance: a tile's work is its pair
// count, which differs by orders of magnitude between the centre and the
// border of a view. Its design:
//   * one CTA of 256 threads (one per pixel) per (tile, view): grid =
//     tiles x views, every view of a render call in one launch, each with
//     its own tile_start / tile_count rows and payload slice;
//   * the tile's pairs are staged through shared memory in batches of 256
//     by one coalesced load per payload row (each thread loads one pair),
//     unpacked there (bf16 halves by bit masking, no bf16 arithmetic), then
//     every thread composites its pixel in a register loop; all threads
//     read the same shared word, a broadcast;
//   * fp32 throughout, accurate expf (no fast-math), and alpha's inputs
//     rounded op by op (no FMA), so the 1/255 and power > 0 cuts fall where
//     the plain version's do; the compositing itself is continuous.
// Requirements (checked by the Python wrapper): fp32 payload [R, 8 or 16,
// P] contiguous, int32 tile_start / tile_count [R, T], every segment inside
// [0, P).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kBatch = kPixels;         // pairs staged per round

__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }

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

  float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f;
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
      const float dx = px - s_mx[i];
      const float dy = py - s_my[i];
      // power and alpha with explicitly rounded operations in the plain
      // version's order: a contracted FMA moves alpha across the 1/255 cut
      // at some (pixel, pair) points, a jump of up to 1/255 in the output
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s_a[i], dx), dx),
                                   __fmul_rn(__fmul_rn(s_c[i], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s_b[i], dx), dy));
      float alpha = fminf(0.99f, __fmul_rn(s_op[i], expf(power)));
      if (power > 0.f || alpha < 1.f / 255.f) alpha = 0.f;
      const float w = alpha * trans;
      cr += w * s_r[i];
      cg += w * s_g[i];
      cb += w * s_bl[i];
      cd += w * s_d[i];
      trans *= 1.f - alpha;
    }
  }
  float* o = out + ((long long)view * n_tiles + tile) * 5 * kPixels + p;
  o[0] = cr;
  o[kPixels] = cg;
  o[2 * kPixels] = cb;
  o[3 * kPixels] = 1.f - trans;
  o[4 * kPixels] = cd;
}

}  // namespace

// payload [R, rows, capacity] fp32; tile_start / tile_count [R, T] int32,
// T = n_tiles_side^2; out [R, T, 5, 256] fp32. Returns a cudaError_t.
extern "C" int vmv_splat_composite_fwd(const void* payload, const void* tile_start,
                                       const void* tile_count, void* out, int R, int rows,
                                       int capacity, int n_tiles_side, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 65535 || n_tiles_side <= 0 || capacity <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid(n_tiles_side * n_tiles_side, R);
  const float* pay = static_cast<const float*>(payload);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  float* o = static_cast<float*>(out);
  if (rows == 8) {
    splat_composite_kernel<true><<<grid, kPixels, 0, st>>>(pay, ts, tc, o, rows, capacity,
                                                           n_tiles_side);
  } else if (rows == 16) {
    splat_composite_kernel<false><<<grid, kPixels, 0, st>>>(pay, ts, tc, o, rows, capacity,
                                                            n_tiles_side);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
