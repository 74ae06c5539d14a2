// The GEGLU feed-forward over one token tile held in shared memory: the loop
// shared by the fused FFN kernel (fused_ffn.cu) and the feed-forward inside
// the fused spatial-transformer kernel (fused_spatial.cu).
//
// A block of kFfnThreads threads (8 warps) holds the bf16 x tile [16·MT, C] and
// an fp32 accumulator of the same shape in shared memory (rows of `ld`
// elements each) and a bf16 g tile [16·MT, kFfnChunk]. Per chunk of 64 inner
// columns each warp computes 8 lin and 8 gate columns with mma.sync m16n8k16
// (x from shared memory via ldmatrix, W1 fragments straight from L2), adds the
// fp32 biases, applies the exact-erf gelu, rounds g to bf16 into shared
// memory; then each warp adds g·W2[chunk] into its C/64 column tiles of the
// accumulator (one owner per element, no atomics). On return every thread has
// passed the last barrier: acc += GEGLU(x·W1ᵀ + b1)·W2ᵀ (b2 is the caller's).
// W1 [2I, C] and W2 [C, I] are in nn.Linear layout; C % 16 == 0, I % 64 == 0.
#pragma once

#include <math.h>

#include "mma_utils.cuh"

namespace vmv {

constexpr int kFfnThreads = 256;
constexpr int kFfnWarps = kFfnThreads / 32;
constexpr int kFfnChunk = 64;            // inner columns per loop step (8 per warp)
constexpr int kFfnLdG = kFfnChunk + 8;   // padded row of the g tile, in elements

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x / 1.4142135623730951f));
}

template <int MT>
__device__ __forceinline__ void geglu_ffn_tile(const bf16* sX, float* sAcc, bf16* sG, int ld,
                                               const bf16* __restrict__ w1,
                                               const float* __restrict__ b1,
                                               const bf16* __restrict__ w2, int C, int I) {
  constexpr int kChunk = kFfnChunk;
  constexpr int kLdG = kFfnLdG;
  constexpr int kWarps = kFfnWarps;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q2 = (lane & 3) * 2;
  for (int j0 = 0; j0 < I; j0 += kChunk) {
    // ---- lin / gate for inner columns j0 + 8·warp + [0, 8)
    float lin[MT][4], gate[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) lin[m][e] = gate[m][e] = 0.f;
    }
    const bf16* wl = w1 + int64_t(j0 + 8 * warp + g) * C + q2;  // B fragment rows
    const bf16* wg = wl + int64_t(I) * C;
#pragma unroll 2
    for (int kk = 0; kk < C; kk += 16) {
      const uint32_t bl0 = ldg_u32(wl + kk), bl1 = ldg_u32(wl + kk + 8);
      const uint32_t bg0 = ldg_u32(wg + kk), bg1 = ldg_u32(wg + kk + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, sX + (m * 16 + (lane & 15)) * ld + kk + (lane >> 4) * 8);
        mma_bf16_16816(lin[m], a, bl0, bl1);
        mma_bf16_16816(gate[m], a, bg0, bg1);
      }
    }
    const int icol = j0 + 8 * warp + q2;
    const float bl_0 = b1[icol], bl_1 = b1[icol + 1];
    const float bg_0 = b1[I + icol], bg_1 = b1[I + icol + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = m * 16 + g;
      const float g0 = (lin[m][0] + bl_0) * gelu_erf(gate[m][0] + bg_0);
      const float g1 = (lin[m][1] + bl_1) * gelu_erf(gate[m][1] + bg_1);
      const float g2 = (lin[m][2] + bl_0) * gelu_erf(gate[m][2] + bg_0);
      const float g3 = (lin[m][3] + bl_1) * gelu_erf(gate[m][3] + bg_1);
      *reinterpret_cast<uint32_t*>(sG + r * kLdG + 8 * warp + q2) = pack_bf16x2(g0, g1);
      *reinterpret_cast<uint32_t*>(sG + (r + 8) * kLdG + 8 * warp + q2) = pack_bf16x2(g2, g3);
    }
    __syncthreads();

    // ---- acc[:, n-tile] += g · W2[n-tile, j0:j0+64]^T
    uint32_t ga[MT][kChunk / 16][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        ldmatrix_x4(ga[m][kk], sG + (m * 16 + (lane & 15)) * kLdG + kk * 16 + (lane >> 4) * 8);
      }
    }
    for (int nt = warp; nt < C / 8; nt += kWarps) {
      const bf16* wp = w2 + int64_t(nt * 8 + g) * I + j0 + q2;
      uint32_t wb[kChunk / 16][2];
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        wb[kk][0] = ldg_u32(wp + kk * 16);
        wb[kk][1] = ldg_u32(wp + kk * 16 + 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float* ap = sAcc + (m * 16 + g) * ld + nt * 8 + q2;
        const float2 lo = *reinterpret_cast<const float2*>(ap);
        const float2 hi = *reinterpret_cast<const float2*>(ap + 8 * ld);
        float acc[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          mma_bf16_16816(acc, ga[m][kk], wb[kk][0], wb[kk][1]);
        }
        *reinterpret_cast<float2*>(ap) = make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(ap + 8 * ld) = make_float2(acc[2], acc[3]);
      }
    }
    __syncthreads();  // the g tile is rewritten by the next chunk
  }

}

}  // namespace vmv
