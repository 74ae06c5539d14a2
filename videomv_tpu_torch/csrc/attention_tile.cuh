// One K/V tile of the online-softmax attention, per warp: the step of the
// flash-attention kernel's mma.sync variant (flash_attention.cu).
//
// A warp owns 16 query rows (its Q as m16n8k16 A fragments in registers) and
// walks K/V tiles of kAttnBlockN keys staged in shared memory with rows of LD
// elements: S = Q K^T (fp32), running max and sum in fp32 with the exponent in
// base 2, P rounded to bf16 before the PV product, O kept in fp32 registers.
// The caller divides O by the row sum once after the last tile; every key of
// the tile is valid.
#pragma once

#include <math.h>

#include "mma_utils.cuh"

namespace vmv {

constexpr int kAttnBlockN = 64;  // keys per K/V tile

template <int D, int LD>
__device__ __forceinline__ void attn_tile_step(const uint32_t (&qf)[D / 16][4],
                                               const bf16* cK, const bf16* cV,
                                               float (&o_acc)[D / 8][4], float (&m_run)[2],
                                               float (&l_run)[2], float scale_log2, int lane) {
  constexpr int kBlockN = kAttnBlockN;
  // S = Q K^T for this warp's 16 rows x 64 keys (fp32)
  float s[kBlockN / 8][4];
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kBlockN / 16; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, cK + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * np], qf[kk], kb[0], kb[1]);
      mma_bf16_16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
    }
  }

  // online softmax: the max of the unscaled logits, exponent in base 2
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float corr[2], msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    corr[r] = exp2f((m_run[r] - mx[r]) * scale_log2);  // 0 on the first tile
    m_run[r] = mx[r];
    msc[r] = mx[r] * scale_log2;
  }

  uint32_t pf[kBlockN / 16][4];  // P as A fragments, bf16
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
    const float p0 = exp2f(fmaf(s[i][0], scale_log2, -msc[0]));
    const float p1 = exp2f(fmaf(s[i][1], scale_log2, -msc[0]));
    const float p2 = exp2f(fmaf(s[i][2], scale_log2, -msc[1]));
    const float p3 = exp2f(fmaf(s[i][3], scale_log2, -msc[1]));
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    pf[i >> 1][(i & 1) * 2 + 0] = pack_bf16x2(p0, p1);
    pf[i >> 1][(i & 1) * 2 + 1] = pack_bf16x2(p2, p3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l_run[r] = l_run[r] * corr[r] + rs[r];
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o_acc[i][0] *= corr[0];
    o_acc[i][1] *= corr[0];
    o_acc[i][2] *= corr[1];
    o_acc[i][3] *= corr[1];
  }

  // O += P V
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, cV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16_16816(o_acc[2 * dp], pf[kk], vb[0], vb[1]);
      mma_bf16_16816(o_acc[2 * dp + 1], pf[kk], vb[2], vb[3]);
    }
  }
}

}  // namespace vmv
