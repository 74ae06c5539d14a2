// Flash attention backward (bf16): dQ, dK and dV of softmax(Q K^T d^-1/2) V
// over [B, S, H, D], without anything of size S^2 in device memory.
//
// Replaces: videomv_tpu/ops/flash_attention.py::_bwd, the custom VJP of the
// Pallas kernel _attn_kernel (:36). The JAX package has no Pallas backward:
// _bwd differentiates its plain reference (jax.vjp(_reference)), which XLA
// runs with the [B, H, S, S] fp32 logits, their softmax and both gradients
// in HBM. The port's first backward did the same through autograd of its
// plain twin, which at the LAION config's 576 rows wants ~46 GiB for one
// 32^2 self-attention. This computes the same function FA2-style from the
// forward's log-sum-exp (written by csrc/flash_attention.cu):
//   * P = exp(S * scale - lse) is recomputed tile by tile from Q, K and lse;
//     dS = P * (dP - Delta) with dP = dO V^T and Delta = rowsum(dO * O);
//     dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO.
//   * Three kernels, no atomics, so two runs give bit-equal gradients:
//     flash_attn_bwd_delta_kernel (Delta, fp32, one pass over O and dO);
//     flash_attn_bwd_dkdv_kernel, one CTA per (batch·head, 64 keys) walking
//     every query tile (its dK and dV stay in registers);
//     flash_attn_bwd_dq_kernel, one CTA per (batch·head, 64 queries) walking
//     every key tile (its dQ stays in registers). S and dP are computed twice
//     (once in each), 7 products where the function needs 5.
//   * Each warp owns 16 rows; every product is mma.sync m16n8k16 with bf16
//     operands and fp32 accumulation, with operands from padded shared
//     memory through ldmatrix (rows of D + 8 elements: conflict-free), the
//     next tile staged by cp.async while this one is multiplied. P and dS are
//     rounded to bf16 before they enter a product, as the forward rounds P.
// What bounds it on the H100: 10·B·H·S²·D operations against 9 tensors of
// B·S·H·D bf16 read or written once: compute-bound at S = 1024, about even at
// S = 256. mma.sync reaches a fraction of wgmma's rate, and the softmax's exp
// per score is recomputed in both kernels; wgmma, TMA and a fused dQ are for a
// later redesign (the times are in PERF.md).
// Requirements (checked by the Python wrapper and again here): bf16,
// contiguous [B, S, H, D] q, k, v, o, dO; lse and Delta fp32 [B, H, S];
// S % 64 == 0; D in {64, 128}.

#include <math.h>

#include "mma_utils.cuh"

namespace vmv {
namespace {

constexpr int kBwdThreads = 128;  // 4 warps of 16 rows
constexpr int kBwdRows = 64;      // key rows (dK/dV kernel) or query rows (dQ kernel) a CTA
constexpr int kBwdKeys = 64;      // keys per K/V tile of the dQ kernel
constexpr float kLog2e = 1.4426950408889634f;

// Query rows per Q / dO tile of the dK/dV kernel: 64 at head_dim 64, 32 at
// 128, so that dK and dV (D / 2 fp32 each a thread) and the two score tiles
// stay in registers.
template <int D>
struct BwdTile {
  static constexpr int kLd = D + 8;  // padded shared-memory row, in elements
  static constexpr int kQ = D == 64 ? 64 : 32;
  static constexpr size_t kDkdvBytes =
      size_t(2 * kBwdRows + 4 * kQ) * kLd * sizeof(bf16) + 4 * kQ * sizeof(float);
  static constexpr size_t kDqBytes = size_t(2 * kBwdRows + 4 * kBwdKeys) * kLd * sizeof(bf16);
};

// Delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in fp32: D / 8 lanes
// a row, one 16-byte chunk each, summed in a fixed order.
template <int D>
__global__ void __launch_bounds__(256)
flash_attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                            float* __restrict__ delta, int64_t rows, int S, int H) {
  constexpr int kLanes = D / 8;
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = t / kLanes;  // over [B, S, H]
  const int c = int(t % kLanes);
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + c * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + c * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]);
      const float2 fg = __bfloat1622float2(g2[i]);
      acc = fmaf(fa.x, fg.x, acc);
      acc = fmaf(fa.y, fg.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const int h = int(row % H);
    const int64_t bs = row / H;
    const int s = int(bs % S);
    delta[(bs / S * H + h) * S + s] = acc;
  }
}

// Copies `n_rows` tokens of one head ([n_rows x D], token stride `stride`)
// into a padded shared-memory tile with cp.async.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int64_t stride,
                                           int n_rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < n_rows * kChunks; c += kBwdThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    cp_async_16(dst + r * BwdTile<D>::kLd + col, src + int64_t(r) * stride + col);
  }
}

// acc[16 rows x 8·N cols] += A (this warp's 16 rows of sA, K = D) · B^T, with
// B [8·N rows x D] in shared memory (both row-major over D): S = Q K^T and
// dP = dO V^T in the dQ kernel, S^T = K Q^T and dP^T = V dO^T in the dK/dV one.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const bf16* sA, const bf16* sB,
                                        int lane) {
  constexpr int LD = BwdTile<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 rows x D] += A · B, A as bf16 fragments over K = 16·KT columns and B
// [16·KT rows x D] row-major in shared memory (the K-major operand through
// ldmatrix.trans): dV += P^T dO, dK += dS^T Q, dQ += dS K.
template <int D, int KT>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KT][4],
                                       const bf16* sB, int lane) {
  constexpr int LD = BwdTile<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dp * 16 +
                               (lane >> 4) * 8);
      mma_bf16_16816(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// this thread's rows g and g + 8 of a [16 x D] fp32 fragment, times `scale`,
// rounded to bf16 into [B, S, H, D] at token `row0`
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int64_t stride,
                                           float scale, int lane) {
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(dst + int64_t(g) * stride + i * 8 + c2) =
        pack_bf16x2(acc[i][0] * scale, acc[i][1] * scale);
    *reinterpret_cast<uint32_t*>(dst + int64_t(g + 8) * stride + i * 8 + c2) =
        pack_bf16x2(acc[i][2] * scale, acc[i][3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                           float scale) {
  constexpr int LD = BwdTile<D>::kLd;
  constexpr int BQ = BwdTile<D>::kQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sV = sK + kBwdRows * LD;                  // [64][LD]
  bf16* sQ = sV + kBwdRows * LD;                  // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;                   // [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * LD);  // [2][BQ], lse in base 2
  float* sD = sL + 2 * BQ;                                  // [2][BQ], Delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kBwdRows;
  const int64_t stride = int64_t(H) * D;
  const int64_t base = int64_t(b) * S * stride + int64_t(h) * D;
  const float* lse_bh = lse + int64_t(bh) * S;
  const float* delta_bh = delta + int64_t(bh) * S;
  const float scale_log2 = scale * kLog2e;
  const int c2 = (lane & 3) * 2;

  auto stage_queries = [&](int buf, int i0) {
    stage_rows<D>(sQ + buf * BQ * LD, q + base + int64_t(i0) * stride, stride, BQ, tid);
    stage_rows<D>(sdO + buf * BQ * LD, dout + base + int64_t(i0) * stride, stride, BQ, tid);
    cp_async_commit();
    if (tid < BQ) {
      sL[buf * BQ + tid] = lse_bh[i0 + tid] * kLog2e;
      sD[buf * BQ + tid] = delta_bh[i0 + tid];
    }
  };

  stage_rows<D>(sK, k + base + int64_t(k0) * stride, stride, kBwdRows, tid);
  stage_rows<D>(sV, v + base + int64_t(k0) * stride, stride, kBwdRows, tid);
  stage_queries(0, 0);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }
  const bf16* wK = sK + warp * 16 * LD;  // this warp's 16 keys
  const bf16* wV = sV + warp * 16 * LD;

  const int n_tiles = S / BQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage_queries(buf ^ 1, (it + 1) * BQ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + buf * BQ * LD;
    const bf16* cdO = sdO + buf * BQ * LD;
    const float* cL = sL + buf * BQ;
    const float* cD = sD + buf * BQ;

    // S^T = K Q^T for this warp's 16 keys x BQ queries, then P^T in fp32
    float st[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
    mma_abt<D, BQ / 8>(st, wK, cQ, lane);
    uint32_t pf[BQ / 16][4];  // P^T, then dS^T, as bf16 A fragments over the queries
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float l0 = cL[i * 8 + c2], l1 = cL[i * 8 + c2 + 1];
      st[i][0] = exp2f(fmaf(st[i][0], scale_log2, -l0));
      st[i][1] = exp2f(fmaf(st[i][1], scale_log2, -l1));
      st[i][2] = exp2f(fmaf(st[i][2], scale_log2, -l0));
      st[i][3] = exp2f(fmaf(st[i][3], scale_log2, -l1));
      pf[i >> 1][(i & 1) * 2 + 0] = pack_bf16x2(st[i][0], st[i][1]);
      pf[i >> 1][(i & 1) * 2 + 1] = pack_bf16x2(st[i][2], st[i][3]);
    }
    // dV += P^T dO
    mma_ab<D, BQ / 16>(dv_acc, pf, cdO, lane);

    // dP^T = V dO^T; dS^T = P^T (dP^T - Delta[query])
    float dpt[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    mma_abt<D, BQ / 8>(dpt, wV, cdO, lane);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float d0 = cD[i * 8 + c2], d1 = cD[i * 8 + c2 + 1];
      pf[i >> 1][(i & 1) * 2 + 0] =
          pack_bf16x2(st[i][0] * (dpt[i][0] - d0), st[i][1] * (dpt[i][1] - d1));
      pf[i >> 1][(i & 1) * 2 + 1] =
          pack_bf16x2(st[i][2] * (dpt[i][2] - d0), st[i][3] * (dpt[i][3] - d1));
    }
    // dK += dS^T Q (scaled once at the end)
    mma_ab<D, BQ / 16>(dk_acc, pf, cQ, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int64_t out = base + int64_t(k0 + warp * 16) * stride;
  store_rows<D>(dk + out, dk_acc, stride, scale, lane);
  store_rows<D>(dv + out, dv_acc, stride, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int H, float scale) {
  constexpr int LD = BwdTile<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sdO = sQ + kBwdRows * LD;                 // [64][LD]
  bf16* sK = sdO + kBwdRows * LD;                 // [2][64][LD]
  bf16* sV = sK + 2 * kBwdKeys * LD;              // [2][64][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBwdRows;
  const int64_t stride = int64_t(H) * D;
  const int64_t base = int64_t(b) * S * stride + int64_t(h) * D;
  const float scale_log2 = scale * kLog2e;

  stage_rows<D>(sQ, q + base + int64_t(q0) * stride, stride, kBwdRows, tid);
  stage_rows<D>(sdO, dout + base + int64_t(q0) * stride, stride, kBwdRows, tid);
  stage_rows<D>(sK, k + base, stride, kBwdKeys, tid);
  stage_rows<D>(sV, v + base, stride, kBwdKeys, tid);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16 queries
  const int row = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse[int64_t(bh) * S + row + 8 * r] * kLog2e;
    dl[r] = delta[int64_t(bh) * S + row + 8 * r];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const bf16* wQ = sQ + warp * 16 * LD;
  const bf16* wdO = sdO + warp * 16 * LD;

  const int n_tiles = S / kBwdKeys;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      stage_rows<D>(sK + (buf ^ 1) * kBwdKeys * LD, k + base + int64_t(j + 1) * kBwdKeys * stride,
                    stride, kBwdKeys, tid);
      stage_rows<D>(sV + (buf ^ 1) * kBwdKeys * LD, v + base + int64_t(j + 1) * kBwdKeys * stride,
                    stride, kBwdKeys, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * kBwdKeys * LD;
    const bf16* cV = sV + buf * kBwdKeys * LD;

    float s[kBwdKeys / 8][4], dp[kBwdKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kBwdKeys / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
    mma_abt<D, kBwdKeys / 8>(s, wQ, cK, lane);    // S = Q K^T
    mma_abt<D, kBwdKeys / 8>(dp, wdO, cV, lane);  // dP = dO V^T
    uint32_t dsf[kBwdKeys / 16][4];  // dS = P (dP - Delta) as bf16 A fragments over the keys
#pragma unroll
    for (int i = 0; i < kBwdKeys / 8; ++i) {
      const float p0 = exp2f(fmaf(s[i][0], scale_log2, -lse2[0]));
      const float p1 = exp2f(fmaf(s[i][1], scale_log2, -lse2[0]));
      const float p2 = exp2f(fmaf(s[i][2], scale_log2, -lse2[1]));
      const float p3 = exp2f(fmaf(s[i][3], scale_log2, -lse2[1]));
      dsf[i >> 1][(i & 1) * 2 + 0] = pack_bf16x2(p0 * (dp[i][0] - dl[0]), p1 * (dp[i][1] - dl[0]));
      dsf[i >> 1][(i & 1) * 2 + 1] = pack_bf16x2(p2 * (dp[i][2] - dl[1]), p3 * (dp[i][3] - dl[1]));
    }
    mma_ab<D, kBwdKeys / 16>(acc, dsf, cK, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<D>(dq + base + int64_t(q0 + warp * 16) * stride, acc, stride, scale, lane);
}

template <int D>
cudaError_t launch_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* lse, const void* dout, void* delta, void* dq,
                                  void* dk, void* dv, int B, int S, int H, float scale,
                                  cudaStream_t stream) {
  const int64_t rows = int64_t(B) * S * H;
  const int64_t threads = rows * (D / 8);
  flash_attn_bwd_delta_kernel<D><<<unsigned((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_smem = BwdTile<D>::kDkdvBytes;
  err = cudaFuncSetAttribute(flash_attn_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(dkdv_smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBwdRows, B * H);
  flash_attn_bwd_dkdv_kernel<D><<<grid, kBwdThreads, dkdv_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_smem = BwdTile<D>::kDqBytes;
  err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(dq_smem));
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dq_kernel<D><<<grid, kBwdThreads, dq_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, H, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vmv

// q, k, v, o, dout, dq, dk, dv: bf16 [B, S, H, D], contiguous; lse: fp32
// [B, H, S] from the forward (natural log of the row sums of exp(S * scale));
// delta: fp32 [B, H, S] scratch. Returns a cudaError_t value; a shape the
// kernels do not take is cudaErrorInvalidValue.
extern "C" int vmv_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* lse, const void* dout, void* delta, void* dq,
                                  void* dk, void* dv, int B, int S, int H, int D, float scale,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || S % vmv::kBwdRows != 0) return int(cudaErrorInvalidValue);
  if (D == 64) {
    return int(vmv::launch_flash_attn_bwd<64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, S, H,
                                              scale, st));
  }
  if (D == 128) {
    return int(vmv::launch_flash_attn_bwd<128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, S,
                                               H, scale, st));
  }
  return int(cudaErrorInvalidValue);
}
