// Fused spatial-transformer block (bf16): one whole depth-1 SpatialTransformer
//   GroupNorm(32) -> proj_in -> LN -> self-attention -> LN -> cross-attention
//   over the context -> LN -> GEGLU feed-forward -> proj_out -> + x
// for x [R, S, C] (R = batch·frames rows of S = H·W tokens) and a context
// [R, L, Cc], with C = heads·64.
//
// Replaces: videomv_tpu/ops/fused_spatial.py::_spatial_kernel (with
// _spatial_row, _attn, _layernorm; launched by _fst_impl). On the TPU one grid
// cell holds a whole row ([1024, 320] fp32 is 1.3 MB) and all 5 MB of weights
// in VMEM, and the grid walks the rows in order. An SM has 227 KB of shared
// memory and blocks run in any order, so the row is cut into 64-token tiles,
// and the two things that need a whole row get passes of their own:
//   * phase A (gn_stats_kernel, one block per (row, group)): the GroupNorm
//     moments in fp32, var = E[x^2] - mean^2, eps 1e-6; and (ctx_kv_kernel)
//     the cross-attention K2 = ctx·Wk2, V2 = ctx·Wv2 of every row, as one
//     [R·L, Cc] x [Cc, C] product each (no padding of L);
//   * phase B (spatial_kv_kernel, one block per (row, 64-token tile)):
//     normalise -> bf16 -> proj_in (+bias, fp32 r0) -> LN1 -> bf16 -> K1, V1
//     [R, S, C] bf16 (head h in columns 64h..64h+63);
//   * phase C (spatial_block_kernel, one block per (row, 64-query tile)):
//     everything else with the tile's fp32 residual stream resident in shared
//     memory: r0 and LN1 again (cheaper to recompute than to store: 3 % of
//     the block's products), Q, online-softmax attention over K1/V1 (the tile
//     step of attention_tile.cuh, shared with flash_attention.cu), out-proj
//     added into the residual, LN2, Q2, attention over K2/V2 (ragged last
//     tile masked with -inf before the max), out-proj, LN3, the GEGLU
//     feed-forward in inner chunks of 64 (ffn_tile.cuh, shared with
//     fused_ffn.cu), proj_out (+bias) + x -> bf16.
// One wrapper call runs the four kernels on one stream and counts as one
// launch of the fused block.
//
// What it keeps out of device memory: the block's intermediates (the
// normalised x, r0..r3, Q, the logits and probabilities, the head outputs,
// LN outputs, the [S, 8C] GEGLU intermediate). What it does not: K1 and V1
// (2 x R·S·C bf16, 63 MB at R = 48; a row's 1.3 MB stay in the 50 MB L2
// between phase B and phase C), K2/V2 (9 MB) and the GroupNorm moments.
//
// What bounds it on the H100: operations (0.28 TFLOP of bf16 products at
// R = 48 against 68 MB that must move). What limits this first version is the
// weights: every token tile re-reads the block's 5 MB of weights from L2
// through 32-bit fragment loads (48 rows x 16 tiles x 5 MB = 3.9 GB per call)
// with one block of 8 warps per SM (its shared memory: 200 KB), the same
// weakness fused_ffn.cu has. wgmma / TMA and weight tiles staged in shared
// memory are later work.
//
// Rounding points mirror the TPU kernel: bf16 after GroupNorm, after each
// LayerNorm, q/k/v per head, the head output before the out-proj, the GEGLU
// product before W2, r3 before proj_out; residuals r0..r3 fp32; logits scaled
// after the dot in fp32; probabilities are normalised after the PV product
// (online softmax) where the TPU kernel normalises before it; erff for the
// TPU kernel's rational erf.
//
// Shared memory of phase C at C = 320 (ld = 328): fp32 residual 64 x ld
// (83,968 B), bf16 Q / head outputs 64 x ld (41,984 B), and a 73,728 B
// scratch that is the LN output (the products' A operand) plus the FFN's g
// tile, or, while an attention runs, two warp groups' double-buffered K and V
// tiles (two heads at a time, 4 warps each): 199,680 B.
//
// Layout: the public layout is [R, S, C] as in the JAX package; the NCHW
// module permutes around the call (models/blocks.py), the kernel reads
// token-major rows only. Weights are in nn.Linear layout [out, in], which is
// the k-major B operand of mma.sync. Requirements (checked by the Python
// wrapper): bf16 x/ctx/weights, fp32 norm scales and biases, contiguous,
// C = heads·64 <= 384, S % 64 == 0, Cc % 16 == 0 and <= 1536, Iff % 64 == 0.

#include <math.h>
#include <stddef.h>
#include <string.h>

#include "attention_tile.cuh"
#include "ffn_tile.cuh"
#include "mma_utils.cuh"

namespace vmv {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;        // tokens per tile
constexpr int kMT = kBM / 16;  // m16 tiles per tile
constexpr int kD = 64;         // head dim
constexpr int kLdKV = kD + 8;  // padded K/V row, in elements
constexpr int kGroups = 32;
// two warp groups x two buffers x (K + V) x 64 keys
constexpr int kKVStageElems = kAttnBlockN * kLdKV;
constexpr size_t kAttnScratchBytes = size_t(2) * 2 * 2 * kKVStageElems * sizeof(bf16);

struct SpatialParams {
  const bf16* x;
  const bf16* ctx;
  bf16* out;
  float* stats;  // [R, 32, 2] mean, rstd
  bf16* k1;      // [R, S, C]
  bf16* v1;
  bf16* k2;  // [R·L, C]
  bf16* v2;
  const float* gn_s;
  const float* gn_b;
  const bf16* win;
  const float* bin;
  const float* ln1_s;
  const float* ln1_b;
  const bf16* wq1;
  const bf16* wk1;
  const bf16* wv1;
  const bf16* wo1;
  const float* bo1;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* wq2;
  const bf16* wk2;
  const bf16* wv2;
  const bf16* wo2;
  const float* bo2;
  const float* ln3_s;
  const float* ln3_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* wpo;
  const float* bpo;
  int R, S, C, L, Cc, heads, Iff;
  float scale_log2;
};
constexpr int kNumPointers = 34;

__host__ __device__ constexpr int tile_ld(int c) { return c + 8; }

__host__ size_t block_smem_bytes(int c) {
  const size_t opnd = size_t(kBM) * tile_ld(c) * sizeof(bf16);
  size_t scratch = opnd + size_t(kBM) * kFfnLdG * sizeof(bf16);
  if (scratch < kAttnScratchBytes) scratch = kAttnScratchBytes;
  return size_t(kBM) * tile_ld(c) * sizeof(float) + opnd + scratch;
}

__host__ size_t kv_smem_bytes(int c) {
  return size_t(kBM) * tile_ld(c) * (sizeof(float) + sizeof(bf16));
}

// acc[t][m] = A[16m..16m+15, :K] · W_t^T for NT column tiles of 8, A in shared
// memory (rows of lda elements), wp[t] this lane's B fragment row of tile t.
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][kMT][4], const bf16* sA, int lda,
                                          const bf16* const (&wp)[NT], int K, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      acc[t][m][0] = acc[t][m][1] = acc[t][m][2] = acc[t][m][3] = 0.f;
    }
  }
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      b[t][0] = ldg_u32(wp[t] + kk);
      b[t][1] = ldg_u32(wp[t] + kk + 8);
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      uint32_t a[4];
      ldmatrix_x4(a, sA + (m * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_bf16_16816(acc[t][m], a, b[t][0], b[t][1]);
    }
  }
}

// The tile's [64, K] operand times W [N, K]^T (nn.Linear layout, row stride
// ldw), 16 output columns per warp at a time; epi(row, col, v0, v1) receives
// the fp32 products of (row, col) and (row, col + 1), one owner per element.
template <class Epi>
__device__ __forceinline__ void block_linear(const bf16* sA, int lda, int K, const bf16* W,
                                             int ldw, int N, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q2 = (lane & 3) * 2;
  for (int nt = warp * 2; nt < N / 8; nt += kWarps * 2) {
    const bf16* const wp[2] = {W + int64_t(nt * 8 + g) * ldw + q2,
                               W + int64_t(nt * 8 + 8 + g) * ldw + q2};
    float acc[2][kMT][4];
    warp_gemm<2>(acc, sA, lda, wp, K, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = (nt + t) * 8 + q2;
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        epi(m * 16 + g, col, acc[t][m][0], acc[t][m][1]);
        epi(m * 16 + g + 8, col, acc[t][m][2], acc[t][m][3]);
      }
    }
  }
}

// Per-token LayerNorm (eps 1e-5, two-pass fp32 moments) of the fp32 tile into
// the bf16 operand tile; one warp per row.
__device__ __forceinline__ void tile_layernorm(const float* sR, bf16* sA, int ld, int C,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kBM; r += kWarps) {
    const float* row = sR + r * ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += row[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / float(C);
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / float(C) + 1e-5f);
    for (int c = lane; c < C; c += 32) {
      sA[r * ld + c] = __float2bfloat16_rn((row[c] - mean) * rstd * scale[c] + bias[c]);
    }
  }
}

// The front of a token tile, shared by phases B and C: x -> GroupNorm -> bf16
// -> proj_in (+bias) = r0 in sR (fp32) -> LN1 -> bf16 in sA. Ends on a barrier.
__device__ __forceinline__ void tile_front(const SpatialParams& p, int row, int t0, float* sR,
                                           bf16* sA, int ld) {
  const int tid = threadIdx.x;
  const int C = p.C;
  const int cpr = C / 8;
  const int cpg = C / kGroups;
  const float* st = p.stats + int64_t(row) * kGroups * 2;
  const bf16* xr = p.x + (int64_t(row) * p.S + t0) * C;
  for (int c = tid; c < kBM * cpr; c += kThreads) {
    const int r = c / cpr;
    const int col = (c - r * cpr) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + int64_t(r) * C + col);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c0 = col + 2 * i, c1 = c0 + 1;
      const int g0 = c0 / cpg, g1 = c1 / cpg;
      const float h0 =
          (__bfloat162float(e[2 * i]) - st[2 * g0]) * st[2 * g0 + 1] * p.gn_s[c0] + p.gn_b[c0];
      const float h1 = (__bfloat162float(e[2 * i + 1]) - st[2 * g1]) * st[2 * g1 + 1] *
                           p.gn_s[c1] + p.gn_b[c1];
      o[i] = pack_bf16x2(h0, h1);
    }
    *reinterpret_cast<uint4*>(sA + r * ld + col) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();
  const float* bin = p.bin;
  block_linear(sA, ld, C, p.win, C, C, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(sR + r * ld + col) = make_float2(v0 + bin[col], v1 + bin[col + 1]);
  });
  __syncthreads();
  tile_layernorm(sR, sA, ld, C, p.ln1_s, p.ln1_b);
  __syncthreads();
}

// ---- phase A: GroupNorm moments of one (row, group)
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int S, int C) {
  __shared__ float red[2][kWarps];
  const int grp = blockIdx.x, row = blockIdx.y;
  const int cpg = C / kGroups;  // even: C is a multiple of 64
  const bf16* xr = x + int64_t(row) * S * C + grp * cpg;
  float sum = 0.f, sq = 0.f;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(xr + int64_t(s) * C);
    for (int i = 0; i < cpg / 2; ++i) {
      const float2 v = __bfloat1622float2(pr[i]);
      sum += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    const float n = float(S) * float(cpg);
    const float mean = a / n;
    const float var = b / n - mean * mean;
    stats[(int64_t(row) * kGroups + grp) * 2] = mean;
    stats[(int64_t(row) * kGroups + grp) * 2 + 1] = rsqrtf(var + 1e-6f);
  }
}

// ---- phase A: K2 / V2 = ctx · Wk2 / Wv2 over the flattened [R·L, Cc] context
__global__ void __launch_bounds__(kThreads)
ctx_kv_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ wk,
              const bf16* __restrict__ wv, bf16* __restrict__ k2, bf16* __restrict__ v2, int M,
              int Cc, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [64][Cc + 8]
  const int ld = tile_ld(Cc);
  const int m0 = blockIdx.x * kBM;
  const int cpr = Cc / 8;
  for (int c = threadIdx.x; c < kBM * cpr; c += kThreads) {
    const int r = c / cpr;
    const int col = (c - r * cpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(ctx + int64_t(m0 + r) * Cc + col);
    *reinterpret_cast<uint4*>(sA + r * ld + col) = val;
  }
  __syncthreads();
  const bf16* W = blockIdx.y == 0 ? wk : wv;
  bf16* dst = blockIdx.y == 0 ? k2 : v2;
  block_linear(sA, ld, Cc, W, Cc, N, [&](int r, int col, float v0, float v1) {
    if (m0 + r < M) {
      *reinterpret_cast<uint32_t*>(dst + int64_t(m0 + r) * N + col) = pack_bf16x2(v0, v1);
    }
  });
}

// ---- phase B: K1 / V1 of one (row, 64-token tile)
__global__ void __launch_bounds__(kThreads, 1) spatial_kv_kernel(const SpatialParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(p.C);
  float* sR = reinterpret_cast<float*>(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(sR + kBM * ld);
  const int row = blockIdx.y, t0 = blockIdx.x * kBM;
  tile_front(p, row, t0, sR, sA, ld);
  const int C = p.C;
  bf16* kd = p.k1 + (int64_t(row) * p.S + t0) * C;
  bf16* vd = p.v1 + (int64_t(row) * p.S + t0) * C;
  block_linear(sA, ld, C, p.wk1, C, C, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(kd + int64_t(r) * C + col) = pack_bf16x2(v0, v1);
  });
  block_linear(sA, ld, C, p.wv1, C, C, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(vd + int64_t(r) * C + col) = pack_bf16x2(v0, v1);
  });
}

// Attention of the tile's 64 queries (all heads' Q in sQ, bf16) over kv_len
// keys of K / V in device memory (token stride C, head h in columns 64h..):
// two heads at a time, one per group of 4 warps, each warp 16 query rows, K/V
// tiles of 64 keys double-buffered in sKV; the head outputs replace Q in sQ.
// Both groups walk the same number of tiles, so the block's barriers line up;
// a group without a head (odd head count, last round) only keeps the barriers.
__device__ __forceinline__ void block_attention(bf16* sQ, int ld, bf16* sKV,
                                                const bf16* __restrict__ kg,
                                                const bf16* __restrict__ vg, int kv_len, int C,
                                                int heads, float scale_log2) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = warp >> 2;
  const int wg = warp & 3;
  const int gt = tid & 127;
  bf16* stage = sKV + group * 4 * kKVStageElems;  // [2 buffers][K | V][64][kLdKV]
  const int n_tiles = (kv_len + kAttnBlockN - 1) / kAttnBlockN;

  for (int h0 = 0; h0 < heads; h0 += 2) {
    const int h = h0 + group;
    const bool active = h < heads;
    const bf16* kh = kg + h * kD;
    const bf16* vh = vg + h * kD;

    auto load_tile = [&](int buf, int j) {
      bf16* dK = stage + buf * 2 * kKVStageElems;
      bf16* dV = dK + kKVStageElems;
      for (int c = gt; c < kAttnBlockN * (kD / 8); c += 128) {
        const int r = c >> 3;
        const int col = (c & 7) * 8;
        const int key = j * kAttnBlockN + r;
        if (key < kv_len) {
          cp_async_16(dK + r * kLdKV + col, kh + int64_t(key) * C + col);
          cp_async_16(dV + r * kLdKV + col, vh + int64_t(key) * C + col);
        } else {  // keys past the end: zeros, masked in the logits
          *reinterpret_cast<uint4*>(dK + r * kLdKV + col) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(dV + r * kLdKV + col) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };

    uint32_t qf[kD / 16][4];
    float o_acc[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) o_acc[i][0] = o_acc[i][1] = o_acc[i][2] = o_acc[i][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    if (active) {
      load_tile(0, 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        ldmatrix_x4(qf[kk],
                    sQ + (wg * 16 + (lane & 15)) * ld + h * kD + kk * 16 + (lane >> 4) * 8);
      }
    }
    cp_async_commit();

    for (int j = 0; j < n_tiles; ++j) {
      const int buf = j & 1;
      if (j + 1 < n_tiles) {
        if (active) load_tile(buf ^ 1, j + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const bf16* cK = stage + buf * 2 * kKVStageElems;
        const bf16* cV = cK + kKVStageElems;
        attn_tile_step<kD, kLdKV, true>(qf, cK, cV, o_acc, m_run, l_run, scale_log2, lane,
                                        kv_len - j * kAttnBlockN);
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    if (active) {  // the head output, bf16, over this warp's own Q
      bf16* od = sQ + (wg * 16 + (lane >> 2)) * ld + h * kD + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(od + i * 8) =
            pack_bf16x2(o_acc[i][0] / l_run[0], o_acc[i][1] / l_run[0]);
        *reinterpret_cast<uint32_t*>(od + 8 * ld + i * 8) =
            pack_bf16x2(o_acc[i][2] / l_run[1], o_acc[i][3] / l_run[1]);
      }
    }
  }
  __syncthreads();
}

// ---- phase C: the rest of the block for one (row, 64-query tile)
__global__ void __launch_bounds__(kThreads, 1) spatial_block_kernel(const SpatialParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C;
  const int ld = tile_ld(C);
  float* sR = reinterpret_cast<float*>(smem_raw);     // [64][ld] fp32 residual stream
  bf16* sQ = reinterpret_cast<bf16*>(sR + kBM * ld);  // [64][ld] Q, then head outputs
  bf16* sA = sQ + kBM * ld;                           // [64][ld] operand; K/V stages
  bf16* sG = sA + kBM * ld;                           // [64][kFfnLdG] GEGLU tile
  const int tid = threadIdx.x;
  const int row = blockIdx.y, t0 = blockIdx.x * kBM;

  tile_front(p, row, t0, sR, sA, ld);  // sR = r0, sA = LN1(r0)

  auto to_q = [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(sQ + r * ld + col) = pack_bf16x2(v0, v1);
  };
  auto add_residual = [&](const float* bias) {
    return [=](int r, int col, float v0, float v1) {
      float2* d = reinterpret_cast<float2*>(sR + r * ld + col);
      const float2 old = *d;
      *d = make_float2(old.x + (v0 + bias[col]), old.y + (v1 + bias[col + 1]));
    };
  };

  // ---- self-attention: r1 = r0 + attn1(LN1(r0))
  block_linear(sA, ld, C, p.wq1, C, C, to_q);
  __syncthreads();
  block_attention(sQ, ld, sA, p.k1 + int64_t(row) * p.S * C, p.v1 + int64_t(row) * p.S * C, p.S,
                  C, p.heads, p.scale_log2);
  block_linear(sQ, ld, C, p.wo1, C, C, add_residual(p.bo1));
  __syncthreads();

  // ---- cross-attention: r2 = r1 + attn2(LN2(r1), ctx)
  tile_layernorm(sR, sA, ld, C, p.ln2_s, p.ln2_b);
  __syncthreads();
  block_linear(sA, ld, C, p.wq2, C, C, to_q);
  __syncthreads();
  block_attention(sQ, ld, sA, p.k2 + int64_t(row) * p.L * C, p.v2 + int64_t(row) * p.L * C, p.L,
                  C, p.heads, p.scale_log2);
  block_linear(sQ, ld, C, p.wo2, C, C, add_residual(p.bo2));
  __syncthreads();

  // ---- GEGLU feed-forward: r3 = r2 + ff(LN3(r2)), accumulated into sR
  tile_layernorm(sR, sA, ld, C, p.ln3_s, p.ln3_b);
  __syncthreads();
  geglu_ffn_tile<kMT>(sA, sR, sG, ld, p.w1, p.b1, p.w2, C, p.Iff);

  // ---- proj_out(r3 + b2 -> bf16) + bias + x -> bf16
  const int half = C / 2;
  for (int c = tid; c < kBM * half; c += kThreads) {
    const int r = c / half;
    const int col = (c - r * half) * 2;
    const float2 a = *reinterpret_cast<const float2*>(sR + r * ld + col);
    *reinterpret_cast<uint32_t*>(sA + r * ld + col) =
        pack_bf16x2(a.x + p.b2[col], a.y + p.b2[col + 1]);
  }
  __syncthreads();
  const bf16* xr = p.x + (int64_t(row) * p.S + t0) * C;
  bf16* od = p.out + (int64_t(row) * p.S + t0) * C;
  const float* bpo = p.bpo;
  block_linear(sA, ld, C, p.wpo, C, C, [&](int r, int col, float v0, float v1) {
    const uint32_t raw = ldg_u32(xr + int64_t(r) * C + col);
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    *reinterpret_cast<uint32_t*>(od + int64_t(r) * C + col) =
        pack_bf16x2(xv.x + (v0 + bpo[col]), xv.y + (v1 + bpo[col + 1]));
  });
}

}  // namespace
}  // namespace vmv

// ptrs: a host array of 34 device pointers in the order of SpatialParams
// (x, ctx, out, stats, k1, v1, k2, v2, then the weights as the Python wrapper
// lists them). x, out, k1, v1 [R, S, C]; ctx [R, L, Cc]; k2, v2 [R·L, C];
// stats fp32 [R, 32, 2]. Returns a cudaError_t value.
extern "C" int vmv_fused_spatial_fwd(const void* const* ptrs, int R, int S, int C, int L, int Cc,
                                     int heads, int Iff, void* stream) {
  using namespace vmv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || S <= 0 || S % kBM != 0 || heads <= 0 || C != heads * kD || C > 384 || L <= 0 ||
      Cc <= 0 || Cc % 16 != 0 || Cc > 1536 || Iff <= 0 || Iff % kFfnChunk != 0) {
    return int(cudaErrorInvalidValue);
  }
  SpatialParams p;
  static_assert(sizeof(void*) * kNumPointers == offsetof(SpatialParams, R),
                "the pointer block of SpatialParams is kNumPointers pointers");
  memcpy(&p, ptrs, sizeof(void*) * kNumPointers);
  p.R = R;
  p.S = S;
  p.C = C;
  p.L = L;
  p.Cc = Cc;
  p.heads = heads;
  p.Iff = Iff;
  p.scale_log2 = 0.125f * 1.4426950408889634f;  // 64^-1/2 · log2(e)

  const size_t smem_ctx = size_t(kBM) * tile_ld(Cc) * sizeof(bf16);
  const size_t smem_kv = kv_smem_bytes(C);
  const size_t smem_blk = block_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(ctx_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_ctx));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(spatial_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_kv));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(spatial_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_blk));
  if (err != cudaSuccess) return int(err);

  gn_stats_kernel<<<dim3(kGroups, R), kThreads, 0, st>>>(p.x, p.stats, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int M = R * L;
  ctx_kv_kernel<<<dim3((M + kBM - 1) / kBM, 2), kThreads, smem_ctx, st>>>(p.ctx, p.wk2, p.wv2,
                                                                          p.k2, p.v2, M, Cc, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid(S / kBM, R);
  spatial_kv_kernel<<<grid, kThreads, smem_kv, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  spatial_block_kernel<<<grid, kThreads, smem_blk, st>>>(p);
  return int(cudaGetLastError());
}
