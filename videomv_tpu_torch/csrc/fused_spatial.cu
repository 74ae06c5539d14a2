// Fused spatial-transformer block (bf16): one whole depth-1 SpatialTransformer
//   GroupNorm(32) -> proj_in -> LN -> self-attention -> LN -> cross-attention
//   over the context -> LN -> GEGLU feed-forward -> proj_out -> + x
// for x [R, S, C] (R = batch·frames rows of S = H·W tokens) and a context
// [R, L, Cc], at the UNets' 32² stage: C = 320 (5 heads of 64), Cc = 1024.
//
// Replaces: videomv_tpu/ops/fused_spatial.py::_spatial_kernel (with
// _spatial_row, _attn, _layernorm; launched by _fst_impl). On the TPU one grid
// cell holds a whole row ([1024, 320] fp32 is 1.3 MB) and all 5 MB of weights
// in VMEM, and the grid walks the rows in order. An SM has 227 KB of shared
// memory and blocks run in any order, so the row is cut into 64-token tiles,
// and the two things that need a whole row get passes of their own:
//   * phase A (gn_stats_kernel, one block per (row, group)): the GroupNorm
//     moments in fp32, var = E[x^2] - mean^2, eps 1e-6; and
//     (spatial_ctx_kv_wgmma_kernel) the cross-attention K2 = ctx·Wk2,
//     V2 = ctx·Wv2 of every row, as one [R·L, Cc] x [Cc, C] product each (no
//     padding of L);
//   * phase B (spatial_front_kv_wgmma_kernel, one block per (row, 64-token
//     tile)): normalise -> bf16 -> proj_in (+bias, fp32 r0) -> LN1 -> bf16 ->
//     K1, V1 [R, S, C] bf16 (head h in columns 64h..64h+63);
//   * phase C (spatial_block_wgmma_kernel, one block per (row, 64-query
//     tile)): everything else with the tile's fp32 residual stream resident in
//     shared memory: r0 and LN1 again (cheaper to recompute than to store: 3 %
//     of the block's products), Q, online-softmax attention over K1/V1,
//     out-proj added into the residual, LN2, Q2, attention over K2/V2 (ragged
//     last tile masked with -inf before the max), out-proj, LN3, the GEGLU
//     feed-forward in inner chunks of 64, proj_out (+bias) + x -> bf16.
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
// R = 48 against 68 MB that must move; 0.287 ms).
//
// How the three product phases use the card:
//   * a block is two consumer warpgroups (256 threads, up to 255 registers:
//     ptxas holds wgmma loops to the launch's register count, so there is no
//     producer warpgroup) and owns 64 tokens; each warpgroup computes 160 of
//     the 320 output columns of every product as two m64n80k16 wgmmas, bf16
//     in, fp32 accumulators in registers.
//   * the A operands (GroupNorm and LN outputs, Q, the head outputs, g, r3)
//     are written by hand into one bf16 [64 x 320] operand of five
//     128-byte-swizzled [64 x 64] tiles (sw128_offset, then a proxy fence);
//     the weights arrive by TMA from 2-D maps over their nn.Linear [out, in]
//     layout (the K-major B operand as it lies) into a ring of 4 stages of two
//     [80 x 64] boxes with full mbarriers; the last of the 8 warps done with
//     a stage refills it. Each product's first stages load while the
//     LayerNorm before it runs. The K loop of a product is unrolled: with a
//     loop back-edge ptxas injects a wait that keeps the groups from
//     overlapping.
//   * the fp32 residual r0..r3 stays in shared memory ([64 x 328], 83,968 B);
//     the out-projections add into it in their epilogue; LayerNorm is one
//     warp per 8 rows with a row's values in registers (two-pass moments).
//   * attention per head is flash_attention.cu's tile step: QK^T by
//     m64n128k16 with Q_h read from the operand tile, P rounded to bf16 in
//     registers as the A operand of PV (m64n64k16, V the MN-major B operand),
//     online softmax in base 2. K/V tiles of 128 keys arrive by TMA through
//     4-D maps over [R, tokens, heads, 64] (K1/V1 [R, S, C], K2/V2 [R·L, C]
//     read in place), three stages that alias the weight ring and the g tiles.
//     Tokens past L arrive as zeros and are masked with -inf before the max.
//     Heads 0-3 go two by two to the warpgroups; the fifth is split by keys,
//     each warpgroup half the tiles, and (m, l, O) are merged through shared
//     memory, so both warpgroups walk the same number of tiles.
//   * the GEGLU feed-forward is geglu_ffn_wgmma_kernel<320>'s chunk loop: per
//     64 inner columns a W1 stage holds each warpgroup's 32 lin and 32 gate
//     rows (one m64n64 gives both in the same registers), the gelu runs in
//     registers into a double-buffered swizzled g tile, and W2 accumulates
//     into registers over the chunks; r3 = r2 + that + b2 goes straight to the
//     bf16 operand of proj_out.
//   * host: the twelve weight maps are encoded once per set of weight
//     pointers and kept; the context's and the four K/V maps per call; the
//     shared-memory limits are set once per device.
// Shared memory of phase C: 1,024 (alignment) + 83,968 (residual) + 40,960
// (operand) + 81,920 (weight ring) + 16,384 (g tiles) + 256 (barriers) =
// 224,512 B; phase B has no g tiles; phase A holds the context rows [64, 1024]
// (131,072 B) and the ring.
//
// Rounding points mirror the TPU kernel: bf16 after GroupNorm, after each
// LayerNorm, q/k/v per head, the head output before the out-proj, the GEGLU
// product before W2, r3 before proj_out; residuals r0..r3 fp32; logits scaled
// after the dot in fp32; probabilities are normalised after the PV product
// (online softmax) where the TPU kernel normalises before it; erff for the
// TPU kernel's rational erf.
//
// Layout: the public layout is [R, S, C] as in the JAX package; the NCHW
// module permutes around the call (models/blocks.py), the kernel reads
// token-major rows only. Weights are in nn.Linear layout [out, in], which is
// the k-major B operand of wgmma. Requirements (checked by the Python wrapper
// and the C entry): bf16 x/ctx/weights, fp32 norm scales and biases,
// contiguous, C = 320 with 5 heads, Cc = 1024, S % 64 == 0, Iff % 64 == 0.
// Other shapes take the module path (the gate is
// ops/fused_spatial.py::spatial_fused_eligible).

#include <math.h>
#include <stddef.h>
#include <string.h>

#include <mutex>

#include "hopper_utils.cuh"
#include "mma_utils.cuh"
#include "wgmma_ops.cuh"

namespace vmv {
namespace {

constexpr int kThreads = 256;  // of gn_stats_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;        // tokens per tile
constexpr int kD = 64;         // head dim
constexpr int kGroups = 32;
constexpr int kFfnChunk = 64;  // inner columns of the feed-forward per step

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

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x / 1.4142135623730951f));
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

// ======================================= the wgmma kernels (sm_90a, C = 320)
// Two consumer warpgroups per block (256 threads, up to 255 registers each;
// no producer warpgroup, see the note at the top); a block owns 64 tokens.
// Measurement switches (never defined in a normal build; the results are then
// wrong and only the times mean something): VMV_SP_NOLOAD leaves out the
// weights' TMA loads, VMV_SP_NOKV the K/V loads (the stage's barrier is
// arrived on without data), VMV_SP_NOGEMM all but one wgmma of each stage of
// the products, VMV_SP_NOATTN all but one wgmma of QK^T and of PV, VMV_SP_NOEXP
// the exp2 of the softmax. chip_smoke.py --phases env,spatial_ablation times
// them.
constexpr int kSpC = 320;
constexpr int kSpHeads = kSpC / kD;                          // 5
constexpr int kSpKB = kSpC / 64;                             // K blocks of a C-wide operand
constexpr int kSpThreads = 256;
constexpr int kSpN = 80;                                     // columns of one wgmma
constexpr int kSpWgCols = 2 * kSpN;                          // a warpgroup's output columns
constexpr int kSpLdR = kSpC + 8;                             // fp32 residual row (conflict-free)
constexpr int kSpResBytes = kBM * kSpLdR * 4;                // 83,968
constexpr int kSpTileBytes = kBM * kSwizzleRowBytes;         // one swizzled [64 x 64] tile
constexpr int kSpOpBytes = kSpKB * kSpTileBytes;             // the bf16 A operand [64 x 320]
constexpr int kSpStageBytes = 2 * kSpN * kSwizzleRowBytes;   // a weight stage: 2 x [80 x 64]
constexpr int kSpStages = 4;
constexpr int kSpRingBytes = kSpStages * kSpStageBytes;
constexpr int kSpGBytes = 2 * kSpTileBytes;                  // the GEGLU g tiles
constexpr int kSpKeys = 128;                                 // keys per K/V tile
constexpr int kSpKvTileBytes = kSpKeys * kSwizzleRowBytes;
constexpr int kSpKvStageBytes = 2 * kSpKvTileBytes;          // K and V of one tile
constexpr int kSpKvStages = 3;
constexpr int kSpBarBytes = 256;
constexpr int kSpLG = 32;                                    // lin columns / warpgroup / chunk
constexpr int kSpW1StageBytes = 2 * 2 * kSpLG * kSwizzleRowBytes;
constexpr int kSpFfnLoads = kSpKB + 2;                       // per chunk: W1 stages, W2 stages
constexpr int kSpFrontSmem = 1024 + kSpResBytes + kSpOpBytes + kSpRingBytes + kSpBarBytes;
constexpr int kSpBlockSmem = kSpFrontSmem + kSpGBytes;
constexpr int kSpCc = 1024;                                  // the context width it takes
constexpr int kSpCtxKB = kSpCc / 64;
constexpr int kSpCtxSmem = 1024 + kSpCtxKB * kSpTileBytes + kSpRingBytes + kSpBarBytes;
static_assert(kSpHeads % 2 == 1, "the last head is the one split between the warpgroups");
static_assert(kSpResBytes % 1024 == 0 && kSpStageBytes % 1024 == 0, "tiles stay 1024-aligned");
static_assert(kSpKvStages * kSpKvStageBytes <= kSpRingBytes + kSpGBytes,
              "the K/V stages alias the weight ring and the g tiles");
static_assert(kSpBlockSmem <= kMaxDynamicSmem && kSpCtxSmem <= kMaxDynamicSmem, "shared memory");
static_assert(36 * 128 * 4 <= kSpRingBytes, "the merge of the split head fits the ring");

// the weights' tensor maps, in this order
enum { kWin, kWq1, kWk1, kWv1, kWo1, kWq2, kWk2, kWv2, kWo2, kW1, kW2, kWpo, kSpWeights };
struct alignas(64) SpatialMaps {
  CUtensorMap w[kSpWeights];
  CUtensorMap ctx;             // [R·L, Cc], boxes [64 x 64]
  CUtensorMap k1, v1, k2, v2;  // [R, S or L, heads, 64], boxes of one head's 128 tokens
};

struct SpBars {
  uint64_t wfull[kSpStages];
  uint64_t kvfull[kSpKvStages];
  uint64_t abar;
  unsigned int wdone[kSpStages];  // per stage, the consumer warps done with it (counts on)
  unsigned int kvdone[kSpKvStages];
};
static_assert(sizeof(SpBars) <= kSpBarBytes, "barriers");

__device__ __forceinline__ void sp_init_bars(SpBars* b) {
  for (int s = 0; s < kSpStages; ++s) {
    mbar_init(&b->wfull[s], 1);
    b->wdone[s] = 0;
  }
  for (int s = 0; s < kSpKvStages; ++s) {
    mbar_init(&b->kvfull[s], 1);
    b->kvdone[s] = 0;
  }
  mbar_init(&b->abar, 1);
  mbar_init_fence();
}

// A ring of stages in shared memory; g0 is the global index of the current
// session's first load (every thread keeps it, so stage and parity follow).
struct Ring {
  unsigned char* base;
  SpBars* bars;
  uint32_t g0;
};

// ---- the weight ring. A session is one product's loads in the order they
// are consumed; every stage is read by both warpgroups (8 warps), and the last
// warp to finish one refills it with the load kSpStages further on.
struct WSess {
  const CUtensorMap* map;   // the weight [N = 320, K]; W1 of the feed-forward
  const CUtensorMap* map2;  // W2 of the feed-forward; null for a plain product
  int n_loads;
  int kb;                   // K blocks
  int inner;                // the feed-forward's inner width
};

__device__ __forceinline__ WSess linear_sess(const CUtensorMap* m, int kb) {
  return WSess{m, nullptr, 2 * kb, kb, 0};
}

__device__ __forceinline__ WSess ffn_sess(const CUtensorMap* w1, const CUtensorMap* w2,
                                          int inner) {
  return WSess{w1, w2, inner / 64 * kSpFfnLoads, kSpKB, inner};
}

// load n of session s into `dst` (one thread). A plain product: per K block
// two stages, each the rows [w·160 + half·80, +80) for both warpgroups w. The
// feed-forward: per 64-column chunk, KB stages of W1 (each warpgroup's 32 lin
// rows, then its 32 gate rows) and two of W2 (80 output rows per warpgroup).
__device__ __forceinline__ void w_issue(const WSess& s, int n, unsigned char* dst,
                                        uint64_t* bar) {
#ifdef VMV_SP_NOLOAD
  mbar_arrive(bar);
  return;
#endif
  if (s.map2 == nullptr) {
    const int kb = n >> 1, half = n & 1;
    mbar_arrive_expect_tx(bar, kSpStageBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      tma_load_2d(dst + w * kSpN * kSwizzleRowBytes, s.map, bar, kb * 64,
                  w * kSpWgCols + half * kSpN);
    }
    return;
  }
  const int j = n / kSpFfnLoads;
  const int r = n - j * kSpFfnLoads;
  const int j0 = j * 64;
  if (r < kSpKB) {
    mbar_arrive_expect_tx(bar, kSpW1StageBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      unsigned char* d = dst + w * 2 * kSpLG * kSwizzleRowBytes;
      tma_load_2d(d, s.map, bar, r * 64, j0 + w * kSpLG);
      tma_load_2d(d + kSpLG * kSwizzleRowBytes, s.map, bar, r * 64, s.inner + j0 + w * kSpLG);
    }
  } else {
    mbar_arrive_expect_tx(bar, kSpStageBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      tma_load_2d(dst + w * kSpN * kSwizzleRowBytes, s.map2, bar, j0,
                  w * kSpWgCols + (r - kSpKB) * kSpN);
    }
  }
}

// thread 0, once the ring's memory is free: the session's first loads
__device__ __forceinline__ void w_start(const Ring& r, const WSess& s) {
  for (int n = 0; n < kSpStages && n < s.n_loads; ++n) {
    const int st = (r.g0 + n) % kSpStages;
    w_issue(s, n, r.base + st * kSpStageBytes, &r.bars->wfull[st]);
  }
}

__device__ __forceinline__ int w_wait(const Ring& r, int n) {
  const uint32_t gi = r.g0 + n;
  const int st = gi % kSpStages;
  mbar_wait(&r.bars->wfull[st], (gi / kSpStages) & 1);
  return st;
}

// a consumer warp is done with load n (its wgmma group has completed)
__device__ __forceinline__ void w_release(const Ring& r, const WSess& s, int n) {
  if ((threadIdx.x & 31) == 0) {
    const int st = (r.g0 + n) % kSpStages;
    __threadfence_block();
    const unsigned int before = atomicAdd(&r.bars->wdone[st], 1u);
    if ((before & 7u) == 7u) {
      __threadfence_block();
      if (n + kSpStages < s.n_loads) {
        w_issue(s, n + kSpStages, r.base + st * kSpStageBytes, &r.bars->wfull[st]);
      }
    }
  }
  __syncwarp();
}

// acc = A[64 x 64·KB] · W^T for this warpgroup's 160 output columns (two
// m64n80 accumulators), A as KB swizzled tiles, W from the session's stages.
// The K loop is unrolled: ptxas keeps the wgmma groups of a loop with a
// back-edge from overlapping (it injects a wait at the loop head).
template <int KB>
__device__ __forceinline__ void sp_linear(float (&acc)[2][40], const unsigned char* A,
                                          const Ring& ring, const WSess& s, int wg) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const uint64_t da = wgmma_desc_sw128(A + kb * kSpTileBytes);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * kb + half;
      const int st = w_wait(ring, n);
      const uint64_t db = wgmma_desc_sw128(ring.base + st * kSpStageBytes +
                                           wg * kSpN * kSwizzleRowBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#ifdef VMV_SP_NOGEMM
        if (k) continue;
#endif
        wgmma_ss_n80(acc[half], da + k * kDescStepK16, db + k * kDescStepK16, (kb | k) != 0);
      }
      wgmma_commit();
      if (n > 0) {  // the group before this one has read its stage
        wgmma_wait<1>();
        w_release(ring, s, n - 1);
      }
    }
  }
  wgmma_wait<0>();
  w_release(ring, s, 2 * KB - 1);
}

// The thread's index, read anew at each use: the epilogues' per-element
// offsets depend on it alone, and with threadIdx.x the compiler computes them
// once and keeps them in registers across the whole kernel (it spilled).
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// f(i, row, col, v0, v1) for every pair i of this thread's accumulator
// elements (i < 40, a constant after unrolling)
template <class F>
__device__ __forceinline__ void acc_foreach_i(const float (&acc)[2][40], F f) {
  const int t = fresh_tid();
  const int wg = t >> 7, tid = t & 127;
  const int row = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int q2 = (tid & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < kSpN / 8; ++j) {
      const int col = wg * kSpWgCols + half * kSpN + j * 8 + q2;
      const int i = (half * (kSpN / 8) + j) * 2;
      f(i, row, col, acc[half][4 * j], acc[half][4 * j + 1]);
      f(i + 1, row + 8, col, acc[half][4 * j + 2], acc[half][4 * j + 3]);
    }
  }
}

// f(row, col, v0, v1) for every pair of this thread's accumulator elements
template <class F>
__device__ __forceinline__ void acc_foreach(const float (&acc)[2][40], F f) {
  acc_foreach_i(acc, [&](int, int row, int col, float v0, float v1) { f(row, col, v0, v1); });
}

// element pair (row, col), (row, col + 1) of the swizzled bf16 operand
__device__ __forceinline__ void st_op(unsigned char* A, int row, int col, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(A + (col >> 6) * kSpTileBytes + sw128_offset(row, col & 63)) =
      pack_bf16x2(v0, v1);
}

// GroupNorm apply of the block's 64 tokens -> bf16 operand. All of a thread's
// loads of x are issued before the first is used.
__device__ __forceinline__ void sp_front_gn(const SpatialParams& p, int row, int t0,
                                            unsigned char* A) {
  constexpr int cpr = kSpC / 8;
  constexpr int cpg = kSpC / kGroups;
  constexpr int kIters = kBM * cpr / kSpThreads;
  static_assert(kBM * cpr % kSpThreads == 0, "16-byte chunks per thread");
  const float* st = p.stats + int64_t(row) * kGroups * 2;
  const bf16* xr = p.x + (int64_t(row) * p.S + t0) * kSpC;
  const int t = fresh_tid();
  uint4 raw[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = t + it * kSpThreads;
    const int r = c / cpr;
    raw[it] = __ldg(reinterpret_cast<const uint4*>(xr + int64_t(r) * kSpC + (c - r * cpr) * 8));
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = t + it * kSpThreads;
    const int r = c / cpr;
    const int col = (c - r * cpr) * 8;
    const bf16* e = reinterpret_cast<const bf16*>(&raw[it]);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c0 = col + 2 * i, c1 = c0 + 1;
      const int g0 = c0 / cpg, g1 = c1 / cpg;
      const float2 s0 = __ldg(reinterpret_cast<const float2*>(st) + g0);
      const float2 s1 = __ldg(reinterpret_cast<const float2*>(st) + g1);
      const float2 gs = __ldg(reinterpret_cast<const float2*>(p.gn_s + c0));
      const float2 gb = __ldg(reinterpret_cast<const float2*>(p.gn_b + c0));
      const float h0 = (__bfloat162float(e[2 * i]) - s0.x) * s0.y * gs.x + gb.x;
      const float h1 = (__bfloat162float(e[2 * i + 1]) - s1.x) * s1.y * gs.y + gb.y;
      o[i] = pack_bf16x2(h0, h1);
    }
    *reinterpret_cast<uint4*>(A + (col >> 6) * kSpTileBytes + sw128_offset(r, col & 63)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// LayerNorm (eps 1e-5, two-pass fp32 moments) of the residual rows -> bf16
// operand; one warp per 8 rows, a row's 320 values in the lanes' registers
__device__ __forceinline__ void sp_layernorm(const float* sR, unsigned char* A,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  const int t = fresh_tid();
  const int warp = t >> 5;
  const int lane = t & 31;
  constexpr int kPer = kSpC / 64;  // float2 per lane
#pragma unroll 2
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float2 v[kPer];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = *reinterpret_cast<const float2*>(sR + r * kSpLdR + 2 * lane + 64 * i);
      sum += v[i].x + v[i].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / float(kSpC);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float a = v[i].x - mean, b = v[i].y - mean;
      sq += a * a + b * b;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / float(kSpC) + 1e-5f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = 2 * lane + 64 * i;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + c));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + c));
      st_op(A, r, c, (v[i].x - mean) * rstd * sc.x + bi.x, (v[i].y - mean) * rstd * sc.y + bi.y);
    }
  }
}

// ---- the K/V ring of an attention. Heads 2i and 2i + 1 go to warpgroups 0
// and 1; the last (odd) head is split by keys: warpgroup 0 takes tiles
// [0, T0), warpgroup 1 [T0, T), and their (m, l, O) are merged. The loads
// interleave the two warpgroups' tiles; each stage is read by one warpgroup.
struct KvSess {
  const CUtensorMap* mk;
  const CUtensorMap* mv;
  int row, T, T0, n_loads;
};

__device__ __forceinline__ KvSess kv_sess(const CUtensorMap* mk, const CUtensorMap* mv, int row,
                                          int kv_len) {
  const int T = (kv_len + kSpKeys - 1) / kSpKeys;
  return KvSess{mk, mv, row, T, (T + 1) / 2, kSpHeads * T};
}

// the position in the load order of tile jj of warpgroup wg in round `round`
__device__ __forceinline__ int kv_slot(const KvSess& s, int round, int wg, int jj) {
  if (round < kSpHeads / 2) return round * 2 * s.T + 2 * jj + wg;
  const int m = s.T - s.T0;  // warpgroup 1's share of the split head
  return (kSpHeads / 2) * 2 * s.T + (jj < m ? 2 * jj + wg : 2 * m + (jj - m));
}

__device__ __forceinline__ void kv_issue(const KvSess& s, int n, unsigned char* dst,
                                         uint64_t* bar) {
  const int full = (kSpHeads / 2) * 2 * s.T;
  int head, tile;
  if (n < full) {
    const int r = n / (2 * s.T);
    const int i = n - r * 2 * s.T;
    head = 2 * r + (i & 1);
    tile = i >> 1;
  } else {
    const int i = n - full;
    const int m = s.T - s.T0;
    const int wg = i < 2 * m ? (i & 1) : 0;
    const int jj = i < 2 * m ? (i >> 1) : m + (i - 2 * m);
    head = kSpHeads - 1;
    tile = wg ? s.T0 + jj : jj;
  }
#ifdef VMV_SP_NOKV
  mbar_arrive(bar);
  return;
#endif
  mbar_arrive_expect_tx(bar, kSpKvStageBytes);
  tma_load_4d(dst, s.mk, bar, 0, head, tile * kSpKeys, s.row);
  tma_load_4d(dst + kSpKvTileBytes, s.mv, bar, 0, head, tile * kSpKeys, s.row);
}

__device__ __forceinline__ void kv_start(const Ring& r, const KvSess& s) {
  for (int n = 0; n < kSpKvStages && n < s.n_loads; ++n) {
    const int st = (r.g0 + n) % kSpKvStages;
    kv_issue(s, n, r.base + st * kSpKvStageBytes, &r.bars->kvfull[st]);
  }
}

__device__ __forceinline__ int kv_wait(const Ring& r, int n) {
  const uint32_t gi = r.g0 + n;
  const int st = gi % kSpKvStages;
  mbar_wait(&r.bars->kvfull[st], (gi / kSpKvStages) & 1);
  return st;
}

__device__ __forceinline__ void kv_release(const Ring& r, const KvSess& s, int n) {
  if ((threadIdx.x & 31) == 0) {
    const int st = (r.g0 + n) % kSpKvStages;
    __threadfence_block();
    const unsigned int before = atomicAdd(&r.bars->kvdone[st], 1u);
    if ((before & 3u) == 3u) {  // the 4 warps of the one warpgroup that reads it
      __threadfence_block();
      if (n + kSpKvStages < s.n_loads) {
        kv_issue(s, n + kSpKvStages, r.base + st * kSpKvStageBytes, &r.bars->kvfull[st]);
      }
    }
  }
  __syncwarp();
}

__device__ __forceinline__ float sp_exp2(float x) {
#ifdef VMV_SP_NOEXP
  return x;
#endif
  return exp2f(x);
}

// One warpgroup: the 64 queries of Q_h (a swizzled tile) over `count` K/V
// tiles from tile0 on; online softmax in base 2 with the logits scaled after
// the dot (fp32), keys past kv_len masked with -inf before the max (TMA fills
// them with zeros). The step is flash_attention.cu's: QK^T by m64n128k16 from
// shared memory, P rounded to bf16 in registers as the A operand of PV, V the
// MN-major B operand.
__device__ __forceinline__ void sp_attend(float (&o)[32], float (&m_run)[2], float (&l_run)[2],
                                          const unsigned char* qtile, const Ring& ring,
                                          const KvSess& s, int round, int wg, int tile0,
                                          int count, int kv_len, float scale_log2) {
  const int q2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  m_run[0] = m_run[1] = -INFINITY;
  l_run[0] = l_run[1] = 0.f;
  const uint64_t dq = wgmma_desc_sw128(qtile);
  uint32_t pa[kSpKeys / 16][4];
  int prev = -1;
#pragma unroll 1
  for (int jj = 0; jj < count; ++jj) {
    const int n = kv_slot(s, round, wg, jj);
    const int st = kv_wait(ring, n);
    const unsigned char* tile = ring.base + st * kSpKvStageBytes;
    const uint64_t dk = wgmma_desc_sw128(tile);
    float sc[kSpKeys / 2];  // this tile's logits (overwritten by the first wgmma)
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kD / 16; ++k) {
#ifdef VMV_SP_NOATTN
      if (k) continue;
#endif
      wgmma_ss_n128(sc, dq + k * kDescStepK16, dk + k * kDescStepK16, k != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // this tile's logits, and the tile before's PV
    if (prev >= 0) kv_release(ring, s, prev);
    prev = n;

    const int valid = kv_len - (tile0 + jj) * kSpKeys;
    if (valid < kSpKeys) {
#pragma unroll
      for (int i = 0; i < kSpKeys / 8; ++i) {
        if (8 * i + q2 >= valid) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
        if (8 * i + q2 + 1 >= valid) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kSpKeys / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i + 0], sc[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    float corr[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m_run[r] - mx[r]) * scale_log2);  // 0 on the first tile
      m_run[r] = mx[r];
      msc[r] = mx[r] * scale_log2;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kSpKeys / 8; ++i) {
      const float p0 = sp_exp2(fmaf(sc[4 * i + 0], scale_log2, -msc[0]));
      const float p1 = sp_exp2(fmaf(sc[4 * i + 1], scale_log2, -msc[0]));
      const float p2 = sp_exp2(fmaf(sc[4 * i + 2], scale_log2, -msc[1]));
      const float p3 = sp_exp2(fmaf(sc[4 * i + 3], scale_log2, -msc[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[i >> 1][(i & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      o[4 * i + 0] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    const uint64_t dv = wgmma_desc_sw128(tile + kSpKvTileBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSpKeys / 16; ++ks) {
#ifdef VMV_SP_NOATTN
      if (ks) continue;
#endif
      wgmma_rs_n64_tb(o, pa[ks], dv + ks * kDescStepK16Mn, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  if (prev >= 0) kv_release(ring, s, prev);
}

// O_h / l, bf16, over Q_h in the operand (only this warpgroup reads Q_h)
__device__ __forceinline__ void sp_store_head(unsigned char* A, int head, const float (&o)[32],
                                              const float (&l)[2]) {
  const int tid = fresh_tid() & 127;
  const int row = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int q2 = (tid & 3) * 2;
  unsigned char* t = A + head * kSpTileBytes;
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    const int col = i * 8 + q2;
    *reinterpret_cast<uint32_t*>(t + sw128_offset(row, col)) =
        pack_bf16x2(o[4 * i + 0] / l[0], o[4 * i + 1] / l[0]);
    *reinterpret_cast<uint32_t*>(t + sw128_offset(row + 8, col)) =
        pack_bf16x2(o[4 * i + 2] / l[1], o[4 * i + 3] / l[1]);
  }
}

// One attention of the block: Q of every head in the operand on entry, the
// head outputs there on exit. Thread 0 has started the session. Ends on a
// barrier after a proxy fence.
__device__ __forceinline__ void sp_attention(unsigned char* A, const Ring& ring, const KvSess& s,
                                             int kv_len, float scale_log2, int wg, int tid) {
  float o[32], m[2], l[2];
#pragma unroll 1
  for (int round = 0; round < kSpHeads / 2; ++round) {
    const int head = 2 * round + wg;
    sp_attend(o, m, l, A + head * kSpTileBytes, ring, s, round, wg, 0, s.T, kv_len, scale_log2);
    sp_store_head(A, head, o, l);
  }
  constexpr int kLast = kSpHeads - 1;
  sp_attend(o, m, l, A + kLast * kSpTileBytes, ring, s, kSpHeads / 2, wg, wg ? s.T0 : 0,
            wg ? s.T - s.T0 : s.T0, kv_len, scale_log2);
  __syncthreads();  // every K/V stage is consumed: the ring's memory takes the merge
  float* mb = reinterpret_cast<float*>(ring.base);  // [36][128], one column per thread
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) mb[i * 128 + tid] = o[i];
    mb[32 * 128 + tid] = m[0];
    mb[33 * 128 + tid] = m[1];
    mb[34 * 128 + tid] = l[0];
    mb[35 * 128 + tid] = l[1];
  }
  __syncthreads();
  if (wg == 0) {
    float a0[2], a1[2], lm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = mb[(32 + r) * 128 + tid];
      const float mm = fmaxf(m[r], m1);
      a0[r] = exp2f((m[r] - mm) * scale_log2);
      a1[r] = exp2f((m1 - mm) * scale_log2);  // 0 where warpgroup 1 had no tile
      lm[r] = l[r] * a0[r] + mb[(34 + r) * 128 + tid] * a1[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      o[i] = o[i] * a0[r] + mb[i * 128 + tid] * a1[r];
    }
    sp_store_head(A, kLast, o, lm);
  }
  fence_proxy_async();
  __syncthreads();
}

// The GEGLU feed-forward of the operand (LN3): acc = g · W2^T over the inner
// chunks of 64, the chunk loop of fused_ffn.cu's geglu_ffn_wgmma_kernel<320>
__device__ __forceinline__ void sp_ffn(float (&acc)[2][40], const unsigned char* A,
                                       unsigned char* G, const Ring& ring, const WSess& s,
                                       const float* __restrict__ b1, int wg, int tid) {
  const int row = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int q2 = (tid & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[h][i] = 0.f;
  }
  const int n_chunks = s.inner / 64;
  int n = 0;
#pragma unroll 1
  for (int j = 0; j < n_chunks; ++j) {
    unsigned char* gbuf = G + (j & 1) * kSpTileBytes;
    float lg[kSpLG];  // lin in [0, 16), gate in [16, 32): the same rows and columns
#pragma unroll 1
    for (int kb = 0; kb < kSpKB; ++kb, ++n) {
      const int st = w_wait(ring, n);
      const uint64_t da = wgmma_desc_sw128(A + kb * kSpTileBytes);
      const uint64_t db = wgmma_desc_sw128(ring.base + st * kSpStageBytes +
                                           wg * 2 * kSpLG * kSwizzleRowBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#ifdef VMV_SP_NOGEMM
        if (k) continue;
#endif
        wgmma_ss_n64(lg, da + k * kDescStepK16, db + k * kDescStepK16, (kb | k) != 0);
      }
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();
        w_release(ring, s, n - 1);
      }
    }
    wgmma_wait<0>();
    w_release(ring, s, n - 1);

    // g = (lin + b1a) · gelu(gate + b1b), bf16, into the shared g tile
#pragma unroll
    for (int jj = 0; jj < kSpLG / 8; ++jj) {
      const int col = wg * kSpLG + jj * 8 + q2;
      const int ic = j * 64 + col;
      const float bl0 = __ldg(b1 + ic), bl1 = __ldg(b1 + ic + 1);
      const float bg0 = __ldg(b1 + s.inner + ic), bg1 = __ldg(b1 + s.inner + ic + 1);
      constexpr int kGate = kSpLG / 2;
      const float g0 = (lg[4 * jj + 0] + bl0) * gelu_erf(lg[kGate + 4 * jj + 0] + bg0);
      const float g1 = (lg[4 * jj + 1] + bl1) * gelu_erf(lg[kGate + 4 * jj + 1] + bg1);
      const float g2 = (lg[4 * jj + 2] + bl0) * gelu_erf(lg[kGate + 4 * jj + 2] + bg0);
      const float g3 = (lg[4 * jj + 3] + bl1) * gelu_erf(lg[kGate + 4 * jj + 3] + bg1);
      *reinterpret_cast<uint32_t*>(gbuf + sw128_offset(row, col)) = pack_bf16x2(g0, g1);
      *reinterpret_cast<uint32_t*>(gbuf + sw128_offset(row + 8, col)) = pack_bf16x2(g2, g3);
    }
    fence_proxy_async();
    named_barrier_sync(1, kSpThreads);  // every column of g is written

    const uint64_t dg = wgmma_desc_sw128(gbuf);
#pragma unroll
    for (int sl = 0; sl < 2; ++sl, ++n) {
      const int st = w_wait(ring, n);
      const uint64_t db = wgmma_desc_sw128(ring.base + st * kSpStageBytes +
                                           wg * kSpN * kSwizzleRowBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#ifdef VMV_SP_NOGEMM
        if (k) continue;
#endif
        wgmma_ss_n80(acc[sl], dg + k * kDescStepK16, db + k * kDescStepK16, 1);
      }
      wgmma_commit();
      if (sl > 0) {
        wgmma_wait<1>();
        w_release(ring, s, n - 1);
      }
    }
    // every read of this g tile is done before the next chunk's barrier, so
    // the chunk after that may overwrite it
    wgmma_wait<0>();
    w_release(ring, s, n - 1);
  }
}

// The front of a token tile: GroupNorm -> bf16 -> proj_in (+bias) = r0 (fp32
// residual) -> LN1 -> bf16 operand; the first stages of `next` load during
// the LayerNorm. Ends on a barrier.
__device__ __forceinline__ void sp_front(const SpatialParams& p, const SpatialMaps& maps,
                                         float* sR, unsigned char* A, Ring& wr,
                                         const WSess& next, int wg) {
  const WSess s_in = linear_sess(&maps.w[kWin], kSpKB);
  float acc[2][40];
  if (threadIdx.x == 0) w_start(wr, s_in);
  sp_front_gn(p, blockIdx.y, blockIdx.x * kBM, A);
  fence_proxy_async();
  __syncthreads();
  sp_linear<kSpKB>(acc, A, wr, s_in, wg);
  wr.g0 += s_in.n_loads;
  const float* bin = p.bin;
  acc_foreach(acc, [&](int r, int col, float v0, float v1) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bin + col));
    *reinterpret_cast<float2*>(sR + r * kSpLdR + col) = make_float2(v0 + b.x, v1 + b.y);
  });
  __syncthreads();  // r0 is whole and the operand has been read
  if (threadIdx.x == 0) w_start(wr, next);
  sp_layernorm(sR, A, p.ln1_s, p.ln1_b);
  fence_proxy_async();
  __syncthreads();
}

// ---- phase A: K2 / V2 = ctx · Wk2^T / Wv2^T over [R·L, Cc]; blockIdx.y picks
__global__ void __launch_bounds__(kSpThreads, 1)
spatial_ctx_kv_wgmma_kernel(const __grid_constant__ SpatialMaps maps, bf16* __restrict__ k2,
                            bf16* __restrict__ v2, int M) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* A = align_1024(smem_raw);  // the context's 64 rows as kSpCtxKB tiles
  constexpr int kb = kSpCtxKB;
  unsigned char* ring = A + kb * kSpTileBytes;
  const Ring wr{ring, reinterpret_cast<SpBars*>(ring + kSpRingBytes), 0};
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * kBM;
  const WSess s = linear_sess(&maps.w[blockIdx.y ? kWv2 : kWk2], kb);
  bf16* dst = blockIdx.y ? v2 : k2;
  if (threadIdx.x == 0) {
    sp_init_bars(wr.bars);
    mbar_arrive_expect_tx(&wr.bars->abar, kb * kSpTileBytes);
    for (int i = 0; i < kb; ++i) {  // rows past M arrive as zeros
      tma_load_2d(A + i * kSpTileBytes, &maps.ctx, &wr.bars->abar, i * 64, m0);
    }
    w_start(wr, s);
  }
  __syncthreads();
  mbar_wait(&wr.bars->abar, 0);
  float acc[2][40];
  sp_linear<kSpCtxKB>(acc, A, wr, s, wg);
  acc_foreach(acc, [&](int r, int col, float v0, float v1) {
    if (m0 + r < M) {
      *reinterpret_cast<uint32_t*>(dst + int64_t(m0 + r) * kSpC + col) = pack_bf16x2(v0, v1);
    }
  });
}

// ---- phase B: K1 / V1 of one (row, 64-token tile)
__global__ void __launch_bounds__(kSpThreads, 1)
spatial_front_kv_wgmma_kernel(const __grid_constant__ SpatialMaps maps, const SpatialParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  float* sR = reinterpret_cast<float*>(base);
  unsigned char* A = base + kSpResBytes;
  unsigned char* ring = A + kSpOpBytes;
  Ring wr{ring, reinterpret_cast<SpBars*>(ring + kSpRingBytes), 0};
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sp_init_bars(wr.bars);
  __syncthreads();
  const WSess s_k = linear_sess(&maps.w[kWk1], kSpKB);
  sp_front(p, maps, sR, A, wr, s_k, wg);
  float acc[2][40];
  const int64_t off = (int64_t(blockIdx.y) * p.S + blockIdx.x * kBM) * kSpC;
  sp_linear<kSpKB>(acc, A, wr, s_k, wg);
  wr.g0 += s_k.n_loads;
  acc_foreach(acc, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(p.k1 + off + int64_t(r) * kSpC + col) = pack_bf16x2(v0, v1);
  });
  __syncthreads();  // both warpgroups are done with the ring
  const WSess s_v = linear_sess(&maps.w[kWv1], kSpKB);
  if (threadIdx.x == 0) w_start(wr, s_v);
  sp_linear<kSpKB>(acc, A, wr, s_v, wg);
  acc_foreach(acc, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(p.v1 + off + int64_t(r) * kSpC + col) = pack_bf16x2(v0, v1);
  });
}

// ---- phase C: the rest of the block for one (row, 64-query tile)
__global__ void __launch_bounds__(kSpThreads, 1)
spatial_block_wgmma_kernel(const __grid_constant__ SpatialMaps maps, const SpatialParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  float* sR = reinterpret_cast<float*>(base);  // [64][kSpLdR] fp32 residual stream
  unsigned char* A = base + kSpResBytes;       // the bf16 operand: LN outputs, Q, O, r3
  unsigned char* ring = A + kSpOpBytes;        // weight stages; K/V stages in attention
  unsigned char* G = ring + kSpRingBytes;      // g tiles; K/V stages in attention
  Ring wr{ring, reinterpret_cast<SpBars*>(G + kSpGBytes), 0};
  Ring kr = wr;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row = blockIdx.y, t0 = blockIdx.x * kBM;
  if (threadIdx.x == 0) sp_init_bars(wr.bars);
  __syncthreads();

  // Q of the LN output into the operand (thread 0 has started `s`)
  auto project_q = [&](const WSess& s) {
    float acc[2][40];
    sp_linear<kSpKB>(acc, A, wr, s, wg);
    wr.g0 += s.n_loads;
    __syncthreads();  // both warpgroups have read the LN output
    acc_foreach(acc, [&](int r, int col, float v0, float v1) { st_op(A, r, col, v0, v1); });
    fence_proxy_async();
    __syncthreads();
  };
  auto attend = [&](const CUtensorMap* mk, const CUtensorMap* mv, int kv_len) {
    const KvSess ks = kv_sess(mk, mv, row, kv_len);
    if (threadIdx.x == 0) kv_start(kr, ks);
    sp_attention(A, kr, ks, kv_len, p.scale_log2, wg, tid);
    kr.g0 += ks.n_loads;
  };
  // residual += O · Wo^T + bo
  auto out_proj = [&](int w, const float* bo) {
    const WSess s = linear_sess(&maps.w[w], kSpKB);
    if (threadIdx.x == 0) w_start(wr, s);
    float acc[2][40];
    sp_linear<kSpKB>(acc, A, wr, s, wg);
    wr.g0 += s.n_loads;
    acc_foreach(acc, [&](int r, int col, float v0, float v1) {
      float2* d = reinterpret_cast<float2*>(sR + r * kSpLdR + col);
      const float2 old = *d;
      const float2 b = __ldg(reinterpret_cast<const float2*>(bo + col));
      *d = make_float2(old.x + (v0 + b.x), old.y + (v1 + b.y));
    });
    __syncthreads();
  };
  // LN of the residual into the operand while the next product's first
  // weight stages load
  auto layernorm = [&](const WSess& next, const float* scale, const float* bias) {
    if (threadIdx.x == 0) w_start(wr, next);
    sp_layernorm(sR, A, scale, bias);
    fence_proxy_async();
    __syncthreads();
  };

  // ---- self-attention: r1 = r0 + attn1(LN1(r0))
  const WSess s_q1 = linear_sess(&maps.w[kWq1], kSpKB);
  sp_front(p, maps, sR, A, wr, s_q1, wg);
  project_q(s_q1);
  attend(&maps.k1, &maps.v1, p.S);
  out_proj(kWo1, p.bo1);

  // ---- cross-attention: r2 = r1 + attn2(LN2(r1), ctx)
  const WSess s_q2 = linear_sess(&maps.w[kWq2], kSpKB);
  layernorm(s_q2, p.ln2_s, p.ln2_b);
  project_q(s_q2);
  attend(&maps.k2, &maps.v2, p.L);
  out_proj(kWo2, p.bo2);

  // ---- GEGLU feed-forward: r3 = r2 + ff(LN3(r2)), rounded to bf16 for proj_out
  const WSess s_ff = ffn_sess(&maps.w[kW1], &maps.w[kW2], p.Iff);
  layernorm(s_ff, p.ln3_s, p.ln3_b);
  float acc[2][40];
  sp_ffn(acc, A, G, wr, s_ff, p.b1, wg, tid);
  wr.g0 += s_ff.n_loads;
  __syncthreads();  // both warpgroups have read LN3 and the g tiles
  const WSess s_po = linear_sess(&maps.w[kWpo], kSpKB);
  if (threadIdx.x == 0) w_start(wr, s_po);
  const float* b2 = p.b2;
  acc_foreach(acc, [&](int r, int col, float v0, float v1) {
    const float2 r2 = *reinterpret_cast<const float2*>(sR + r * kSpLdR + col);
    const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + col));
    st_op(A, r, col, r2.x + (v0 + b.x), r2.y + (v1 + b.y));
  });
  fence_proxy_async();
  __syncthreads();

  // ---- proj_out(r3) + bias + x -> bf16
  float acc_po[2][40];
  sp_linear<kSpKB>(acc_po, A, wr, s_po, wg);
  const bf16* xr = p.x + (int64_t(row) * p.S + t0) * kSpC;
  bf16* od = p.out + (int64_t(row) * p.S + t0) * kSpC;
  const float* bpo = p.bpo;
  // all of the thread's x pairs are loaded before the first store
  uint32_t xs[2 * 2 * (kSpN / 8)];
  acc_foreach_i(acc_po, [&](int i, int r, int col, float, float) {
    xs[i] = ldg_u32(xr + int64_t(r) * kSpC + col);
  });
  acc_foreach_i(acc_po, [&](int i, int r, int col, float v0, float v1) {
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bpo + col));
    *reinterpret_cast<uint32_t*>(od + int64_t(r) * kSpC + col) =
        pack_bf16x2(xv.x + (v0 + b.x), xv.y + (v1 + b.y));
  });
}

// ---- host: tensor maps and the launch. The weights' maps are encoded once
// for each set of weight pointers and widths and kept; the context's and the
// K/V scratch's maps are encoded per call.
struct WeightMapEntry {
  const void* key[kSpWeights];
  int cc, iff;
  CUtensorMap maps[kSpWeights];
};

cudaError_t sp_weight_maps(const SpatialParams& p, CUtensorMap* out) {
  constexpr int kCache = 32;
  static WeightMapEntry cache[kCache];
  static int n_cached = 0, next = 0;
  static std::mutex lock;
  const void* key[kSpWeights] = {p.win, p.wq1, p.wk1, p.wv1, p.wo1, p.wq2,
                                 p.wk2, p.wv2, p.wo2, p.w1,  p.w2,  p.wpo};
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_cached; ++i) {
    const WeightMapEntry& e = cache[i];
    if (e.cc == p.Cc && e.iff == p.Iff && memcmp(e.key, key, sizeof(key)) == 0) {
      memcpy(out, e.maps, sizeof(e.maps));
      return cudaSuccess;
    }
  }
  WeightMapEntry& e = cache[next];
  const uint32_t box80[2] = {64, uint32_t(kSpN)}, box_lg[2] = {64, uint32_t(kSpLG)};
  for (int i = 0; i < kSpWeights; ++i) {
    uint64_t dims[2] = {uint64_t(kSpC), uint64_t(kSpC)};  // [out, in], innermost first
    if (i == kWk2 || i == kWv2) dims[0] = uint64_t(p.Cc);
    if (i == kW1) dims[1] = uint64_t(2) * p.Iff;
    if (i == kW2) dims[0] = uint64_t(p.Iff);
    const uint64_t strides[1] = {dims[0] * 2};
    const cudaError_t err = make_tensor_map_bf16(&e.maps[i], key[i], 2, dims, strides,
                                                 i == kW1 ? box_lg : box80);
    if (err != cudaSuccess) {
      e.cc = -1;  // never matches
      return err;
    }
  }
  memcpy(e.key, key, sizeof(key));
  e.cc = p.Cc;
  e.iff = p.Iff;
  next = (next + 1) % kCache;
  if (n_cached < kCache) ++n_cached;
  memcpy(out, e.maps, sizeof(e.maps));
  return cudaSuccess;
}

// the kernels' shared-memory limits, once per device
cudaError_t sp_set_attributes() {
  static std::mutex lock;
  static uint64_t done = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (dev < 64 && (done >> dev & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(spatial_ctx_kv_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSpCtxSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(spatial_front_kv_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSpFrontSmem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(spatial_block_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSpBlockSmem);
  }
  if (err == cudaSuccess && dev < 64) done |= uint64_t(1) << dev;
  return err;
}

cudaError_t launch_spatial_wgmma(const SpatialParams& p, cudaStream_t st) {
  SpatialMaps maps;
  cudaError_t err = sp_weight_maps(p, maps.w);
  if (err != cudaSuccess) return err;
  const int M = p.R * p.L;
  {
    const uint64_t dims[2] = {uint64_t(p.Cc), uint64_t(M)}, strides[1] = {uint64_t(p.Cc) * 2};
    const uint32_t box[2] = {64, uint32_t(kBM)};
    err = make_tensor_map_bf16(&maps.ctx, p.ctx, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  // K/V [R, tokens, heads, 64] read in place, innermost first: 64, heads, tokens, R
  const uint32_t kv_box[4] = {64, 1, uint32_t(kSpKeys), 1};
  CUtensorMap* kv_maps[4] = {&maps.k1, &maps.v1, &maps.k2, &maps.v2};
  const void* kv_base[4] = {p.k1, p.v1, p.k2, p.v2};
  for (int i = 0; i < 4; ++i) {
    const uint64_t tokens = uint64_t(i < 2 ? p.S : p.L);
    const uint64_t dims[4] = {64, uint64_t(kSpHeads), tokens, uint64_t(p.R)};
    const uint64_t strides[3] = {128, uint64_t(kSpC) * 2, tokens * kSpC * 2};
    err = make_tensor_map_bf16(kv_maps[i], kv_base[i], 4, dims, strides, kv_box);
    if (err != cudaSuccess) return err;
  }
  err = sp_set_attributes();
  if (err != cudaSuccess) return err;
  gn_stats_kernel<<<dim3(kGroups, p.R), kThreads, 0, st>>>(p.x, p.stats, p.S, kSpC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_ctx_kv_wgmma_kernel<<<dim3((M + kBM - 1) / kBM, 2), kSpThreads, kSpCtxSmem, st>>>(
      maps, p.k2, p.v2, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(p.S / kBM, p.R);
  spatial_front_kv_wgmma_kernel<<<grid, kSpThreads, kSpFrontSmem, st>>>(maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_block_wgmma_kernel<<<grid, kSpThreads, kSpBlockSmem, st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vmv

// ptrs: a host array of 34 device pointers in the order of SpatialParams
// (x, ctx, out, stats, k1, v1, k2, v2, then the weights as the Python wrapper
// lists them). x, out, k1, v1 [R, S, C]; ctx [R, L, Cc]; k2, v2 [R·L, C];
// stats fp32 [R, 32, 2]. C = 320 with 5 heads, Cc = 1024, S % 64 == 0,
// Iff % 64 == 0; any other shape is cudaErrorInvalidValue. Returns a
// cudaError_t value.
extern "C" int vmv_fused_spatial_fwd(const void* const* ptrs, int R, int S, int C, int L, int Cc,
                                     int heads, int Iff, void* stream) {
  using namespace vmv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || S <= 0 || S % kBM != 0 || heads != kSpHeads || L <= 0 || Iff <= 0 ||
      Iff % kFfnChunk != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (C != kSpC || Cc != kSpCc) return int(cudaErrorInvalidValue);
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
  return int(launch_spatial_wgmma(p, st));
}
