// Flash attention forward for the UNet's spatial self-attention (bf16).
//
// Replaces: videomv_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _flash_fwd). That TPU kernel keeps the whole K/V of one (batch, head) in
// VMEM and does one exact softmax over 512-query blocks. An SM has 227 KB
// of shared memory, so this kernel streams K/V instead (online softmax).
//
// What bounds it on the H100: at the main path's shapes ([48,1024,5,64] and
// [48,256,10,64]) the QK^T and PV products are 4·S·D flops per query row
// against 4·D bytes of K/V per key: compute-bound at S = 1024 (0.065 ms),
// bound by the bytes of q/k/v/o at S = 256. At head_dim 64 the softmax weighs
// as much as the products: 128 x 128 exp2 per tile and warpgroup pair take the
// special-function units as many cycles as the two products take the tensor
// cores, so whatever of it is not hidden under another warpgroup's wgmma is
// lost.
//
// head_dim 64 (variant 1) runs the kernel designed for this card,
// flash_attn_wgmma_kernel:
//   * a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, and a third warpgroup whose first thread is
//     the producer. K/V of a head are read S / 128 times instead of S / 64.
//   * q/k/v are read in place from [B, S, H, D] through 4-D tensor maps
//     (token stride H·D): TMA delivers [128 tokens x 64] tiles in the
//     128-byte-swizzled layout, K and V through a ring of 3 stages with
//     full / empty mbarriers.
//   * S = Q K^T: wgmma m64n128k16 with Q and the K tile from shared memory (the
//     K tile [keys, D] is the K-major B operand as it lies); fp32 logits,
//     running max and sum with the exponent in base 2.
//   * P is rounded to bf16 in the registers the logits came in: an
//     accumulator's two neighbouring 8-column groups are an A fragment, so PV
//     is wgmma with A from registers and the V tile [keys, D] as the MN-major
//     B operand (transpose bit): no pass over V, no P in shared memory.
//   * PV of a tile stays in flight while the next tile's logits are issued;
//     the two warpgroups take turns at issuing their products (two named
//     barriers), so one's softmax runs under the other's wgmmas. O is divided
//     by the row sum once at the end and leaves through the block's Q tile as
//     whole 128-byte rows.
//   * S % 128 != 0 (SV3D's 5,184, 1,296 and 324 tokens) takes the kernel's
//     kTail instance: TMA zero-fills the boxes past S, the last K/V tile's
//     logits of keys >= S are set to -inf before the online softmax, and rows
//     >= S are neither stored nor given an lse. Only the last tile pays for
//     the mask; S % 128 == 0 runs the instance without it.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py: 0.20 ms at
// [48,1024,5,64] (31 % of the bound; the first port's kernel 0.29 ms, one
// scaled_dot_product_attention call 0.156 ms); the table in PERF.md has every
// shape. With the exp2, all but one wgmma of QK^T and all but one of PV
// compiled out the kernel still takes 0.125 ms: the waits, barriers and the
// rest of the softmax per tile weigh more than the products.
//
// Head_dim 128 and grids of fewer than 64 blocks, which are launch-bound,
// when S % 64 == 0 (variant 0) keep the first port's kernel,
// flash_attn_fwd_kernel:
//   * one CTA (4 warps, 128 threads) per (batch·head, 64 query rows);
//   * K/V tiles of 64 keys staged in shared memory with cp.async, double
//     buffered so the next tile loads while this one is multiplied;
//   * each warp owns 16 query rows: S = Q K^T via mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate), P rounded to bf16 before the PV product, O kept in
//     fp32 registers (the tile step is attn_tile_step of attention_tile.cuh,
//     shared with the fused spatial-transformer kernel);
//   * shared-memory rows are padded by 16 bytes so ldmatrix is conflict-free.
// The variant is chosen by the caller from the shape and checked here; neither
// kernel is a fallback of the other.
// Under grad both kernels also write each query row's log-sum-exp (fp32,
// [B, H, S]) from their running max and sum, which the backward kernels
// (flash_attention_bwd.cu) recompute the probabilities from; with a null
// pointer (inference) nothing is written.
// Requirements (checked by the Python wrapper): bf16, contiguous [B,S,H,D],
// 16-byte aligned, q/k/v of one shape (self-attention), D in {64, 128}; S %
// 64 == 0 except for the wgmma kernel at D = 64.

#include "attention_tile.cuh"
#include "hopper_utils.cuh"
#include "mma_utils.cuh"
#include "wgmma_ops.cuh"

namespace vmv {
namespace {

// The log-sum-exp of a row's scaled logits, natural log, from the online
// softmax's running max m (of the unscaled logits) and sum l of
// exp2((s - m) * scale_log2): ln(sum exp(s * scale)) = (m * scale_log2 + log2 l) ln 2.
__device__ __forceinline__ float row_lse(float m, float l, float scale_log2) {
  return (m * scale_log2 + log2f(l)) * 0.6931471805599453f;
}

// ------------------------------------------------ the wgmma kernel (sm_90a)
constexpr int kWgQRows = 128;   // query rows per block: 64 per consumer warpgroup
constexpr int kWgKeys = 128;    // keys per K/V tile
constexpr int kWgStages = 3;    // K/V tiles in flight
constexpr int kWgConsumers = 2;
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgTileBytes = 128 * kSwizzleRowBytes;  // [128 rows x 64] bf16
constexpr int kWgSmemBytes = 1024 + kWgTileBytes * (1 + 2 * kWgStages) + 1024;

// head_dim 64: one swizzle row per token. kTail: S % 128 != 0 (the last
// tile's keys and rows past S are masked)
template <bool kTail>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                        float* __restrict__ lse, int S, int H, float scale_log2) {
  constexpr int D = 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);   // [128 x 64]; later the output tile
  unsigned char* ring = sQ + kWgTileBytes;    // kWgStages x (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kWgStages * kWgTileBytes);
  uint64_t* empty = full + kWgStages;
  uint64_t* q_bar = empty + kWgStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kWgQRows;
  const int n_tiles = (S + kWgKeys - 1) / kWgKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgConsumers);  // lane 0 of every consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    // ------------------------------------------------------------ producer
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_bar, kWgTileBytes);
      tma_load_4d(sQ, &map_q, q_bar, 0, h, q0, b);
      RingPos pos;
      for (int jt = 0; jt < n_tiles; ++jt) {
        mbar_wait(&empty[pos.stage], pos.parity ^ 1);
        unsigned char* dst = ring + pos.stage * 2 * kWgTileBytes;
        mbar_arrive_expect_tx(&full[pos.stage], 2 * kWgTileBytes);
        tma_load_4d(dst, &map_k, &full[pos.stage], 0, h, jt * kWgKeys, b);
        tma_load_4d(dst + kWgTileBytes, &map_v, &full[pos.stage], 0, h, jt * kWgKeys, b);
        pos.advance<kWgStages>();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    warpgroup_reg_alloc<240>();
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int q2 = (lane & 3) * 2;
    const int row = warp * 16 + g;  // and row + 8, within this warpgroup's 64

    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float sc[kWgKeys / 2];          // this thread's logits of the tile
    uint32_t pa[kWgKeys / 16][4];   // P as A fragments, bf16

    // The two warpgroups take turns at issuing their products (barrier
    // kTurn<wg> is this warpgroup's turn), so one's softmax runs while the
    // other's wgmmas hold the tensor cores instead of both doing the same
    // thing at the same time. Warpgroup 0 goes first.
    constexpr int kTurn0 = 4, kTurn1 = 5;  // constants, so ptxas reserves these barriers only
    if (wg == 1) named_barrier_arrive(kTurn0, 256);

    unsigned char* my_q = sQ + wg * (kWgTileBytes / 2);
    mbar_wait(q_bar, 0);
    const uint64_t dq = wgmma_desc_sw128(my_q);
    RingPos pos;
    int prev = 0;
    for (int jt = 0; jt < n_tiles; ++jt) {
      mbar_wait(&full[pos.stage], pos.parity);
      unsigned char* tile = ring + pos.stage * 2 * kWgTileBytes;
      // S = Q K^T (fp32): the K tile [keys, D] is the K-major B operand as it lies
      const uint64_t dk = wgmma_desc_sw128(tile);
      if (wg == 0) {
        named_barrier_sync(kTurn0, 256);
      } else {
        named_barrier_sync(kTurn1, 256);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        wgmma_ss_n128(sc, dq + k * kDescStepK16, dk + k * kDescStepK16, k != 0);
      }
      wgmma_commit();
      if (wg == 0) {
        named_barrier_arrive(kTurn1, 256);
      } else {
        named_barrier_arrive(kTurn0, 256);
      }
      wgmma_wait<0>();  // this tile's logits, and the tile before's PV
      if (jt > 0 && lane == 0) mbar_arrive(&empty[prev]);
      if (kTail && jt == n_tiles - 1) {
        // keys past S (zeros from TMA) take no share of the softmax; the
        // first tile always holds real keys (S >= 128), so no row is empty
        const int valid = S - jt * kWgKeys - q2;
#pragma unroll
        for (int i = 0; i < kWgKeys / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (i * 8 + (c & 1) >= valid) sc[4 * i + c] = -INFINITY;
          }
        }
      }

      // online softmax: the max of the unscaled logits, exponent in base 2
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kWgKeys / 8; ++i) {
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
      for (int i = 0; i < kWgKeys / 8; ++i) {
        const float p0 = exp2f(fmaf(sc[4 * i + 0], scale_log2, -msc[0]));
        const float p1 = exp2f(fmaf(sc[4 * i + 1], scale_log2, -msc[0]));
        const float p2 = exp2f(fmaf(sc[4 * i + 2], scale_log2, -msc[1]));
        const float p3 = exp2f(fmaf(sc[4 * i + 3], scale_log2, -msc[1]));
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
      for (int i = 0; i < D / 8; ++i) {
        o_acc[4 * i + 0] *= corr[0];
        o_acc[4 * i + 1] *= corr[0];
        o_acc[4 * i + 2] *= corr[1];
        o_acc[4 * i + 3] *= corr[1];
      }

      // O += P V: P from registers, the V tile [keys, D] as the MN-major B
      // operand (transpose bit), 16 keys down per k-step; it runs on while
      // the next tile's logits are issued
      const uint64_t dv = wgmma_desc_sw128(tile + kWgTileBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgKeys / 16; ++ks) {
        wgmma_rs_n64_tb(o_acc, pa[ks], dv + ks * kDescStepK16Mn, 1);
      }
      wgmma_commit();
      prev = pos.stage;
      pos.advance<kWgStages>();
    }
    wgmma_wait<0>();
    if (wg == 0) named_barrier_sync(kTurn0, 256);  // the turn left over

    // O / l, rounded to bf16, through this warpgroup's half of the Q tile (no
    // wgmma reads it any more) so that each token's 128 bytes leave as one piece
    if (wg == 0) {
      named_barrier_sync(2, 128);
    } else {
      named_barrier_sync(3, 128);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + q2;
      *reinterpret_cast<uint32_t*>(my_q + sw128_offset(row, col)) =
          pack_bf16x2(o_acc[4 * i + 0] / l_run[0], o_acc[4 * i + 1] / l_run[0]);
      *reinterpret_cast<uint32_t*>(my_q + sw128_offset(row + 8, col)) =
          pack_bf16x2(o_acc[4 * i + 2] / l_run[1], o_acc[4 * i + 3] / l_run[1]);
    }
    __syncwarp();
    const int64_t tok_stride = int64_t(H) * D;
    bf16* og = o + (int64_t(b) * S + q0 + wg * 64) * tok_stride + int64_t(h) * D;
    const int rows_left = S - q0 - wg * 64;  // of this warpgroup's 64 rows, those < S
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a warp stores its own 16 rows, 4 at a time
      const int r = warp * 16 + i * 4 + (lane >> 3);
      const int chunk = lane & 7;
      const uint4 val =
          *reinterpret_cast<const uint4*>(my_q + r * kSwizzleRowBytes + ((chunk ^ (r & 7)) << 4));
      if (!kTail || r < rows_left) {
        *reinterpret_cast<uint4*>(og + int64_t(r) * tok_stride + chunk * 8) = val;
      }
    }
    if (lse != nullptr && (lane & 3) == 0) {
      float* lse_row = lse + int64_t(bh) * S + q0 + wg * 64 + row;
      if (!kTail || row < rows_left) lse_row[0] = row_lse(m_run[0], l_run[0], scale_log2);
      if (!kTail || row + 8 < rows_left) lse_row[8] = row_lse(m_run[1], l_run[1], scale_log2);
    }
  }
}

cudaError_t launch_flash_attn_wgmma(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int S, int H, float scale,
                                    cudaStream_t stream) {
  constexpr int D = 64;
  // [B, S, H, D] read in place, innermost first: D, H, S, B; a box is one
  // head's 128 tokens x 64 channels
  const uint64_t dims[4] = {uint64_t(D), uint64_t(H), uint64_t(S), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(D) * 2, uint64_t(H) * D * 2, uint64_t(S) * H * D * 2};
  const uint32_t box[4] = {64, 1, 128, 1};
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_tensor_map_bf16(&maps[i], bases[i], 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const bool tail = S % kWgKeys != 0;
  auto kernel = tail ? flash_attn_wgmma_kernel<true> : flash_attn_wgmma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kWgQRows - 1) / kWgQRows, B * H);
  kernel<<<grid, kWgThreads, kWgSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, S, H, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ------------------------------------- the first port's kernel (mma.sync)
constexpr int kBlockM = 64;  // query rows per CTA (16 per warp)
constexpr int kBlockN = kAttnBlockN;  // keys per K/V tile
constexpr int kThreads = 128;

template <int D>
struct AttnSmem {
  static constexpr int kLd = D + 8;  // padded row, in elements
  // Q tile + double-buffered K and V tiles
  static constexpr size_t kBytes = size_t(kBlockM + 4 * kBlockN) * kLd * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int H, float scale_log2) {
  constexpr int LD = AttnSmem<D>::kLd;
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * LD;   // [2][kBlockN][LD]
  bf16* sV = sK + 2 * kBlockN * LD;  // [2][kBlockN][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM;
  const int64_t tok_stride = int64_t(H) * D;
  const int64_t base = int64_t(b) * S * tok_stride + int64_t(h) * D;
  const bf16* qg = q + base;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  bf16* og = o + base;

  auto load_tile = [&](bf16* dst, const bf16* src, int row0) {
    for (int c = tid; c < kBlockN * kChunksPerRow; c += kThreads) {
      const int r = c / kChunksPerRow;
      const int col = (c - r * kChunksPerRow) * 8;
      cp_async_16(dst + r * LD + col, src + int64_t(row0 + r) * tok_stride + col);
    }
  };

  load_tile(sQ, qg, q0);
  load_tile(sK, kg, 0);
  load_tile(sV, vg, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o_acc[i][0] = o_acc[i][1] = o_acc[i][2] = o_acc[i][3] = 0.f;
  }
  // rows g and g+8 of this warp's 16 (g = lane / 4)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = S / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (buf ^ 1) * kBlockN * LD, kg, (j + 1) * kBlockN);
      load_tile(sV + (buf ^ 1) * kBlockN * LD, vg, (j + 1) * kBlockN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* cK = sK + buf * kBlockN * LD;
    const bf16* cV = sV + buf * kBlockN * LD;

    attn_tile_step<D, LD>(qf, cK, cV, o_acc, m_run, l_run, scale_log2, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int row = q0 + warp * 16 + (lane >> 2);
  const int colq = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + colq;
    *reinterpret_cast<uint32_t*>(og + int64_t(row) * tok_stride + col) =
        pack_bf16x2(o_acc[i][0] / l_run[0], o_acc[i][1] / l_run[0]);
    *reinterpret_cast<uint32_t*>(og + int64_t(row + 8) * tok_stride + col) =
        pack_bf16x2(o_acc[i][2] / l_run[1], o_acc[i][3] / l_run[1]);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    lse[int64_t(bh) * S + row] = row_lse(m_run[0], l_run[0], scale_log2);
    lse[int64_t(bh) * S + row + 8] = row_lse(m_run[1], l_run[1], scale_log2);
  }
}

template <int D>
cudaError_t launch_flash_attn(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int S, int H, float scale, cudaStream_t stream) {
  const size_t smem = AttnSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockM, B * H);
  flash_attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, H, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vmv

// q, k, v, o: bf16 [B, S, H, D], contiguous; lse: fp32 [B, H, S] or null
// (the backward's input: each query row's log-sum-exp of its scaled logits,
// natural log; inference passes null and pays nothing). `variant` names the kernel
// (ops/flash_attention.py::attention_variant chooses it from the shape):
// 1 = wgmma (D == 64, S >= 128), 0 = mma.sync (D in {64, 128}, S % 64 == 0).
// Returns a cudaError_t value; a variant that does not take the shape is
// cudaErrorInvalidValue.
extern "C" int vmv_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int S, int H, int D, float scale,
                                  int variant, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0) return int(cudaErrorInvalidValue);
  if (variant == 1) {
    if (D != 64 || S < vmv::kWgKeys) return int(cudaErrorInvalidValue);
    return int(vmv::launch_flash_attn_wgmma(q, k, v, o, lse_f, B, S, H, scale, st));
  }
  if (variant != 0 || S % vmv::kBlockM != 0) return int(cudaErrorInvalidValue);
  if (D == 64) return int(vmv::launch_flash_attn<64>(q, k, v, o, lse_f, B, S, H, scale, st));
  if (D == 128) return int(vmv::launch_flash_attn<128>(q, k, v, o, lse_f, B, S, H, scale, st));
  return int(cudaErrorInvalidValue);
}
