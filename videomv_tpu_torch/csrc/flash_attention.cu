// Flash attention forward for the UNet's spatial self-attention (bf16).
//
// Replaces: videomv_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _flash_fwd). That TPU kernel keeps the whole K/V of one (batch, head) in
// VMEM and does one exact softmax over 512-query blocks. An SM has 227 KB
// of shared memory, so this kernel streams K/V instead (online softmax).
//
// What bounds it on the H100: at the main path's shapes ([48,1024,5,64] and
// [48,256,10,64]) the QK^T and PV products are 4·S·D flops per query row
// against 4·D bytes of K/V per key, so with K/V re-read once per 64-query
// block the kernel sits near the tensor-core side of the roofline; what
// limits this first version is mma.sync issue rate and the exp/max/sum work
// per score, not HBM. Its design:
//   * one CTA (4 warps, 128 threads) per (batch·head, 64 query rows), so the
//     stage-1 shape launches 240 x 16 = 3840 CTAs;
//   * K/V tiles of 64 keys staged in shared memory with cp.async, double
//     buffered so the next tile loads while this one is multiplied;
//   * each warp owns 16 query rows: S = Q K^T via mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate), running max and sum in fp32, P rounded to bf16 before
//     the PV product (as the TPU kernel rounds P before its PV dot), O kept
//     in fp32 registers and divided by the row sum once at the end (the tile
//     step is attn_tile_step of attention_tile.cuh, shared with the fused
//     spatial-transformer kernel);
//   * shared-memory rows are padded by 16 bytes so ldmatrix is conflict-free;
//   * q/k/v/o are read and written in their [B, S, H, D] layout through the
//     token stride H·D, so no transposes are needed around the call.
// Requirements (checked by the Python wrapper): bf16, contiguous [B,S,H,D],
// q/k/v of one shape (self-attention), S % 64 == 0, D in {64, 128}.

#include "attention_tile.cuh"
#include "mma_utils.cuh"

namespace vmv {
namespace {

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
                      const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H,
                      float scale_log2) {
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

    attn_tile_step<D, LD, false>(qf, cK, cV, o_acc, m_run, l_run, scale_log2, lane, kBlockN);
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
}

template <int D>
cudaError_t launch_flash_attn(const void* q, const void* k, const void* v, void* o, int B,
                              int S, int H, float scale, cudaStream_t stream) {
  const size_t smem = AttnSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockM, B * H);
  flash_attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vmv

// q, k, v, o: bf16 [B, S, H, D], contiguous. Returns a cudaError_t value.
extern "C" int vmv_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  int B, int S, int H, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % vmv::kBlockM != 0) return int(cudaErrorInvalidValue);
  if (D == 64) return int(vmv::launch_flash_attn<64>(q, k, v, o, B, S, H, scale, st));
  if (D == 128) return int(vmv::launch_flash_attn<128>(q, k, v, o, B, S, H, scale, st));
  return int(cudaErrorInvalidValue);
}
