// Fused GEGLU feed-forward for the UNet's transformer blocks (bf16):
//   out = (x·W1a + b1a) · gelu_erf(x·W1b + b1b) · W2 + b2
//
// Replaces: videomv_tpu/ops/fused_ffn.py::_ffn_kernel (launched by _ffn_fwd).
// On the TPU the inner axis is a sequential grid axis that carries a
// [1024, C] fp32 accumulator in VMEM across grid steps. Hopper runs blocks in
// parallel and in no order, so here that axis becomes a loop inside the block
// and the accumulator lives in the block's shared memory.
//
// What bounds it on the H100: by arithmetic the call is compute-bound (6·T·C·I
// flops against T·C·4 bytes of activations), and the plain composition in
// addition writes and reads the [T, 2I] intermediate (T·2I·2·2 bytes, e.g.
// 805 MB at [49152, 512], I = 2048). This kernel keeps the intermediate on
// chip. What bounds this first version instead is weight traffic: the weights
// (at most 9.8 MB, at C = 640) stay resident in the 50 MB L2 but every token
// tile re-reads them through 32-bit fragment loads whose latency the block's
// 8 warps cannot hide (one block per SM: its shared memory), so at C = 640,
// where the tile is 32 rows, it is slower than the plain composition.
// Register accumulators over larger tiles and wgmma/TMA are the next step.
// Its design, per block of 256 threads (8 warps):
//   * the x tile [BM, C] (bf16) and the accumulator [BM, C] (fp32) live in
//     dynamic shared memory; BM = 64 rows for C <= 512 and 32 for larger C,
//     so both fit one SM (at C = 640: 32·648·4 + 32·648·2 bytes);
//   * loop over inner chunks of 64: each warp computes 8 lin and 8 gate
//     columns of the chunk with mma.sync m16n8k16 (x from shared memory via
//     ldmatrix, W1 fragments straight from L2), adds the fp32 biases, applies
//     the exact-erf gelu (erff), rounds g to bf16 into shared memory;
//   * then each warp owns C/64 column tiles of the accumulator and adds
//     g·W2[chunk] into them (fp32, one owner per element, so no atomics);
//   * at the end, acc + b2 is rounded to bf16 and written out.
// The chunk loop is geglu_ffn_tile of ffn_tile.cuh, shared with the fused
// spatial-transformer kernel.
// Rows beyond T in the last tile are zero-filled and never stored.
// Requirements (checked by the Python wrapper): bf16 x/W1/W2, fp32 biases,
// contiguous; W1 [2I, C] and W2 [C, I] in nn.Linear layout; C % 16 == 0,
// C <= 1024, I % 64 == 0.

#include "ffn_tile.cuh"
#include "mma_utils.cuh"

namespace vmv {
namespace {

constexpr int kThreads = kFfnThreads;
constexpr int kChunk = kFfnChunk;
constexpr int kLdG = kFfnLdG;

__host__ __device__ constexpr int ffn_ld(int c) { return c + 8; }

__host__ size_t ffn_smem_bytes(int bm, int c) {
  return size_t(bm) * ffn_ld(c) * (sizeof(float) + sizeof(bf16)) +
         size_t(bm) * kLdG * sizeof(bf16);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
geglu_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int T, int C, int I) {
  constexpr int MT = BM / 16;  // m16 tiles per block
  const int ld = ffn_ld(C);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sAcc = reinterpret_cast<float*>(smem_raw);         // [BM][ld] fp32
  bf16* sX = reinterpret_cast<bf16*>(sAcc + BM * ld);        // [BM][ld]
  bf16* sG = sX + BM * ld;                                   // [BM][kLdG]

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BM;

  // x tile (zero rows past T) and a zeroed accumulator
  const int cpr = C / 8;
  for (int c = tid; c < BM * cpr; c += kThreads) {
    const int r = c / cpr;
    const int col = (c - r * cpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) val = *reinterpret_cast<const uint4*>(x + int64_t(t0 + r) * C + col);
    *reinterpret_cast<uint4*>(sX + r * ld + col) = val;
  }
  for (int i = tid; i < BM * ld; i += kThreads) sAcc[i] = 0.f;
  __syncthreads();

  geglu_ffn_tile<MT>(sX, sAcc, sG, ld, w1, b1, w2, C, I);

  // ---- out = acc + b2, rounded to bf16
  const int half = C / 2;
  for (int c = tid; c < BM * half; c += kThreads) {
    const int r = c / half;
    const int col = (c - r * half) * 2;
    if (t0 + r < T) {
      const float2 a = *reinterpret_cast<const float2*>(sAcc + r * ld + col);
      *reinterpret_cast<uint32_t*>(out + int64_t(t0 + r) * C + col) =
          pack_bf16x2(a.x + b2[col], a.y + b2[col + 1]);
    }
  }
}

template <int BM>
cudaError_t launch_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int T, int C, int I, cudaStream_t stream) {
  const size_t smem = ffn_smem_bytes(BM, C);
  cudaError_t err = cudaFuncSetAttribute(geglu_ffn_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM);
  geglu_ffn_kernel<BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), T, C, I);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vmv

// x [T, C], w1 [2I, C], w2 [C, I], out [T, C]: bf16; b1 [2I], b2 [C]: fp32.
// All contiguous. Returns a cudaError_t value.
extern "C" int vmv_geglu_ffn_fwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, int T, int C,
                                 int I, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || C <= 0 || C % 16 != 0 || C > 1024 || I <= 0 || I % vmv::kChunk != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (C <= 512) {  // token tile: 64 rows, else 32 (the accumulator must fit)
    return int(vmv::launch_ffn<64>(x, w1, b1, w2, b2, out, T, C, I, st));
  }
  return int(vmv::launch_ffn<32>(x, w1, b1, w2, b2, out, T, C, I, st));
}
