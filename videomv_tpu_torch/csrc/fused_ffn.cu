// Fused GEGLU feed-forward for the UNet's transformer blocks (bf16):
//   out = (x·W1a + b1a) · gelu_erf(x·W1b + b1b) · W2 + b2
//
// Replaces: videomv_tpu/ops/fused_ffn.py::_ffn_kernel (launched by _ffn_fwd).
// On the TPU the inner axis is a sequential grid axis that carries a
// [1024, C] fp32 accumulator in VMEM across grid steps. Hopper runs blocks in
// parallel and in no order, so here that axis is a loop inside the block and
// the accumulator lives in the registers of the block's warpgroups.
//
// What bounds it on the H100: by arithmetic the call is compute-bound (6·T·C·I
// flops against T·C·4 bytes of activations; 0.122 ms at [49152, 320]). What
// this kernel spends its time on was measured by compiling parts out
// (chip_smoke.py --phases env,ffn_ablation; [49152, 320] / [12288, 640] /
// [49152, 512], ms): whole 0.351 / 0.523 / 1.087; without the erff 0.303 /
// 0.483 / 0.997; without the first product's wgmmas 0.308 / 0.478 / 0.985;
// without the second's 0.317 / 0.492 / 1.012; without the weight loads 0.333 /
// 0.423 / 0.885; with none of the four 0.174 / 0.270 / 0.574. Half the time is
// the skeleton: a wait, a fence, a commit, a wait for the group before and a
// hand-back per stage of four wgmmas, and per chunk the drain of the first
// product, the g tile's stores, the proxy fence and the barrier of both
// warpgroups, during which the tensor cores idle. Holding stages longer (a
// hand-back two groups late, or the second product left in flight under the
// next chunk's gelu) made every width 2-19 % slower, and fetching each stage
// once for a cluster of two blocks (TMA multicast, one producer) none faster:
// the ring of 6-8 stages only just hides the L2 latency (1.9 GB of weights a
// call at C = 320 and at C = 640, 4.8 GB at C = 512, is 3.6-5.4 TB/s). At
// C = 640 the 192 blocks of 64 rows are 1.45 waves of the 132 SMs.
//
// The kernel, geglu_ffn_wgmma_kernel, takes the UNets' widths C = 320, 512 and
// 640 (other widths take the plain twin, ops/fused_ffn.py::ffn_eligible):
//   * a block owns 64 token rows. Two consumer warpgroups (2 x 128 threads)
//     share those rows and split the columns: each computes half of every
//     chunk's lin / gate columns and accumulates half of the C output columns
//     (80 / 128 / 160 fp32 registers a thread), so the accumulator never
//     leaves the registers. A 128-row tile (each warpgroup 64 rows x all C
//     columns) does not fit the registers at C >= 512; one design serves the
//     three widths.
//   * x [64, C] arrives once by TMA as C/64 tiles of 64 x 64 in the
//     128-byte-swizzled layout wgmma reads. W1 and W2 arrive by TMA through a
//     ring of 6-8 stages of 16-20 KB: per chunk of 64 inner columns the W1
//     stages (a K block of 64 columns of x: for each warpgroup its lin rows
//     then its gate rows, so one wgmma per k-step gives both, in the same
//     register positions) and then the W2 stages (for each warpgroup 80 or 64
//     of its output rows x the chunk's 64 columns). nn.Linear layout is
//     K-major B as it lies.
//   * who fills the ring. At C = 320 a third warpgroup's first thread is the
//     producer (full / empty mbarriers, setmaxnreg). ptxas keeps the wgmma
//     loops inside the register count of the launch (168 a thread for three
//     warpgroups, whatever setmaxnreg grants later) and spills beyond it, so
//     at C = 512 and 640 the block is the two consumer warpgroups alone with
//     up to 255 registers, and the last of its eight warps to finish a stage
//     (a counter in shared memory) issues the load that refills it: nobody
//     waits for a free stage.
//   * both products are wgmma with A and B in shared memory; a stage is
//     handed back once the wgmma group after it has been committed and the one
//     that read it has completed.
//   * gelu: g = (lin + b1a) · gelu_erf(gate + b1b) is formed in registers,
//     rounded to bf16 and written into a swizzled [64, 64] tile (double
//     buffered) that both warpgroups read as the A operand of the second
//     product; one named barrier a chunk.
//   * rows beyond T come from TMA as zeros and are never stored; T < 64 works.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py: 0.36 ms at
// [49152, 320] (34 % of the bound), 0.53 ms at [12288, 640] (23 %), 1.12 ms at
// [49152, 512] (28 %); the table in PERF.md has every shape.
// Requirements (checked by the Python wrapper): bf16 x/W1/W2, fp32 biases,
// contiguous, 16-byte aligned; W1 [2I, C] and W2 [C, I] in nn.Linear layout;
// C in {320, 512, 640}, I % 64 == 0.

#include "hopper_utils.cuh"
#include "mma_utils.cuh"
#include "wgmma_ops.cuh"

namespace vmv {
namespace {

// ------------------------------------------------ the wgmma kernel (sm_90a)
// Measurement switches (never defined in a normal build; the results are then
// wrong and only the times mean something): VMV_NOGELU leaves out the erff,
// VMV_NOG1 / VMV_NOG2 all but one wgmma of each pass of the first / each stage
// of the second product, VMV_NOLOAD the weight loads (the stage's barrier is
// arrived on without data). chip_smoke.py --phases env,ffn_ablation times them.
constexpr int kWgRows = 64;            // token rows per block
constexpr int kWgChunk = 64;           // inner columns per step
constexpr int kWgConsumers = 2;        // consumer warpgroups
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kXTileBytes = kWgRows * kSwizzleRowBytes;   // one 64 x 64 tile of x
constexpr int kGTileBytes = kWgRows * kSwizzleRowBytes;   // the g tile [64, 64]

template <int C>
struct FfnWg {
  static_assert(C % 64 == 0, "C must be a multiple of one swizzle row");
  static constexpr int kKB = C / 64;                   // K blocks of x and W1
  // lin (and as many gate) columns of a chunk per warpgroup. (16 at a time,
  // two passes a chunk, kept C = 640 further from the 255 registers but ran
  // 20 % slower: 32-column wgmmas read more shared memory than they compute.)
  static constexpr int kLG = kWgChunk / kWgConsumers;
  static constexpr int kNW2 = (C % 160 == 0) ? 80 : 64;  // W2 rows per warpgroup and stage
  static constexpr int kNSL = C / 2 / kNW2;            // W2 stages per chunk
  static_assert(kNSL * kNW2 * 2 == C, "the output columns must split evenly");
  // a W1 stage: one K block of 64 columns of x, for each warpgroup its lin
  // rows then its gate rows
  static constexpr int kW1StageBytes = kWgConsumers * 2 * kLG * kSwizzleRowBytes;
  static constexpr int kW2StageBytes = kWgConsumers * kNW2 * kSwizzleRowBytes;
  static constexpr int kStageBytes =
      kW1StageBytes > kW2StageBytes ? kW1StageBytes : kW2StageBytes;
  static_assert(kStageBytes % kSwizzleAtomBytes == 0, "stages must stay 1024-byte aligned");
  static constexpr int kFixedBytes = kKB * kXTileBytes + 2 * kGTileBytes;
  static constexpr int kBarrierBytes = 1024;
  static constexpr int kRoom = kMaxDynamicSmem - 1024 - kFixedBytes - kBarrierBytes;
  static constexpr int kStages = kRoom / kStageBytes < 8 ? kRoom / kStageBytes : 8;
  static_assert(kStages >= 4, "the weight ring needs a few stages");
  static constexpr int kSmemBytes = 1024 + kFixedBytes + kStages * kStageBytes + kBarrierBytes;
  // A third warpgroup whose first thread is the producer of the weight ring,
  // where the consumers fit the 168 registers a thread that three
  // warpgroups leave (ptxas keeps the wgmma loops within the launch's
  // register count whatever setmaxnreg grants later, and spills beyond it).
  // Otherwise the block is the two consumer warpgroups with up to 255
  // registers, and the last warp to finish a stage refills it.
  static constexpr bool kProducer = C <= 320;
  static constexpr int kThreads = kWgConsumerThreads + (kProducer ? 128 : 0);
};

__device__ __forceinline__ float gelu_erf_mul(float x) {
#ifdef VMV_NOGELU
  return x;
#endif
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <int C>
__global__ void __launch_bounds__(FfnWg<C>::kThreads, 1)
geglu_ffn_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const float* __restrict__ b1, const float* __restrict__ b2,
                       bf16* __restrict__ out, int T, int I) {
  using Cfg = FfnWg<C>;
  constexpr int KB = Cfg::kKB, NW2 = Cfg::kNW2, NSL = Cfg::kNSL, STAGES = Cfg::kStages;
  constexpr int LG = Cfg::kLG;
  constexpr bool PW = Cfg::kProducer;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sX = align_1024(smem_raw);            // KB tiles [64 x 64]
  unsigned char* sG = sX + KB * kXTileBytes;           // 2 tiles [64 x 64]
  unsigned char* ring = sG + 2 * kGTileBytes;          // STAGES weight stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Cfg::kStageBytes);
  uint64_t* empty = full + STAGES;  // PW only
  uint64_t* x_bar = empty + STAGES;
  // per stage, how many consumer warps have finished reading it (counts on)
  unsigned int* done = reinterpret_cast<unsigned int*>(x_bar + 1);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int t0 = blockIdx.x * kWgRows;
  const int n_chunks = I / kWgChunk;
  // the weight loads of a block, in the order they are consumed: per chunk
  // the KB stages of W1, then the NSL stages of W2
  constexpr int kLoadsPerChunk = KB + NSL;
  const int n_loads = n_chunks * kLoadsPerChunk;

  // load `n` of the sequence into stage `s` (one thread)
  auto issue_load = [&](int n, int s) {
    const int j = n / kLoadsPerChunk;
    const int r = n - j * kLoadsPerChunk;
    const int j0 = j * kWgChunk;
    unsigned char* dst = ring + s * Cfg::kStageBytes;
#ifdef VMV_NOLOAD
    mbar_arrive(&full[s]);
    return;
#endif
    if (r < KB) {
      mbar_arrive_expect_tx(&full[s], Cfg::kW1StageBytes);
#pragma unroll
      for (int w = 0; w < kWgConsumers; ++w) {  // LG lin rows, then LG gate rows
        unsigned char* d = dst + w * 2 * LG * kSwizzleRowBytes;
        tma_load_2d(d, &map_w1, &full[s], r * 64, j0 + w * LG);
        tma_load_2d(d + LG * kSwizzleRowBytes, &map_w1, &full[s], r * 64, I + j0 + w * LG);
      }
    } else {
      const int sl = r - KB;
      mbar_arrive_expect_tx(&full[s], Cfg::kW2StageBytes);
#pragma unroll
      for (int w = 0; w < kWgConsumers; ++w) {
        tma_load_2d(dst + w * NW2 * kSwizzleRowBytes, &map_w2, &full[s], j0,
                    w * (C / 2) + sl * NW2);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgConsumers);  // lane 0 of every consumer warp
      done[s] = 0;
    }
    mbar_init(x_bar, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(x_bar, KB * kXTileBytes);
    for (int kb = 0; kb < KB; ++kb) {
      tma_load_2d(sX + kb * kXTileBytes, &map_x, x_bar, kb * 64, t0);
    }
    if (!PW) {
      for (int n = 0; n < STAGES && n < n_loads; ++n) issue_load(n, n);
    }
  }
  __syncthreads();

  if (PW && wg == kWgConsumers) {
    // ------------------------------------------------------------ producer
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      RingPos pos;
      for (int n = 0; n < n_loads; ++n) {
        mbar_wait(&empty[pos.stage], pos.parity ^ 1);
        issue_load(n, pos.stage);
        pos.advance<STAGES>();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if (PW) warpgroup_reg_alloc<240>();  // headroom for the epilogue
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int q2 = (lane & 3) * 2;
    const int row = warp * 16 + g;  // and row + 8

    float acc[NSL][NW2 / 2];
    float lg[LG];  // lin in [0, LG / 2), gate in [LG / 2, LG): same rows and columns
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) {
#pragma unroll
      for (int i = 0; i < NW2 / 2; ++i) acc[sl][i] = 0.f;
    }

    // A warp is done with stage `s` (its wgmma group has completed): the
    // last of the block's warps to say so refills the stage with the load
    // STAGES further on, so no thread ever waits for a free stage.
    auto release = [&](int s, int n) {
      if (PW) {
        if (lane == 0) mbar_arrive(&empty[s]);
        return;
      }
      if (lane == 0) {
        __threadfence_block();
        const unsigned int before = atomicAdd(&done[s], 1u);
        if ((before & (4 * kWgConsumers - 1)) == 4 * kWgConsumers - 1) {
          __threadfence_block();
          if (n + STAGES < n_loads) issue_load(n + STAGES, s);
        }
      }
      __syncwarp();
    };

    mbar_wait(x_bar, 0);
    RingPos pos;
    int n = 0;  // index of the load in pos.stage
    for (int j = 0; j < n_chunks; ++j) {
      unsigned char* gbuf = sG + (j & 1) * kGTileBytes;
      int prev = 0;
      // ---- lin / gate of this warpgroup's LG columns of the chunk
#pragma unroll 1
      for (int kb = 0; kb < KB; ++kb) {
        mbar_wait(&full[pos.stage], pos.parity);
        const uint64_t da = wgmma_desc_sw128(sX + kb * kXTileBytes);
        const uint64_t db = wgmma_desc_sw128(ring + pos.stage * Cfg::kStageBytes +
                                             wg * 2 * LG * kSwizzleRowBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the chunk's first product overwrites lg
          const int more = (kb | k) != 0;
#ifdef VMV_NOG1
          if (more) continue;
#endif
          wgmma_ss_n64(lg, da + k * kDescStepK16, db + k * kDescStepK16, more);
        }
        wgmma_commit();
        if (kb > 0) {  // the group before this one has read its stage
          wgmma_wait<1>();
          release(prev, n - 1);
        }
        prev = pos.stage;
        pos.advance<STAGES>();
        ++n;
      }
      wgmma_wait<0>();
      release(prev, n - 1);

      // ---- g = (lin + b1a) · gelu(gate + b1b), bf16, into the shared g tile
#pragma unroll
      for (int jj = 0; jj < LG / 8; ++jj) {
        const int col = wg * LG + jj * 8 + q2;  // within the chunk
        const int ic = j * kWgChunk + col;
        const float bl0 = __ldg(b1 + ic), bl1 = __ldg(b1 + ic + 1);
        const float bg0 = __ldg(b1 + I + ic), bg1 = __ldg(b1 + I + ic + 1);
        constexpr int kGate = LG / 2;  // gate sits LG / 2 registers after lin
        const float g0 = (lg[4 * jj + 0] + bl0) * gelu_erf_mul(lg[kGate + 4 * jj + 0] + bg0);
        const float g1 = (lg[4 * jj + 1] + bl1) * gelu_erf_mul(lg[kGate + 4 * jj + 1] + bg1);
        const float g2 = (lg[4 * jj + 2] + bl0) * gelu_erf_mul(lg[kGate + 4 * jj + 2] + bg0);
        const float g3 = (lg[4 * jj + 3] + bl1) * gelu_erf_mul(lg[kGate + 4 * jj + 3] + bg1);
        *reinterpret_cast<uint32_t*>(gbuf + sw128_offset(row, col)) = pack_bf16x2(g0, g1);
        *reinterpret_cast<uint32_t*>(gbuf + sw128_offset(row + 8, col)) = pack_bf16x2(g2, g3);
      }
      fence_proxy_async();
      named_barrier_sync(1, 128 * kWgConsumers);  // every column of g is written

      // ---- acc[:, this warpgroup's columns] += g · W2[columns, chunk]^T
      const uint64_t dg = wgmma_desc_sw128(gbuf);
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl) {
        mbar_wait(&full[pos.stage], pos.parity);
        const uint64_t db = wgmma_desc_sw128(ring + pos.stage * Cfg::kStageBytes +
                                             wg * NW2 * kSwizzleRowBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#ifdef VMV_NOG2
          if (k) continue;
#endif
          if constexpr (NW2 == 80) {
            wgmma_ss_n80(acc[sl], dg + k * kDescStepK16, db + k * kDescStepK16, 1);
          } else {
            wgmma_ss_n64(acc[sl], dg + k * kDescStepK16, db + k * kDescStepK16, 1);
          }
        }
        wgmma_commit();
        if (sl > 0) {
          wgmma_wait<1>();
          release(prev, n - 1);
        }
        prev = pos.stage;
        pos.advance<STAGES>();
        ++n;
      }
      // every read of this g tile is done before the barrier of the next
      // chunk, so the chunk after that may overwrite it
      wgmma_wait<0>();
      release(prev, n - 1);
    }

    // ---- out = acc + b2, rounded to bf16
    const int r0 = t0 + row;
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) {
#pragma unroll
      for (int jj = 0; jj < NW2 / 8; ++jj) {
        const int col = wg * (C / 2) + sl * NW2 + jj * 8 + q2;
        const float c0 = __ldg(b2 + col), c1 = __ldg(b2 + col + 1);
        if (r0 < T) {
          *reinterpret_cast<uint32_t*>(out + int64_t(r0) * C + col) =
              pack_bf16x2(acc[sl][4 * jj + 0] + c0, acc[sl][4 * jj + 1] + c1);
        }
        if (r0 + 8 < T) {
          *reinterpret_cast<uint32_t*>(out + int64_t(r0 + 8) * C + col) =
              pack_bf16x2(acc[sl][4 * jj + 2] + c0, acc[sl][4 * jj + 3] + c1);
        }
      }
    }
  }
}

template <int C>
cudaError_t launch_ffn_wgmma(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int T, int I, cudaStream_t stream) {
  using Cfg = FfnWg<C>;
  CUtensorMap map_x, map_w1, map_w2;
  {
    const uint64_t dims[2] = {uint64_t(C), uint64_t(T)}, strides[1] = {uint64_t(C) * 2};
    const uint32_t box[2] = {64, uint32_t(kWgRows)};
    const cudaError_t err = make_tensor_map_bf16(&map_x, x, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  {
    const uint64_t dims[2] = {uint64_t(C), uint64_t(2) * I}, strides[1] = {uint64_t(C) * 2};
    const uint32_t box[2] = {64, uint32_t(Cfg::kLG)};  // a warpgroup's lin or gate rows
    const cudaError_t err = make_tensor_map_bf16(&map_w1, w1, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  {
    const uint64_t dims[2] = {uint64_t(I), uint64_t(C)}, strides[1] = {uint64_t(I) * 2};
    const uint32_t box[2] = {64, uint32_t(Cfg::kNW2)};
    const cudaError_t err = make_tensor_map_bf16(&map_w2, w2, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(geglu_ffn_wgmma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kWgRows - 1) / kWgRows);
  geglu_ffn_wgmma_kernel<C><<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      map_x, map_w1, map_w2, static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<bf16*>(out), T, I);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vmv

// x [T, C], w1 [2I, C], w2 [C, I], out [T, C]: bf16; b1 [2I], b2 [C]: fp32.
// All contiguous. C in {320, 512, 640}, I % 64 == 0; any other shape is
// cudaErrorInvalidValue. Returns a cudaError_t value.
extern "C" int vmv_geglu_ffn_fwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, int T, int C,
                                 int I, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || I <= 0 || I % vmv::kWgChunk != 0) return int(cudaErrorInvalidValue);
  if (C == 320) return int(vmv::launch_ffn_wgmma<320>(x, w1, b1, w2, b2, out, T, I, st));
  if (C == 512) return int(vmv::launch_ffn_wgmma<512>(x, w1, b1, w2, b2, out, T, I, st));
  if (C == 640) return int(vmv::launch_ffn_wgmma<640>(x, w1, b1, w2, b2, out, T, I, st));
  return int(cudaErrorInvalidValue);
}
