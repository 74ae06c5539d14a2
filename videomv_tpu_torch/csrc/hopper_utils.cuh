// Hopper (sm_90a) building blocks of the wgmma kernels of this package:
// mbarriers, TMA tile loads through tensor maps, the warpgroup fences of
// wgmma, shared-memory matrix descriptors and register reallocation. The
// wgmma instructions themselves are in wgmma_ops.cuh.
//
// Shared-memory operand tiles are in the canonical 128-byte-swizzle layout
// that both TMA (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma understand: rows of
// 128 bytes (64 bf16), 8-row groups of 1024 bytes back to back, the 16-byte
// chunk index of a row XORed with (row % 8); a tile starts on a 1024-byte
// boundary. A K-major operand (rows = M or N, the 128 bytes run along K)
// and an MN-major one (rows = K, the 128 bytes run along N; B only, with
// the transpose bit of the instruction) use the same descriptor: 1024
// bytes from one 8-row group to the next, the leading-dimension offset
// unused while the tile is one swizzle row wide. A k16 step advances the
// start address by 32 bytes (K-major) or by 16 rows = 2048 bytes (MN-major).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace vmv {

constexpr int kSwizzleRowBytes = 128;   // one swizzled row: 64 bf16
constexpr int kSwizzleAtomBytes = 1024;  // 8 rows
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the most one block may ask for

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// after the inits, before any thread or the TMA unit uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier has
// completed the phase of parity 1). A wait that never ends is a bug of the
// pipeline, so it traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// a ring position: stage index and the parity its consumer waits for
struct RingPos {
  int stage = 0;
  uint32_t parity = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// --------------------------------------------------------------------- TMA
// One thread copies a box of a tensor (named by a tensor map in kernel
// parameter space) into shared memory; the bytes land on `bar`. Coordinates
// are innermost first; what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma and TMA read shared memory through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// descriptor of a 128-byte-swizzled tile at `p`: start address, leading
// offset 16 bytes (unused), 1024 bytes between 8-row groups, swizzle mode 1
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(kSwizzleAtomBytes >> 4) << 32) | (uint64_t(1) << 62);
}

// descriptor steps (the start address counts 16-byte units)
constexpr uint64_t kDescStepK16 = 32 >> 4;            // K-major: 16 bf16 along the row
constexpr uint64_t kDescStepK16Mn = (16 * 128) >> 4;  // MN-major: 16 rows down

// byte offset of element (row, col) of a 128-byte-swizzled bf16 tile
__device__ __forceinline__ int sw128_offset(int row, int col) {
  return row * kSwizzleRowBytes + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

template <int REGS>
__device__ __forceinline__ void warpgroup_reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void warpgroup_reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads of the block
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive without waiting: `threads` counts the arriving and the waiting threads
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime; it is
// fetched through the runtime's entry-point query, so the library links
// against nothing but the runtime.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) !=
        cudaSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 tensor of `rank` dimensions (innermost first; the innermost is
// contiguous, `strides_bytes` are those of dimensions 1..rank-1, multiples of
// 16) cut into boxes of `box` elements, 128-byte swizzled: the innermost box
// dimension is 64. Out-of-bounds elements read as zero.
inline cudaError_t make_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                        const uint64_t* dims, const uint64_t* strides_bytes,
                                        const uint32_t* box) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || box[0] * 2 != kSwizzleRowBytes) {
    return cudaErrorInvalidValue;
  }
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) {
      if (strides_bytes[i] % 16 != 0) return cudaErrorInvalidValue;
      s[i] = strides_bytes[i];
    }
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank),
                        const_cast<void*>(base), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace vmv
