// GroupNorm, with an optional SiLU, for the served UNets and VAE (bf16 in and
// out, fp32 statistics):
//   y = silu?((x - mean_g) * rstd_g * gamma_c + beta_c)
// over the groups of x [N, C, ...], each (sample, group) normalised by the
// mean and the variance of its C/G channels.
//
// Replaces no TPU kernel: the JAX package leaves its GroupNorms to XLA, which
// fuses them on the TPU. It was added because the traces of the served
// requests put normalisation first among the classes of device time, with
// PyTorch's CUDA GroupNorm at about 5 % of the card's bandwidth in its
// statistics pass: it copies a strided input to a contiguous one, runs one
// block per (sample, group) over scalar loads (64 blocks on 132 SMs for the
// UNets' N = 2 temporal norms, 32 for the refine's), then an apply pass and a
// separate SiLU.
//
// What bounds it on the H100: bytes. It reads the input once and writes the
// output once (3.35 TB/s); its arithmetic is a few operations an element.
// The design moves no other byte where a group fits on chip:
//   * a (sample, group) is split over the CTAs of one thread-block cluster
//     (1 to 16, from the group's bytes and the number of groups against the
//     SMs; chosen by ops/group_norm.py::group_norm_plan). Each CTA copies its
//     slice into shared memory with 16-byte cp.async and keeps it there,
//     takes its mean and then its exact sum of (x - mean)^2 from there (two
//     passes at no extra read of device memory), and the CTAs merge their
//     moments through distributed shared memory by Chan's pairwise rule
//     (never sum(x^2) - mean^2); each then normalises its own slice from
//     shared memory and writes it.
//   * of a slice too large to hold (the groups of 2 MB and more: SV3D's
//     temporal norms at 72², the VAE's at 576²) a CTA holds the first part
//     and streams the rest, read twice: its moments per thread while the
//     held part's copies land, merged with the held part's by Chan's rule.
//     Holding less than the whole lets several CTAs share an SM, so that
//     one's loads overlap another's reductions and stores.
//   * the input is read where it lies: a group is R runs of L = (C/G)·P
//     contiguous elements, run r at r·in_sr (R = 1 for a contiguous input;
//     R = F for the UNets' temporal norms, whose input is a permuted view of
//     [B·F, C, H, W]). The output is contiguous in the input's logical order
//     [N, C, R·P], which is what the next (3, 1, 1) convolution takes, so no
//     copy precedes the norm.
//   * SiLU is applied to the fp32 value before the one bf16 rounding.
// Every reduction has a fixed order (shuffle tree, warps in order, cluster
// ranks in order), so two runs are bit-equal. The kernel allocates nothing
// and does not synchronise: a CUDA graph captures it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

using vmv::bf16;
namespace cg = cooperative_groups;

constexpr int kVec = 8;                  // bf16 values in one 16-byte vector
constexpr int kMaxThreads = 512;
constexpr int kMaxGroupChannels = 256;   // C / G
constexpr int kMaxCluster = 16;          // the non-portable cluster size of sm_90
constexpr int kMaxHeldBytes = 204800;

// n / d and n % d for 0 <= n < 2^31 by a multiply-high and a shift
// (Granlund and Montgomery; the multiplier is made on the host).
struct FastDiv {
  int d;
  unsigned mul, shift;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : int(__umulhi(unsigned(n), mul) >> shift);
  }
};

FastDiv make_fastdiv(int d) {
  FastDiv f{d, 0u, 0u};
  if (d != 1) {
    int log2d = 0;
    while ((1LL << log2d) < d) ++log2d;  // ceil(log2(d))
    const unsigned p = 31 + unsigned(log2d);
    f.mul = unsigned(((1ULL << p) + unsigned(d) - 1) / unsigned(d));
    f.shift = p - 32;
  }
  return f;
}

struct GnParams {
  const bf16* x;
  const bf16* w;
  const bf16* b;
  bf16* y;
  long long in_sn;  // elements from one sample to the next, in x
  long long in_sr;  // elements from one run to the next, in x
  int C, G;
  int R;            // runs of a group
  int P;            // elements of one channel in one run
  FastDiv by_L;     // the elements of one run of a group, (C/G)·P
  FastDiv by_P;
  int slice_vecs;   // 16-byte vectors of a group that one CTA takes
  int res_vecs;     // of them, those it holds in shared memory
  float eps;
  int silu;
};

struct Moments {  // a count, its mean and its sum of squared deviations
  float n, mean, m2;
};

// Chan et al.'s pairwise merge; `a` first (the order is fixed by the caller)
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float f = __fdividef(b.n, n);
  return {n, a.mean + delta * f, a.m2 + b.m2 + delta * delta * a.n * f};
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return q;
}

// y·sigmoid(y): the exponential and the reciprocal of the special-function
// unit (a few ulp of fp32, far below the output's bf16 step); y < -88 gives -0
__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// The sum over the CTA, the same value in every thread: each warp by a
// shuffle tree, then the warps' sums in order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

// The moments over the CTA, valid in thread 0.
__device__ __forceinline__ Moments block_moments(Moments m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments other = {__shfl_down_sync(0xffffffffu, m.n, o),
                           __shfl_down_sync(0xffffffffu, m.mean, o),
                           __shfl_down_sync(0xffffffffu, m.m2, o)};
    m = merge(m, other);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[3 * warp] = m.n;
    red[3 * warp + 1] = m.mean;
    red[3 * warp + 2] = m.m2;
  }
  __syncthreads();
  Moments t = {0.f, 0.f, 0.f};
  if (threadIdx.x == 0)
    for (int w = 0; w < int(blockDim.x >> 5); ++w)
      t = merge(t, Moments{red[3 * w], red[3 * w + 1], red[3 * w + 2]});
  return t;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Vector v of a group: its run and its offset inside the run.
struct Where {
  int r, i;
};

__device__ __forceinline__ Where locate(const GnParams& p, int v) {
  const int e = v * kVec;
  const int r = p.R == 1 ? 0 : p.by_L.div(e);
  return {r, e - r * p.by_L.d};
}

// Normalise the 8 values of one vector at (r, i) with each channel's scale a
// and shift b (y = x·a + b, then the SiLU).
__device__ __forceinline__ void normalise(const GnParams& p, float (&v)[kVec], int i,
                                          const float* ch_a, const float* ch_b) {
  const int c0 = p.by_P.div(i), j0 = i - c0 * p.P;
  if (j0 + kVec <= p.P) {  // one channel
    const float a = ch_a[c0], b = ch_b[c0];
    if (p.silu) {
#pragma unroll
      for (int t = 0; t < kVec; ++t) v[t] = silu(fmaf(v[t], a, b));
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) v[t] = fmaf(v[t], a, b);
    }
  } else {
    int c = c0, j = j0;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float y = fmaf(v[t], ch_a[c], ch_b[c]);
      v[t] = p.silu ? silu(y) : y;
      if (++j == p.P) {
        j = 0;
        ++c;
      }
    }
  }
}

// Write the 8 outputs of the vector at (r, i) to y [N, C, R·P].
__device__ __forceinline__ void store(const GnParams& p, const float (&v)[kVec], Where at, int n,
                                      int g, int cg_) {
  const int c0 = p.by_P.div(at.i), j0 = at.i - c0 * p.P;
  if (p.R == 1) {  // the output is laid out as the input
    const int64_t off = (int64_t(n) * p.G + g) * (int64_t(cg_) * p.P) + at.i;
    *reinterpret_cast<uint4*>(p.y + off) = pack(v);
    return;
  }
  const int64_t chan = int64_t(n) * p.C + int64_t(g) * cg_;
  if (p.P % kVec == 0) {  // 8 contiguous, aligned outputs
    *reinterpret_cast<uint4*>(p.y + ((chan + c0) * p.R + at.r) * p.P + j0) = pack(v);
    return;
  }
  int c = c0, j = j0;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    p.y[((chan + c) * p.R + at.r) * p.P + j] = __float2bfloat16_rn(v[t]);
    if (++j == p.P) {
      j = 0;
      ++c;
    }
  }
}

// One cluster normalises one (sample, group); blockIdx.x / cluster size is
// the group's index n·G + g. A CTA holds the first res_vecs vectors of its
// slice in shared memory and streams the rest (read twice). STAGED: a
// channel of a run is not whole vectors (R > 1, P % 8 != 0; an instance of
// its own, so that the common one keeps its registers).
// At most 40 registers a thread (3 CTAs of 512 threads an SM): at 44 the
// held-and-streamed plans lost a CTA an SM and 13 % of their speed.
template <bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, 3) group_norm_kernel(const GnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* buf = reinterpret_cast<uint4*>(smem_raw);
  __shared__ float red[3 * (kMaxThreads / 32)];
  __shared__ float part[3];  // this CTA's moments, read by the cluster
  __shared__ float ch_a[kMaxGroupChannels], ch_b[kMaxGroupChannels];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = int(cluster.num_blocks());
  const int gi = blockIdx.x / cs;
  const int n = gi / p.G, g = gi - n * p.G;
  const int cg_ = p.C / p.G;
  const int V = p.by_L.d / kVec * p.R;  // vectors of the group
  const float count = float(p.by_L.d) * float(p.R);
  const int v0 = int(cluster.block_rank()) * p.slice_vecs;
  const int nv = max(0, min(V - v0, p.slice_vecs));
  const int nres = min(nv, p.res_vecs);
  const bf16* xg = p.x + int64_t(n) * p.in_sn + int64_t(g) * p.by_L.d;

  for (int k = threadIdx.x; k < nres; k += blockDim.x) {
    const Where at = locate(p, v0 + k);
    vmv::cp_async_16(buf + k, xg + int64_t(at.r) * p.in_sr + at.i);
  }
  vmv::cp_async_commit();
  // the streamed part's moments, per thread, while those copies land
  Moments streamed = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = nres + threadIdx.x; k < nv; k += blockDim.x) {
    const Where at = locate(p, v0 + k);
    float v[kVec];
    unpack(__ldg(reinterpret_cast<const uint4*>(xg + int64_t(at.r) * p.in_sr + at.i)), v);
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) s += v[t];
    const float mv = s * (1.f / kVec);
    float d = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) d = fmaf(v[t] - mv, v[t] - mv, d);
    streamed = merge(streamed, Moments{float(kVec), mv, d});
  }
  vmv::cp_async_wait<0>();
  __syncthreads();
  // the resident part's exact moments: its mean, then its sum of (x - mean)^2
  Moments held = {float(nres) * kVec, 0.f, 0.f};
  if (nres > 0) {
    float s = 0.f;
#pragma unroll 4
    for (int k = threadIdx.x; k < nres; k += blockDim.x) {
      float v[kVec];
      unpack(buf[k], v);
#pragma unroll
      for (int t = 0; t < kVec; ++t) s += v[t];
    }
    held.mean = block_sum(s, red) / held.n;
    float m2 = 0.f;
#pragma unroll 4
    for (int k = threadIdx.x; k < nres; k += blockDim.x) {
      float v[kVec];
      unpack(buf[k], v);
#pragma unroll
      for (int t = 0; t < kVec; ++t) m2 = fmaf(v[t] - held.mean, v[t] - held.mean, m2);
    }
    held.m2 = block_sum(m2, red);
  }
  if (nres < nv) streamed = block_moments(streamed, red);
  if (threadIdx.x == 0) {
    const Moments mine = merge(held, streamed);
    part[0] = mine.n;
    part[1] = mine.mean;
    part[2] = mine.m2;
  }
  cluster.sync();
  // the group's moments: warp 0's lane r reads rank r's, a shuffle tree merges them
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    Moments t = {0.f, 0.f, 0.f};
    if (lane < unsigned(cs)) {
      const float* q = cluster.map_shared_rank(part, lane);
      t = Moments{q[0], q[1], q[2]};
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Moments other = {__shfl_down_sync(0xffffffffu, t.n, o),
                             __shfl_down_sync(0xffffffffu, t.mean, o),
                             __shfl_down_sync(0xffffffffu, t.m2, o)};
      t = merge(t, other);
    }
    if (lane == 0) {
      red[0] = t.mean;
      red[1] = t.m2;
    }
  }
  __syncthreads();
  const float mean = red[0], rstd = rsqrtf(red[1] / count + p.eps);
  // no CTA leaves while another may still read its moments
  cluster_arrive();

  for (int c = threadIdx.x; c < cg_; c += blockDim.x) {
    const float a = rstd * __bfloat162float(p.w[g * cg_ + c]);
    ch_a[c] = a;
    ch_b[c] = fmaf(-mean, a, __bfloat162float(p.b[g * cg_ + c]));
  }
  __syncthreads();

  // STAGED: the held part is normalised in place and written element by
  // element, so that neighbouring threads write neighbouring outputs
#pragma unroll 2
  for (int k = threadIdx.x; k < nv; k += blockDim.x) {
    const Where at = locate(p, v0 + k);
    float v[kVec];
    if (k < nres)
      unpack(buf[k], v);
    else
      unpack(*reinterpret_cast<const uint4*>(xg + int64_t(at.r) * p.in_sr + at.i), v);
    normalise(p, v, at.i, ch_a, ch_b);
    if (STAGED && k < nres)
      buf[k] = pack(v);
    else
      store(p, v, at, n, g, cg_);
  }
  if (STAGED) {
    __syncthreads();
    const bf16* held = reinterpret_cast<const bf16*>(buf);
    const int64_t chan = int64_t(n) * p.C + int64_t(g) * cg_;
    for (int e = threadIdx.x; e < nres * kVec; e += blockDim.x) {
      const int eg = v0 * kVec + e;
      const int r = p.by_L.div(eg), i = eg - r * p.by_L.d;
      const int c = p.by_P.div(i), j = i - c * p.P;
      p.y[((chan + c) * p.R + r) * p.P + j] = held[e];
    }
  }
  cluster_wait();
}

// the kernels' attributes, set at their first launch or query
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  for (const void* k : {reinterpret_cast<const void*>(group_norm_kernel<false>),
                        reinterpret_cast<const void*>(group_norm_kernel<true>)}) {
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxHeldBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

void fill_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks, int cs,
                 int threads, int smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool bad_plan(int cs, int slice_vecs, int res_vecs, int threads) {
  return cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) || slice_vecs < 1 || res_vecs < 0 ||
         res_vecs > slice_vecs || res_vecs * 16 > kMaxHeldBytes || threads < 32 ||
         threads > kMaxThreads || threads % 32;
}

}  // namespace

// How many clusters of `cs` CTAs of `threads` threads, each holding
// `res_vecs` vectors in shared memory, the card runs at once (0: it cannot
// place one); a negative value is a cudaError_t.
extern "C" int vmv_group_norm_max_clusters(int cs, int res_vecs, int threads) {
  if (bad_plan(cs, max(res_vecs, 1), res_vecs, threads)) return -int(cudaErrorInvalidValue);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return -int(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(&cfg, &attr, cs, cs, threads, res_vecs * 16, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, group_norm_kernel<false>, &cfg);
  return err == cudaSuccess ? clusters : -int(err);
}

// x: the input (bf16, 16-byte aligned, with the strides in_sn, in_sr in
// elements, both multiples of 8); w, b: gamma and beta [C] (bf16); y: the
// output [N, C, R·P], contiguous. The plan (cs CTAs a group, slice_vecs
// vectors a CTA, res_vecs of them held in shared memory, threads a CTA)
// comes from ops/group_norm.py::group_norm_plan.
extern "C" int vmv_group_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                  long long in_sn, long long in_sr, int N, int C, int G, int R,
                                  int P, float eps, int silu, int cs, int slice_vecs,
                                  int res_vecs, int threads, void* stream) {
  if (N < 1 || G < 1 || C % G || C / G > kMaxGroupChannels || R < 1 || P < 1 ||
      (C / G) * P % kVec || bad_plan(cs, slice_vecs, res_vecs, threads) ||
      int64_t(slice_vecs) * cs * kVec < int64_t(C / G) * P * R ||
      int64_t(C / G) * P * R >= (int64_t(1) << 31) || int64_t(N) * G * cs > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  GnParams p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const bf16*>(b);
  p.y = static_cast<bf16*>(y);
  p.in_sn = in_sn;
  p.in_sr = in_sr;
  p.C = C;
  p.G = G;
  p.R = R;
  p.P = P;
  p.by_L = make_fastdiv((C / G) * P);
  p.by_P = make_fastdiv(P);
  p.slice_vecs = slice_vecs;
  p.res_vecs = res_vecs;
  p.eps = eps;
  p.silu = silu;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(&cfg, &attr, N * G * cs, cs, threads, res_vecs * 16,
              static_cast<cudaStream_t>(stream));
  err = R > 1 && P % kVec ? cudaLaunchKernelEx(&cfg, group_norm_kernel<true>, p)
                          : cudaLaunchKernelEx(&cfg, group_norm_kernel<false>, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
