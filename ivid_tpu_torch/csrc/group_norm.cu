// GroupNorm fused with the scale-shift and the SiLU that follow it, for the
// ADM UNet's inference forward on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it with its neighbours. It was added because the port's composition
// (a cast of the bf16 torso to f32, torch's two-kernel f32 GroupNorm, a cast
// back, the scale-shift as two broadcast ops, a SiLU pass) led the device time
// of the bf16 cells. One launch computes, over NCHW input x [N, C, H, W], one
// of
//   kNorm:           y = group_norm(x)
//   kSilu:           y = silu(group_norm(x))
//   kScaleShiftSilu: y = silu(group_norm(x) * (1 + scale[n, c]) + shift[n, c])
// in f32, rounded once to the output type; scale and shift are read from the
// embedding layer's f32 output emb [N, 2C] (scale in columns [0, C), shift in
// [C, 2C)), the per-channel affine from f32 gamma and beta. Input and output
// types: bf16 -> bf16 (the torso), bf16 -> f32 (the head), f32 -> f32.
// An optional f32 input bias [C] (null for none) is added to x in f32 wherever
// the kernel reads it, so group_norm(x + bias[c]) is computed: the bias of the
// convolution whose output x is, which the UNet leaves out of that
// convolution (the residual blocks' first convolution; a pass of its own in
// torch's convolution otherwise).
//
// What bounds it on the H100: bytes. Each element is read once and written
// once: at the SR model's largest site ([54, 256, 256, 256] bf16) 1.81 GB,
// 0.54 ms at 3.35 TB/s. The statistics and the affine are a few flops an
// element.
//
// Design:
// - In NCHW each (image, group) is one contiguous slab of (C/G)·H·W
//   elements: 1,024 at a batch-1 8² site, 524,288 (1 MB of bf16) where the
//   SR model normalises a concatenated 256-channel input at 256². A slab is
//   cut into portions of at most kTargetBytes, one block each; the blocks of
//   one slab form a thread block cluster (at most kMaxCluster), so 1,728
//   slabs of 1 MB are 13,824 blocks, and 32 slabs of 2 KB are 32 blocks.
// - A block stages its portion in shared memory with 16-byte cp.async copies,
//   all issued before the first is waited on, so the slab is read from
//   device memory once and the memory system has the whole portion in
//   flight. Each thread reads back only the vectors it copied, so no block
//   barrier stands between the copies and the statistics.
// - Statistics are stable for inputs far from zero (random-weight
//   activations reach |x| ~ 1e3): every element is taken less the slab's
//   first element (a sample of the same distribution); each thread forms
//   the mean and the centred sum of squares of its own elements in two
//   passes over shared memory, and those (count, mean, M2) triples are
//   merged by Chan's formula over the warp, the block and, through
//   distributed shared memory, the cluster. Every block of a cluster merges
//   the same partials in the same order, so all get the same statistics,
//   and the result is the same on every launch (no atomics).
// - The apply pass reads the staged portion again and writes each 16-byte
//   vector (which lies in one channel: H·W is a multiple of the vector's
//   elements) as y = (x - mean) · a + b, with a = rstd·gamma[c]·(1 + scale)
//   and b = beta[c]·(1 + scale) + shift, then the SiLU, in f32.
// - With an input bias every read of x, the slab's first element among them,
//   is x + bias[c] in f32, c the channel of the element's vector: the
//   statistics and the apply pass see the biased input, and no pass of its
//   own writes it. The bias is a template parameter, so the kernel without
//   one is unchanged; with one, a thread reads its first kVecsPerThread
//   vectors' biases into registers while its copies land. On the H100 the
//   bias adds 2-7% to the kernel's time at the SR and flagship shapes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;  // non-portable above 8: the H100 takes 16
// A block stages at most kTargetBytes unless the slab needs more than
// kMaxCluster of them; then up to kMaxStageBytes.
constexpr long long kTargetBytes = 64 * 1024;
constexpr long long kMaxStageBytes = 192 * 1024;
constexpr int kVecsPerThread = 8;

enum Mode { kNorm = 0, kSilu = 1, kScaleShiftSilu = 2 };

struct Params {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  const float* emb;      // [N, emb_stride] f32, scale then shift; null unless kScaleShiftSilu
  const float* in_bias;  // [channels] f32 added to x as it is read; null for none
  float inv_vecs_per_channel;  // 1 / (H·W / kN), rounded to f32
  long long emb_stride;  // floats from one image's row of emb to the next
  long long slab_vecs;   // 16-byte vectors in one (image, group) slab
  int portion_vecs;      // vectors a block stages (the slab's last block may hold fewer)
  int cluster;           // blocks per slab
  int channels, groups, hw;
  float eps;
};

struct Moments {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, centred sum of squares) triples.
__device__ __forceinline__ Moments merge(const Moments a, const Moments b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// Lane 0 ends with the merge of the warp's triples (a fixed tree).
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments other{__shfl_down_sync(0xffffffffu, m.n, o),
                        __shfl_down_sync(0xffffffffu, m.mean, o),
                        __shfl_down_sync(0xffffffffu, m.m2, o)};
    m = merge(m, other);
  }
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float scalar(const void* p) {
    return *static_cast<const float*>(p);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float scalar(const void* p) {
    return __bfloat162float(*static_cast<const __nv_bfloat16*>(p));
  }
};

// Writes kN results of one input vector as Out, 16 bytes a store.
template <typename Out, int kN>
__device__ __forceinline__ void store(Out* dst, const float* y);

template <>
__device__ __forceinline__ void store<__nv_bfloat16, 8>(__nv_bfloat16* dst, const float* y) {
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <>
__device__ __forceinline__ void store<float, 8>(float* dst, const float* y) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

template <>
__device__ __forceinline__ void store<float, 4>(float* dst, const float* y) {
  *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
}

// The fast exponential and division: ~2 ulp, far inside the bf16 output's
// rounding and ~1e-6 of an f32 output; v / inf gives -0 for v << 0.
__device__ __forceinline__ float silu(const float v) { return __fdividef(v, 1.f + __expf(-v)); }

template <typename In, typename Out, int kMode, bool kBias>
__global__ void __launch_bounds__(kMaxThreads) gn_act_kernel(const Params p) {
  using V = Vec<In>;
  constexpr int kN = V::kN;
  extern __shared__ __align__(16) uint4 stage[];
  __shared__ Moments warp_part[kMaxWarps];
  __shared__ Moments block_part;  // read by the cluster's other blocks
  __shared__ float stats[2];      // mean, rstd

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long slab = blockIdx.x / p.cluster;  // n * groups + g
  const int rank = blockIdx.x % p.cluster;        // rank in the cluster
  const long long first = static_cast<long long>(rank) * p.portion_vecs;
  const int count = static_cast<int>(min(static_cast<long long>(p.portion_vecs),
                                         p.slab_vecs - first));
  const uint4* src = static_cast<const uint4*>(p.x) + slab * p.slab_vecs + first;

  for (int v = tid; v < count; v += nthreads) cp_async16(&stage[v], &src[v]);

  const int c0 = static_cast<int>(slab % p.groups) * (p.channels / p.groups);
  // The channel of the portion's vector v, floor((first + v + 1/2) / V) for
  // V vectors a channel, in f32: the quotient lies 1/(2V) or more from a
  // whole number, and its rounding error, under 2^-22 of a quotient below
  // 196,608 / V (a slab's most vectors), stays under that.
  auto channel = [&](const int v) {
    const float q = (static_cast<float>(first + v) + 0.5f) * p.inv_vecs_per_channel;
    return c0 + static_cast<int>(q);
  };
  // With the input bias, the biases of this thread's first kVecsPerThread
  // vectors (v = tid + k·nthreads) are read while the copies land and kept
  // in registers for both passes of the statistics.
  float origin = V::scalar(static_cast<const In*>(p.x) + slab * p.slab_vecs * kN);
  float cached[kVecsPerThread];
  if (kBias) {
    origin += __ldg(p.in_bias + c0);
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int v = tid + k * nthreads;
      cached[k] = v < count ? __ldg(p.in_bias + channel(v)) : 0.f;
    }
  }
  cp_async_wait_all();
  // body(v, bias) for each of this thread's vectors and its channel's input
  // bias (0 without): without the bias one loop; with it the cached vectors
  // unrolled, then a loop over any others.
  auto each = [&](auto&& body) {
    if (!kBias) {
      for (int v = tid; v < count; v += nthreads) body(v, 0.f);
      return;
    }
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int v = tid + k * nthreads;
      if (v < count) body(v, cached[k]);
    }
    for (int v = tid + kVecsPerThread * nthreads; v < count; v += nthreads) {
      body(v, __ldg(p.in_bias + channel(v)));
    }
  };

  // Each thread's own elements, less the slab's first (biased too): mean,
  // then M2. A bias is one add a vector; an element takes one add as without.
  float f[kN];
  float sum = 0.f;
  int n = 0;
  each([&](const int v, const float bias) {
    V::unpack(stage[v], f);
    const float shift = bias - origin;
#pragma unroll
    for (int i = 0; i < kN; ++i) sum += f[i] + shift;
    n += kN;
  });
  Moments m{static_cast<float>(n), n ? sum / static_cast<float>(n) : 0.f, 0.f};
  each([&](const int v, const float bias) {
    V::unpack(stage[v], f);
    const float shift = bias - origin;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float d = f[i] + shift - m.mean;
      m.m2 += d * d;
    }
  });
  m = warp_merge(m);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    Moments b = lane < (nthreads >> 5) ? warp_part[lane] : Moments{0.f, 0.f, 0.f};
    b = warp_merge(b);
    if (lane == 0) block_part = b;
  }
  if (p.cluster > 1) {
    // Every block's partial is written before any block reads it.
    cluster_arrive();
    cluster_wait();
    if (warp == 0) {
      Moments b{0.f, 0.f, 0.f};
      if (lane < p.cluster) b = *cg::this_cluster().map_shared_rank(&block_part, lane);
      b = warp_merge(b);
      if (lane == 0) {
        stats[0] = origin + b.mean;
        stats[1] = rsqrtf(b.m2 / b.n + p.eps);
      }
    }
    // This block reads no other block's shared memory from here on.
    cluster_arrive();
  } else if (tid == 0) {
    stats[0] = origin + block_part.mean;
    stats[1] = rsqrtf(block_part.m2 / block_part.n + p.eps);
  }
  __syncthreads();

  const float mean = stats[0], rstd = stats[1];
  const int img = static_cast<int>(slab / p.groups);
  Out* dst = static_cast<Out*>(p.y) + (slab * p.slab_vecs + first) * kN;
  for (int v = tid; v < count; v += nthreads) {
    const int c = channel(v);
    const float shift = kBias ? __ldg(p.in_bias + c) - mean : -mean;
    float a = rstd * __ldg(p.gamma + c);
    float b = __ldg(p.beta + c);
    if (kMode == kScaleShiftSilu) {
      const float* e = p.emb + img * p.emb_stride;
      const float s = 1.f + __ldg(e + c);
      a *= s;
      b = fmaf(b, s, __ldg(e + p.channels + c));
    }
    V::unpack(stage[v], f);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float y = fmaf(f[i] + shift, a, b);
      f[i] = kMode == kNorm ? y : silu(y);
    }
    store<Out, kN>(dst + static_cast<long long>(v) * kN, f);
  }
  // No block leaves while another may still read its partial.
  if (p.cluster > 1) cluster_wait();
}

template <typename In, typename Out, int kMode, bool kBias>
cudaError_t launch(const Params& p, long long slabs, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = gn_act_kernel<In, Out, kMode, kBias>;
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxStageBytes));
    if (err == cudaSuccess && kMaxCluster > 8) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(slabs * p.cluster));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename In, typename Out, bool kBias>
cudaError_t launch_mode(const Params& p, int mode, long long slabs, int threads, size_t smem,
                        cudaStream_t stream) {
  switch (mode) {
    case kNorm:
      return launch<In, Out, kNorm, kBias>(p, slabs, threads, smem, stream);
    case kSilu:
      return launch<In, Out, kSilu, kBias>(p, slabs, threads, smem, stream);
    case kScaleShiftSilu:
      return launch<In, Out, kScaleShiftSilu, kBias>(p, slabs, threads, smem, stream);
  }
  return cudaErrorInvalidValue;
}

// The kernel with or without the input bias: separate instances, so that
// the one without reads x as before the bias existed.
template <typename In, typename Out>
cudaError_t launch_bias(const Params& p, int mode, long long slabs, int threads, size_t smem,
                        cudaStream_t stream) {
  return p.in_bias ? launch_mode<In, Out, true>(p, mode, slabs, threads, smem, stream)
                   : launch_mode<In, Out, false>(p, mode, slabs, threads, smem, stream);
}

}  // namespace

// x [batch, channels, H, W] contiguous, 16-byte aligned, bf16 (in_bf16) or
// f32; y the same shape in bf16 (out_bf16) or f32 (bf16 -> bf16, bf16 -> f32
// and f32 -> f32 only); gamma, beta [channels] f32; emb [batch, emb_stride]
// f32 with scale in columns [0, channels) and shift in [channels,
// 2·channels) for mode 2, else unused. mode: 0 group norm, 1 with the SiLU,
// 2 with the scale-shift and the SiLU; in_bias [channels] f32 added to x as
// it is read, or null. channels % groups == 0, hw = H·W a multiple of the
// 16-byte vector's elements (8 bf16, 4 f32), a slab ((channels / groups)·hw
// elements) at most kMaxCluster·kMaxStageBytes. Returns the launch's CUDA
// error code (0 on success).
extern "C" int gn_act_launch(const void* x, void* y, const void* gamma, const void* beta,
                             const void* emb, long long emb_stride, const void* in_bias,
                             int batch, int channels, int groups, int hw, int in_bf16,
                             int out_bf16, int mode, float eps, void* stream) {
  const int elems = in_bf16 ? 8 : 4;
  if (batch <= 0 || groups <= 0 || channels % groups || hw % elems || (!in_bf16 && out_bf16) ||
      mode < 0 || mode > 2 || (mode == kScaleShiftSilu && emb == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.x = x;
  p.y = y;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.emb = static_cast<const float*>(emb);
  p.emb_stride = emb_stride;
  p.in_bias = static_cast<const float*>(in_bias);
  p.inv_vecs_per_channel = 1.f / static_cast<float>(hw / elems);
  p.channels = channels;
  p.groups = groups;
  p.hw = hw;
  p.eps = eps;
  p.slab_vecs = static_cast<long long>(channels / groups) * hw / elems;
  const long long slab_bytes = p.slab_vecs * 16;
  long long cluster = (slab_bytes + kTargetBytes - 1) / kTargetBytes;
  if (cluster > kMaxCluster) cluster = kMaxCluster;
  const long long portion = (p.slab_vecs + cluster - 1) / cluster;
  if (portion * 16 > kMaxStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  p.portion_vecs = static_cast<int>(portion);
  p.cluster = static_cast<int>((p.slab_vecs + portion - 1) / portion);  // no empty block
  int threads = static_cast<int>((portion + kVecsPerThread - 1) / kVecsPerThread);
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(portion) * 16;
  const long long slabs = static_cast<long long>(batch) * groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!in_bf16) {
    err = launch_bias<float, float>(p, mode, slabs, threads, smem, s);
  } else if (out_bf16) {
    err = launch_bias<__nv_bfloat16, __nv_bfloat16>(p, mode, slabs, threads, smem, s);
  } else {
    err = launch_bias<__nv_bfloat16, float>(p, mode, slabs, threads, smem, s);
  }
  return static_cast<int>(err);
}
