// The residual sum of the ADM UNet's residual blocks with the biases of the
// two convolutions that feed it, for the inference forward on Hopper (sm_90a):
//   y[n, c, h, w] = skip[n, c, h, w] + conv[n, c, h, w] + (bias[c] + bias2[c])
// over NCHW-contiguous tensors, in f32, rounded once to the tensors' type
// (bf16 or f32). conv is the block's last convolution run without its bias;
// skip is the block's input (an identity skip) or its 1x1 skip convolution
// run without its bias, whose bias is bias2 (null for none).
//
// Replaces no TPU kernel: XLA fuses a convolution's bias into its output. In
// the port torch adds each convolution's bias in a broadcast pass of its own
// after cuDNN's convolution, which reads and writes the whole output once
// more; the residual sum then reads both outputs again. This pass does the
// residual sum's bytes alone (two reads and a write an element) and the two
// bias passes go.
//
// What bounds it on the H100: bytes, 3 × 2 bytes a bf16 element; at the SR
// model's largest site ([54, 128, 256, 256] bf16) 2.72 GB, 0.81 ms at
// 3.35 TB/s. One thread a 16-byte vector of each input, one block for each
// kThreads vectors: on the H100 92% of that bound at the SR shape, as
// torch's own add, where a grid-stride loop over four vectors a thread with
// streaming loads reached 80-87%. Every vector lies in one channel (H·W is a
// multiple of the vector's elements), so one bias a vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Params {
  const uint4* skip;
  const uint4* conv;
  uint4* y;
  const float* bias;
  const float* bias2;  // null for none
  unsigned vecs;       // 16-byte vectors in each tensor, below 2^31
  unsigned vecs_per_channel;
  unsigned channels;
};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ uint4 sum(const uint4 a, const uint4 b, const float bias) {
    return make_uint4(__float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x) + bias),
                      __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y) + bias),
                      __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z) + bias),
                      __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w) + bias));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // One 32-bit word: two bf16, widened, summed in f32 and rounded once.
  static __device__ __forceinline__ uint32_t pair(const uint32_t a, const uint32_t b,
                                                  const float bias) {
    const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16) + bias;
    const float hi = __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u) + bias;
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  static __device__ __forceinline__ uint4 sum(const uint4 a, const uint4 b, const float bias) {
    return make_uint4(pair(a.x, b.x, bias), pair(a.y, b.y, bias), pair(a.z, b.z, bias),
                      pair(a.w, b.w, bias));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) bias_residual_kernel(const Params p) {
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= p.vecs) return;
  const uint4 a = p.skip[v], b = p.conv[v];
  const unsigned c = v / p.vecs_per_channel % p.channels;
  float bias = __ldg(p.bias + c);
  if (p.bias2) bias += __ldg(p.bias2 + c);
  p.y[v] = Vec<T>::sum(a, b, bias);
}

}  // namespace

// skip, conv, y [batch, channels, H, W] contiguous and 16-byte aligned, all
// bf16 (bf16 != 0) or all f32; bias and bias2 [channels] f32, bias2 null for
// none; hw = H·W a multiple of the 16-byte vector's elements (8 bf16, 4 f32),
// fewer than 2^31 vectors in a tensor (32-bit indexing). Returns the launch's
// CUDA error code (0 on success).
extern "C" int bias_residual_launch(const void* skip, const void* conv, void* y, const void* bias,
                                    const void* bias2, long long batch, int channels,
                                    long long hw, int bf16, void* stream) {
  const int elems = bf16 ? 8 : 4;
  if (batch <= 0 || channels <= 0 || hw <= 0 || hw % elems || bias == nullptr ||
      batch * channels * (hw / elems) >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.skip = static_cast<const uint4*>(skip);
  p.conv = static_cast<const uint4*>(conv);
  p.y = static_cast<uint4*>(y);
  p.bias = static_cast<const float*>(bias);
  p.bias2 = static_cast<const float*>(bias2);
  p.vecs_per_channel = static_cast<unsigned>(hw / elems);
  p.vecs = static_cast<unsigned>(batch * channels * (hw / elems));
  p.channels = static_cast<unsigned>(channels);
  const unsigned blocks = (p.vecs + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    bias_residual_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(p);
  } else {
    bias_residual_kernel<float><<<blocks, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
