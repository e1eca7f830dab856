// Z-buffer resolve of pixel-sorted fragments for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ivid_tpu/ops/raster_tiled.py:_tile_kernel
// (launched by resolve_zbuffer_tiled). Same function, not its VMEM tiling:
// for every pixel of B stacked framebuffers, the depth minimum over the
// pixel's fragments (GL '<', clear depth 1.0), then the payload (K <= 4
// channels) averaged over the fragments whose depth equals that minimum
// (equal-depth ties average), the winner count, and coverage.
//
// Input, prepared on the device by ivid_tpu_torch/ops/raster_tiled.py as the
// JAX function prepares it: fragments sorted by pixel key (stable, invalid
// fragments keyed past the last pixel and so in no pixel's run), their window
// depth z [N] and payload [N, 4] (zeroed where invalid), and the run starts
// [npix + 1] from a search of the sorted keys. Output in image row order (GL
// rows flipped per buffer): payload [npix, K] (0 where empty), depth [npix]
// (1.0 where empty), covered [npix] (bool).
//
// What bounds it on the H100: bytes. It reads each fragment's 20 bytes once
// (z and 4 payload floats; the second walk over a run hits L1/L2) and the
// starts, and writes 4K + 5 bytes per pixel. At the training shape (8 buffers
// of 384², ~4.1M fragments) that is ~82 MB read and ~25 MB written, ~32 us at
// 3.35 TB/s.
//
// Design: one thread per pixel walks its run twice: the depth minimum, then
// the sums over z == min. The sums run in sort order, so the result is
// deterministic and stays right however many fragments stack on one pixel
// (the TPU kernel's dynamic chunk loop has the same property). The TPU
// kernel's [tile, chunk] one-hot compare and winner matmul exist to use its
// vector and matrix units; a thread per pixel needs neither.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFar = 9.0f;  // no-fragment depth; valid window z lies in [0, 1]

__global__ void __launch_bounds__(kThreads)
zbuffer_resolve(const int* __restrict__ starts, const float* __restrict__ z,
                const float4* __restrict__ pay, float* __restrict__ out_pay,
                float* __restrict__ out_depth, unsigned char* __restrict__ covered,
                long long npix, int r, int k) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int s = starts[p];
  const int e = starts[p + 1];
  float zmin = kFar;
  for (int i = s; i < e; ++i) zmin = fminf(zmin, z[i]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float cnt = 0.f;
  for (int i = s; i < e; ++i) {
    if (z[i] == zmin) {
      const float4 v = pay[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
      cnt += 1.f;
    }
  }
  const bool cov = zmin < 1.5f;
  const float inv = cov ? 1.f / fmaxf(cnt, 1.f) : 0.f;
  // GL rows run bottom-up; images top-down: flip the row within the buffer.
  const long long rr = (long long)r * r;
  const long long buf = p / rr;
  const int y = static_cast<int>((p % rr) / r);
  const int x = static_cast<int>(p % r);
  const long long dst = buf * rr + (long long)(r - 1 - y) * r + x;
  const float vals[4] = {acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv};
  for (int c = 0; c < k; ++c) out_pay[dst * k + c] = vals[c];
  out_depth[dst] = cov ? zmin : 1.f;
  covered[dst] = cov ? 1 : 0;
}

}  // namespace

// starts [npix+1] int32, z [N] f32, pay [N, 4] f32 (16-byte aligned), all
// contiguous on the device; out_pay [npix, k] f32, out_depth [npix] f32,
// covered [npix] bool. npix = B r^2, 1 <= k <= 4. Returns cudaGetLastError().
extern "C" int zbuffer_resolve_launch(const void* starts, const void* z, const void* pay,
                                      void* out_pay, void* out_depth, void* covered,
                                      long long npix, int r, int k, void* stream) {
  if (npix < 1 || r < 1 || k < 1 || k > 4 || npix % ((long long)r * r)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((npix + kThreads - 1) / kThreads);
  zbuffer_resolve<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const float*>(z),
      static_cast<const float4*>(pay), static_cast<float*>(out_pay),
      static_cast<float*>(out_depth), static_cast<unsigned char*>(covered), npix, r, k);
  return static_cast<int>(cudaGetLastError());
}
