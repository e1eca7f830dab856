// Z-buffer resolve of pre-binned fragments, one 1024-pixel tile per block,
// for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel bench_micro.py:dense_kernel (:131-158,
// launched at :160), the repository's prototype of the z-buffer resolve over
// fragments binned by tile ahead of time. Same function, not its one-hot
// compare: for each tile t of T, fragments i < F carry a local pixel
// lp[t, i], a depth z[t, i] and a payload pay[t, i, 0:4]; a local pixel
// outside [0, 1024) matches no pixel. Per pixel p of the tile:
//   zbuf[p]   = min(9.0, min of z over the fragments with lp == p)
//   sum_c[p]  = sum of pay[c] over the fragments with lp == p, z <= zbuf[p]
// Output out[t] = [zbuf; sum_0; sum_1; sum_2; sum_3], [T, 5, 1024] f32.
//
// What bounds it on the H100: bytes. It must read each fragment's 24 bytes
// once and write 20 bytes per pixel: at the bench shape (144 tiles x 4,608
// fragments) 18.9 MB, 5.6 us at 3.35 TB/s. The second pass over a tile's
// fragments reads them again from L2 (the 144 tiles' 16 MB fit its 50 MB).
//
// Design: one block per tile keeps the tile's z-buffer and four sums in
// shared memory (20 KB). The fragments of a tile come in no order, so
//  - pass 1 takes the depth minimum by shared-memory atomicMin on the depth's
//    bits mapped to an unsigned key with the float order (any sign; depths
//    are finite), which is exact in any order;
//  - pass 2 adds each winner's payload by shared-memory atomicAdd.
// The other choice, a thread per pixel scanning every fragment of the tile,
// is the TPU kernel's [512, 1024] one-hot compare: 1024 x 4,608 compares per
// tile, a thousand times the work of the atomics, which the TPU's vector
// unit hides and an SM does not. At the bench shape ~4.5 fragments share a
// pixel, so the atomics rarely contend. Their order varies from run to run:
// a pixel with several winners (equal depths) sums them in another order,
// so the sums may differ from the plain version by f32 rounding (1e-5 on
// payloads of order 1); the depth is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 1024;        // pixels per tile
constexpr int kThreads = 1024;
constexpr float kFar = 9.0f;    // clear depth

// Unsigned key with the order of the (finite) float: negative floats flip
// all their bits, the others set the sign bit.
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kThreads)
binned_resolve(const int* __restrict__ lp, const float* __restrict__ z,
               const float4* __restrict__ pay, float* __restrict__ out, int f) {
  __shared__ unsigned zkey[kP];
  __shared__ float acc[4][kP];
  const long long base = (long long)blockIdx.x * f;
  for (int p = threadIdx.x; p < kP; p += kThreads) {
    zkey[p] = ordered_key(kFar);
    acc[0][p] = acc[1][p] = acc[2][p] = acc[3][p] = 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < f; i += kThreads) {
    const int p = lp[base + i];
    if (p >= 0 && p < kP) atomicMin(&zkey[p], ordered_key(z[base + i]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < f; i += kThreads) {
    const int p = lp[base + i];
    if (p >= 0 && p < kP && z[base + i] <= key_value(zkey[p])) {
      const float4 v = pay[base + i];
      atomicAdd(&acc[0][p], v.x);
      atomicAdd(&acc[1][p], v.y);
      atomicAdd(&acc[2][p], v.z);
      atomicAdd(&acc[3][p], v.w);
    }
  }
  __syncthreads();
  float* o = out + (long long)blockIdx.x * 5 * kP;
  for (int p = threadIdx.x; p < kP; p += kThreads) {
    o[p] = key_value(zkey[p]);
    o[kP + p] = acc[0][p];
    o[2 * kP + p] = acc[1][p];
    o[3 * kP + p] = acc[2][p];
    o[4 * kP + p] = acc[3][p];
  }
}

}  // namespace

// lp [tiles, f] int32, z [tiles, f] f32, pay [tiles, f, 4] f32 (16-byte
// aligned), all contiguous on the device; out [tiles, 5, 1024] f32.
// Returns cudaGetLastError().
extern "C" int binned_resolve_launch(const void* lp, const void* z, const void* pay, void* out,
                                     int tiles, int f, void* stream) {
  if (tiles < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  binned_resolve<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lp), static_cast<const float*>(z),
      static_cast<const float4*>(pay), static_cast<float*>(out), f);
  return static_cast<int>(cudaGetLastError());
}
