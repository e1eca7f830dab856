// Z-buffer resolve of pixel-sorted fragments, one 1024-pixel tile per block,
// for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel bench_resolve.py:proto's kernel (:136-184,
// launched at :201), the repository's prototype of the sort-then-compare
// resolve. Same function, over each tile's whole range: fragments sorted by
// pixel key and cut into tiles by ivid_tpu_torch/ops/resolve_variants.py
// (prepare_tiles); tile t owns the fragments [bounds[t], bounds[t+1]), each
// with a local pixel lp (the invalid ones, clamped into the last tile, carry
// lp == 1024 and match nothing), a depth z and a payload pay[0:3]. Per pixel
// p of the tile:
//   zbuf[p]  = min(9.0, min of z over the tile's fragments with lp == p)
//   sum_c[p] = sum of pay[c] over those with z <= zbuf[p], count[p] their number
// Output out[t] = [zbuf; sum_0; sum_1; sum_2; count], [T, 5, 1024] f32.
// The TPU kernel walks a tile in chunks of 512 on a (tile, chunk) grid capped
// at 24 chunks, with the fragment arrays padded by a chunk; this kernel has
// no cap and no padding, and stops at bounds[t+1].
//
// What bounds it on the H100: bytes. It must read the 20 bytes (lp, z,
// payload) of each fragment that falls on a pixel once and write 20 bytes
// per pixel: at the bench shape (733,184 fragments, 144 tiles) 17.6 MB,
// 5.3 us at 3.35 TB/s; on a training step's warp render (8 x 384^2, ~3.65M
// valid fragments) about 97 MB, ~29 us.
//
// Design: one block per tile, one thread per pixel. The tile's fragments are
// sorted by lp, so each pixel's fragments form one run, and those that fall
// on no pixel come last. A binary search cuts those off: the warp render's
// ~0.5M invalid fragments all sit in the last tile, and a pass over them
// kept that one block busy 5x as long as the whole rest of the kernel. A
// block-wide pass over the rest of the range marks where runs start and end
// (a fragment whose neighbour has another lp) in shared memory (8 KB); then
// each thread walks its pixel's run twice, as K3 (zbuffer_resolve.cu) does:
// the depth minimum, then the sums over z <= minimum, in sort order, so the
// result is deterministic. The TPU kernel's [512, 1024] one-hot compare per
// chunk exists for its vector and matrix units; a run walk needs neither. A
// pixel with a long run keeps its one thread busy while the others idle;
// that is the cost of the deterministic sums.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 1024;        // pixels per tile
constexpr int kThreads = 1024;
constexpr float kFar = 9.0f;    // clear depth

__global__ void __launch_bounds__(kThreads)
tile_resolve(const int* __restrict__ bounds, const int* __restrict__ lp,
             const float* __restrict__ z, const float* __restrict__ pay,
             float* __restrict__ out) {
  __shared__ int run_start[kP];
  __shared__ int run_end[kP];
  __shared__ int end_on_pixels;
  const int s = bounds[blockIdx.x];
  if (threadIdx.x == 0) {
    // The range is sorted by lp: the fragments that fall on no pixel of the
    // tile (lp >= 1024) come last. Search where they start.
    int lo = s, hi = bounds[blockIdx.x + 1];
    while (lo < hi) {
      const int mid = lo + (hi - lo) / 2;
      if (lp[mid] < kP) lo = mid + 1; else hi = mid;
    }
    end_on_pixels = lo;
  }
  for (int p = threadIdx.x; p < kP; p += kThreads) {
    run_start[p] = 0;
    run_end[p] = 0;
  }
  __syncthreads();
  const int e = end_on_pixels;
  for (int i = s + threadIdx.x; i < e; i += kThreads) {
    const int p = lp[i];
    if (p < 0) continue;
    if (i == s || lp[i - 1] != p) run_start[p] = i;
    if (i == e - 1 || lp[i + 1] != p) run_end[p] = i + 1;
  }
  __syncthreads();
  float* o = out + (long long)blockIdx.x * 5 * kP;
  for (int p = threadIdx.x; p < kP; p += kThreads) {
    const int rs = run_start[p];
    const int re = run_end[p];
    float zmin = kFar;
    for (int i = rs; i < re; ++i) zmin = fminf(zmin, z[i]);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, cnt = 0.f;
    for (int i = rs; i < re; ++i) {
      if (z[i] <= zmin) {
        const float* v = pay + 3 * (long long)i;
        a0 += v[0];
        a1 += v[1];
        a2 += v[2];
        cnt += 1.f;
      }
    }
    o[p] = zmin;
    o[kP + p] = a0;
    o[2 * kP + p] = a1;
    o[3 * kP + p] = a2;
    o[4 * kP + p] = cnt;
  }
}

}  // namespace

// bounds [tiles + 1] int32 (non-decreasing), lp [N] int32, z [N] f32,
// pay [N, 3] f32, all contiguous on the device, each tile's range sorted by
// lp; out [tiles, 5, 1024] f32. Returns cudaGetLastError().
extern "C" int tile_resolve_launch(const void* bounds, const void* lp, const void* z,
                                   const void* pay, void* out, int tiles, void* stream) {
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  tile_resolve<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bounds), static_cast<const int*>(lp),
      static_cast<const float*>(z), static_cast<const float*>(pay), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
