// Per-row dense triangle raster of stacked grid meshes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ivid_tpu/ops/raster_dense.py:
// _dense_kernel_impl/_raster_row (launched by _launch_batched from
// rasterize_grid_dense_batched). It consumes the same five tables, built by the
// port of _grid_cols_t + _prep_pack (ivid_tpu_torch/ops/raster_dense.py):
//   lohi  [2, B*r]  int32  per-row y-band chunk range [lo, hi) (local chunk ids)
//   spans [2, B*nc] int32  per-chunk integer window-y span [ymin, ymax]
//   glob  [2, B]    int32  per-buffer chunk range of the tall (>32 px) triangles
//   geom  [B*nc*8, 6*128]  f32: per chunk, rows 0-2 = x/y/const coefficients of
//                          the planes e0, e1, e2, z, D (backface-padding
//                          discard), front; 128 triangles per plane on columns
//   pay   [B*nc*PWP, 128]  f32: per chunk, PWP payload planes (attr/w a/b/c,
//                          1/w a/b/c, front, ones) on rows, triangles on columns
// and writes out [B*r, r, 1+PWP]: column 0 the winning window z (9.0 where
// nothing covers), columns 1.. the payload planes summed over the equal-depth
// winners, which the torch finish averages and evaluates.
//
// Per pixel centre (x+0.5, y+0.5) and triangle it evaluates the six planes;
// coverage is: all edges >= 0, 0 <= z <= 1, and not (back-facing and D > 0).
// Depth test is GL '<'; equal depths add (tie sums).
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores. Each pixel
// evaluates 6 planes (2 multiplies + 2 adds each) against every triangle of
// its row's chunks, and each visited chunk's 18x128 geometry and PWP x128
// payload floats (~30 KB at PWP=40) are staged into shared memory. A 130^2
// grid mesh with its frustum skirt seen at r=384 gives each row ~4 band
// chunks plus ~9 chunks of tall skirt triangles: ~15 MFLOP per row, ~6
// GFLOP per slot, against 67 TFLOP/s of f32 (so a slot costs ~0.1 ms at
// peak). The design keeps that arithmetic in registers and shared memory;
// device memory carries only the tables and the output.
//
// Design:
// - One block per (buffer, row), one thread per pixel of the row. The TPU
//   kernel's sequential grid becomes independent blocks; nothing carries over.
// - A per-buffer table (6.4 MB geom + 5.3 MB payload at 130^2) is far beyond
//   the 227 KB of shared memory a block can hold, so chunks stream: for each
//   chunk of the row's band range, then of the global range, the block skips
//   it by its y-span, else stages it in shared memory and every thread walks
//   its 128 triangles, keeping the z-buffer value and the PWP tie sums in
//   registers (strictly nearer: reset to the triangle's payload; equal: add).
// - Each chunk is visited once per row: a chunk that is in both the band and
//   the global range (the TPU kernel may visit it twice, its tie average then
//   cancels the double count) is skipped in the global pass.
// - PWP is a template parameter so the tie sums stay in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kTC = 128;      // triangles per chunk
constexpr int kPlanes = 6;    // e0, e1, e2, z, D, front
constexpr float kFar = 9.0f;  // empty z-buffer value (valid window z in [0, 1])

template <int PWP>
__global__ void dense_raster_rows(const int* __restrict__ lohi,
                                  const int* __restrict__ spans,
                                  const int* __restrict__ glob,
                                  const float* __restrict__ geom,
                                  const float* __restrict__ pay,
                                  float* __restrict__ out, int nbuf, int r,
                                  int nc) {
  __shared__ float g_s[kPlanes * 3 * kTC];  // [plane][coef][tri]
  __shared__ float p_s[PWP * kTC];          // [payload plane][tri]

  const int t = blockIdx.x;  // global row id b*r + y
  const int b = t / r;
  const int ty = t - b * r;
  const int x = threadIdx.x;
  const float qx = x + 0.5f;
  const float qy = ty + 0.5f;

  float zbuf = kFar;
  float acc[PWP];
#pragma unroll
  for (int p = 0; p < PWP; ++p) acc[p] = 0.f;

  const int lo = lohi[t];
  const int hi = lohi[nbuf * r + t];
  const int glo = glob[b];
  const int ghi = glob[nbuf + b];
  const int n_band = max(hi - lo, 0);
  const int n_glob = max(ghi - glo, 0);

  for (int it = 0; it < n_band + n_glob; ++it) {
    int c;
    if (it < n_band) {
      c = lo + it;
    } else {
      c = glo + (it - n_band);
      if (c >= lo && c < hi) continue;  // already visited in the band pass
    }
    const int sp = b * nc + c;
    if (!(spans[sp] <= ty && spans[nbuf * nc + sp] >= ty)) continue;

    __syncthreads();  // all threads are done with the previous chunk
    const float* gsrc = geom + (long long)sp * 8 * kPlanes * kTC;
    for (int e = x; e < 3 * kPlanes * kTC; e += blockDim.x) {
      const int k = e / (kPlanes * kTC);   // coefficient row 0..2
      const int rem = e - k * kPlanes * kTC;
      const int plane = rem / kTC;
      const int tri = rem - plane * kTC;
      g_s[(plane * 3 + k) * kTC + tri] = gsrc[e];
    }
    const float* psrc = pay + (long long)sp * PWP * kTC;
    for (int e = x; e < PWP * kTC; e += blockDim.x) p_s[e] = psrc[e];
    __syncthreads();

    if (x < r) {
      for (int i = 0; i < kTC; ++i) {
        float v[kPlanes];
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          const float* gp = g_s + pl * 3 * kTC + i;
          // Explicit roundings (no FMA contraction): the same arithmetic
          // as the plain version, so edge and depth ties resolve alike.
          v[pl] = __fadd_rn(__fmul_rn(qx, gp[0]),
                            __fadd_rn(__fmul_rn(qy, gp[kTC]), gp[2 * kTC]));
        }
        const bool ok = v[0] >= 0.f && v[1] >= 0.f && v[2] >= 0.f &&
                        v[3] >= 0.f && v[3] <= 1.f &&
                        !(v[5] < 0.5f && v[4] > 0.f);
        if (ok) {
          const float z = v[3];
          if (z < zbuf) {
            zbuf = z;
#pragma unroll
            for (int p = 0; p < PWP; ++p) acc[p] = p_s[p * kTC + i];
          } else if (z == zbuf) {
#pragma unroll
            for (int p = 0; p < PWP; ++p) acc[p] += p_s[p * kTC + i];
          }
        }
      }
    }
  }

  if (x < r) {
    float* dst = out + ((long long)t * r + x) * (1 + PWP);
    dst[0] = zbuf;
#pragma unroll
    for (int p = 0; p < PWP; ++p) dst[1 + p] = acc[p];
  }
}

template <int PWP>
void launch(const void* lohi, const void* spans, const void* glob,
            const void* geom, const void* pay, void* out, int nbuf, int r,
            int nc, cudaStream_t s) {
  const int threads = ((r + 31) / 32) * 32;
  dense_raster_rows<PWP><<<nbuf * r, threads, 0, s>>>(
      static_cast<const int*>(lohi), static_cast<const int*>(spans),
      static_cast<const int*>(glob), static_cast<const float*>(geom),
      static_cast<const float*>(pay), static_cast<float*>(out), nbuf, r, nc);
}

}  // namespace

// Tables as described above, contiguous; r <= 1024; pwp one of 16/24/32/40.
// Returns cudaGetLastError() after the launch.
extern "C" int dense_raster_rows_launch(const void* lohi, const void* spans,
                                        const void* glob, const void* geom,
                                        const void* pay, void* out, int nbuf,
                                        int r, int nc, int pwp, void* stream) {
  if (r < 1 || r > 1024 || nbuf < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pwp) {
    case 16: launch<16>(lohi, spans, glob, geom, pay, out, nbuf, r, nc, s); break;
    case 24: launch<24>(lohi, spans, glob, geom, pay, out, nbuf, r, nc, s); break;
    case 32: launch<32>(lohi, spans, glob, geom, pay, out, nbuf, r, nc, s); break;
    case 40: launch<40>(lohi, spans, glob, geom, pay, out, nbuf, r, nc, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
