// Dense triangle raster of stacked meshes for Hopper (sm_90a): K2, a tiled
// rasterizer with per-tile triangle bins.
//
// Replaces the Pallas TPU kernels ivid_tpu/ops/raster_dense.py:
// _dense_kernel_impl/_raster_row (:467, launched by _launch_batched at :809)
// and _dense_kernel (:458, the same body at B=1, launched at :735), together
// with the eager finish _pallas_finish (:924) that follows them. Input: the
// plane columns of ivid_tpu_torch/ops/raster_dense.py (grid_cols/tri_cols),
// stacked triangle-major:
//   geom [B, T, 18] f32  x/y/const coefficients of the planes e0, e1, e2
//                        (edges), z (window depth), D (backface-padding
//                        discard), front
//   pay  [B, T, 3A+4] f32 attr/w planes (a of every channel, then b, then
//                        c), the 1/w plane (a, b, c), front
//   valid [B, T] u8
// Output: the DenseRaster fields over B*r*r pixels in window order (pixel
// b*r*r + y*r + x, centre (x+0.5, y+0.5), row 0 = window bottom): attrs
// [npix, A], depth [npix], front [npix] u8, covered [npix] u8.
//
// The function, per buffer and pixel centre: a valid triangle covers it when
// e0, e1, e2 >= 0, 0 <= z <= 1 and not (front < 0.5 and D > 0), each plane
// evaluated as qx*a + (qy*b + c) with the roundings written out (no FMA
// contraction), as the plain version evaluates it. zbuf is the least covering
// z (9.0 where none covers); the winners are the covering triangles with z ==
// zbuf. Their payloads are summed with their count, averaged, and finished:
// attr = ((qx*s_a + qy*s_b) + s_c) / max((qx*w_a + qy*w_b) + w_c, 1e-12),
// front = 2*frontsum > count, covered = zbuf < 1.5, depth 1.0 and attrs 0
// where nothing covers, with IEEE division.
//
// What bounds it on the H100: the bytes of its inputs and outputs. The
// function needs each valid triangle's 18 + 3A+4 floats once and writes
// 4A + 6 bytes a pixel: ~59 MB for 4 slots of a 130^2 grid at 384^2 (18 us
// at 3.35 TB/s). The plane evaluations it cannot do without, 6 planes of 4
// unfused operations at each pixel a triangle covers, are few: a grid mesh
// covers its slot about once. This kernel evaluates far more, every listed
// triangle at every pixel of the tile, and the frustum skirt's long
// triangles fill the lists.
//
// Design. The TPU kernel is one program per row that tests every pixel of
// the row against all 128 triangles of every chunk whose y-span meets the
// row, as one broadcast FMA: culling in x would gain it nothing, but on an
// SM it makes each pixel of a 384^2 slot test ~1,240 triangles where 1 or 2
// cover it. Here:
// - Bins. Screen tiles of 16x16 pixels. k2_bin_small gives one thread per
//   triangle; in the count call it first copies the triangle's columns into
//   the triangle-major geom and pay rows, through shared memory so that the
//   stores are whole lines. It finds the tiles whose pixel centres the
//   triangle may cover and counts them per tile (atomics), or, for a
//   triangle with more than kSmall candidate tiles (the skirts), appends it
//   to a list that k2_bin_big walks with a warp per triangle, so that one
//   thread never tests hundreds of tiles. torch scans the counts into
//   offsets; the fill call repeats both kernels and writes each triangle's
//   id into its tiles' lists. A list has no cap. The test is conservative for
//   the f32 evaluation above: each edge's constant is moved outward by a
//   bound of that evaluation's rounding error (8 * 2^-24 * (r|a| + r|b| +
//   |c|); the evaluation errs by at most ~4 * 2^-24 of that sum), the tiles
//   come from the box of the moved edges' triangle (vertices in double,
//   padded by a bound of their own rounding), and a tile is dropped only if
//   a moved edge is negative at every pixel centre of it. A box from the
//   corners padded by a pixel would not do: a sliver's edges, moved by their
//   rounding, meet far beyond its corners. When the moved edges bound no
//   triangle the triangle goes to every tile (tested), and when a
//   coefficient could overflow the f32 evaluation, to every tile untested.
//   The double arithmetic is written with explicit roundings, so the torch
//   transcription (bin_tiles_reference) gives the same bins.
// - Raster. k2_raster: one block per (buffer, tile), one thread per pixel. It
//   walks the tile's whole list in batches of 128 triangles whose geometry
//   (72 bytes each) cp.async copies into shared memory, two batches in
//   flight. A thread keeps only zbuf, the winner count and the ids of up to
//   kKeep winners in ascending order; most triangles fail an edge. After the
//   walk it sums the winners' payloads from device memory (L2) in ascending
//   triangle id, four columns at a time, so the sums are the same whatever
//   order the fill's atomics gave the list and two launches give bit-equal
//   results. A tile with a pixel of more than kKeep winners walks its list
//   once more per winner of that pixel, each pass adding the next winner by
//   id. Then the thread finishes its pixel (the tie average and the
//   perspective division) and writes the DenseRaster fields. Nothing else is
//   written: no per-pixel payload sums (164 bytes a pixel in the row
//   kernel), no separate finish, no table sort.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                   // tile side in pixels
constexpr int kThreads = kTile * kTile;     // one thread per pixel of a tile
constexpr int kGeom = 18;                   // geometry floats per triangle
constexpr int kBatch = 128;                 // triangles per staged batch
constexpr int kKeep = 4;                    // winner ids a pixel keeps in registers
constexpr float kFar = 9.0f;                // empty z-buffer value
constexpr double kU = 5.9604644775390625e-08;   // 2^-24, f32 unit roundoff
constexpr double kUd = 1.1102230246251565e-16;  // 2^-53, f64 unit roundoff

// ---- bins ----------------------------------------------------------------

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// A triangle's edges moved outward by their evaluation's error bound, and the
// range of tiles they may cover.
struct Bin {
  double a[3], b[3], c[3];
  int tx0, tx1, ty0, ty1;  // inclusive tile range (empty when tx0 > tx1)
  bool test;               // false: every tile of the range, untested
};

__device__ Bin make_bin(const float* g, int r) {
  Bin s;
  const double R = r;
  const int last = (r + kTile - 1) / kTile - 1;
  bool risky = false;
  for (int k = 0; k < 3; ++k) {
    s.a[k] = g[3 * k];
    s.b[k] = g[3 * k + 1];
    const double c = g[3 * k + 2];
    const double mag = add(mul(R, add(fabs(s.a[k]), fabs(s.b[k]))), fabs(c));
    if (!(mag < 1e37)) risky = true;
    s.c[k] = add(c, add(mul(8.0 * kU, mag), 1e-30));
  }
  s.tx0 = s.ty0 = 0;
  s.tx1 = s.ty1 = last;
  s.test = !risky;
  if (risky) return s;
  // The moved edges bound a triangle iff consecutive inward normals turn the
  // same way (the sign of each cross product is exact: its two products are).
  double det[3], x[3], y[3], ex[3], ey[3];
  for (int k = 0; k < 3; ++k) {
    const int i = k, j = (k + 1) % 3;
    det[k] = sub(mul(s.a[i], s.b[j]), mul(s.a[j], s.b[i]));
  }
  const bool bounded = (det[0] > 0 && det[1] > 0 && det[2] > 0) ||
                       (det[0] < 0 && det[1] < 0 && det[2] < 0);
  if (!bounded) return s;
  double xlo = 0, xhi = 0, ylo = 0, yhi = 0;
  for (int k = 0; k < 3; ++k) {
    const int i = k, j = (k + 1) % 3;
    const double p = mul(s.b[i], s.c[j]), q = mul(s.b[j], s.c[i]);
    const double u = mul(s.a[j], s.c[i]), v = mul(s.a[i], s.c[j]);
    const double inv = __drcp_rn(det[k]);
    x[k] = mul(sub(p, q), inv);
    y[k] = mul(sub(u, v), inv);
    // Bounds of x's and y's rounding: of p, q (or u, v), their difference,
    // det, its reciprocal and the product.
    const double ai = fabs(inv);
    ex[k] = mul(4.0 * kUd, add(mul(add(fabs(p), fabs(q)), ai), fabs(x[k])));
    ey[k] = mul(4.0 * kUd, add(mul(add(fabs(u), fabs(v)), ai), fabs(y[k])));
    const double x0 = sub(x[k], ex[k]), x1 = add(x[k], ex[k]);
    const double y0 = sub(y[k], ey[k]), y1 = add(y[k], ey[k]);
    xlo = k ? fmin(xlo, x0) : x0;
    xhi = k ? fmax(xhi, x1) : x1;
    ylo = k ? fmin(ylo, y0) : y0;
    yhi = k ? fmax(yhi, y1) : y1;
  }
  for (int k = 0; k < 3; ++k) {
    if (!(isfinite(x[k]) && isfinite(y[k]) && isfinite(ex[k]) && isfinite(ey[k]))) return s;
  }
  // Pixel centres x + 0.5 inside [xlo, xhi], clamped to the buffer.
  const double hi = R + 2.0;
  const int px0 = max(0, (int)ceil(sub(fmin(fmax(xlo, -2.0), hi), 0.5)));
  const int px1 = min(r - 1, (int)floor(sub(fmin(fmax(xhi, -2.0), hi), 0.5)));
  const int py0 = max(0, (int)ceil(sub(fmin(fmax(ylo, -2.0), hi), 0.5)));
  const int py1 = min(r - 1, (int)floor(sub(fmin(fmax(yhi, -2.0), hi), 0.5)));
  if (px0 > px1 || py0 > py1) {
    s.tx0 = s.ty0 = 1;
    s.tx1 = s.ty1 = 0;
    return s;
  }
  s.tx0 = px0 / kTile;
  s.tx1 = px1 / kTile;
  s.ty0 = py0 / kTile;
  s.ty1 = py1 / kTile;
  return s;
}

// False only if some moved edge is negative at every pixel centre of tile
// (tx, ty): its largest value there sits at a corner of the centres' box.
__device__ bool may_cover(const Bin& s, int tx, int ty, int r) {
  if (!s.test) return true;
  const double cx0 = tx * kTile + 0.5, cx1 = min(tx * kTile + kTile, r) - 0.5;
  const double cy0 = ty * kTile + 0.5, cy1 = min(ty * kTile + kTile, r) - 0.5;
  for (int k = 0; k < 3; ++k) {
    const double m = add(add(mul(s.a[k], s.a[k] >= 0 ? cx1 : cx0),
                             mul(s.b[k], s.b[k] >= 0 ? cy1 : cy0)), s.c[k]);
    if (m < 0) return false;
  }
  return true;
}

constexpr int kBinThreads = 256;
constexpr int kMaxCols = kGeom + 3 * 11 + 4;  // geometry and payload columns at A = 11
constexpr int kSmall = 8;  // a triangle over more candidate tiles is "big"

struct Columns {
  const float* p[kMaxCols];  // [nbuf * ntri] each: 18 geometry, then npay payload
};

// Count (or, with kFill, list) triangle i in the tiles e = first, first +
// step, ... of its candidate range that it may cover.
template <bool kFill>
__device__ __forceinline__ void emit(const Bin& s, long long i, int first, int step,
                                     int* __restrict__ counts, const int* __restrict__ offsets,
                                     int* __restrict__ ids, int nids, int ntri, int r) {
  const int nt = (r + kTile - 1) / kTile;
  const int nx = s.tx1 - s.tx0 + 1, ny = s.ty1 - s.ty0 + 1;
  if (nx <= 0 || ny <= 0) return;
  const int b = (int)(i / ntri);
  for (int e = first; e < nx * ny; e += step) {
    const int ty = s.ty0 + e / nx, tx = s.tx0 + e % nx;
    if (!may_cover(s, tx, ty, r)) continue;
    const int blk = (b * nt + ty) * nt + tx;
    if (kFill) {
      const int at = offsets[blk] + atomicAdd(counts + blk, 1);
      if (at < nids) ids[at] = (int)(i - (long long)b * ntri);
    } else {
      atomicAdd(counts + blk, 1);
    }
  }
}

__device__ __forceinline__ int range_size(const Bin& s) {
  return max(s.tx1 - s.tx0 + 1, 0) * max(s.ty1 - s.ty0 + 1, 0);
}

// One thread per triangle. The count pass first copies the triangle's
// columns into the triangle-major geom and pay, and appends the triangles
// with more than kSmall candidate tiles to `big`; the others are counted (or
// listed) here, the big ones by k2_bin_big.
template <bool kFill>
__global__ void __launch_bounds__(kBinThreads)
k2_bin_small(Columns cols, int npay, const uint8_t* __restrict__ valid, float* __restrict__ geom,
             float* __restrict__ pay, int* __restrict__ counts, const int* __restrict__ offsets,
             int* __restrict__ ids, int nids, int* __restrict__ big, int* __restrict__ nbig,
             int nbuf, int ntri, int r) {
  const long long base = (long long)blockIdx.x * kBinThreads;
  const long long i = base + threadIdx.x;
  const long long n = (long long)nbuf * ntri;
  const bool here = i < n;
  const bool live = here && valid[i];
  float g[kGeom];
  Bin s;
  if (kFill) {
    if (!live) return;
#pragma unroll
    for (int c = 0; c < 9; ++c) g[c] = geom[i * kGeom + c];
    s = make_bin(g, r);
  } else {
    // The columns (unrolled, so every column pointer is a constant-bank load).
#pragma unroll
    for (int c = 0; c < kGeom; ++c) g[c] = here ? cols.p[c][i] : 0.f;
    if (live) s = make_bin(g, r);
    // The block's rows of geom, then of pay, go through shared memory so
    // that the stores to device memory are whole lines.
    __shared__ float rows[kBinThreads * (kMaxCols - kGeom)];
    const int m = n - base < kBinThreads ? (int)(n - base) : kBinThreads;
#pragma unroll
    for (int c = 0; c < kGeom; ++c) rows[threadIdx.x * kGeom + c] = g[c];
    __syncthreads();
    for (int e = threadIdx.x; e < m * kGeom; e += kBinThreads) geom[base * kGeom + e] = rows[e];
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kMaxCols - kGeom; ++c)
      if (c < npay) rows[threadIdx.x * npay + c] = here ? cols.p[kGeom + c][i] : 0.f;
    __syncthreads();
    for (int e = threadIdx.x; e < m * npay; e += kBinThreads) pay[base * npay + e] = rows[e];
    if (!live) return;
  }
  if (range_size(s) <= kSmall) {
    emit<kFill>(s, i, 0, 1, counts, offsets, ids, nids, ntri, r);
  } else if (!kFill) {
    big[atomicAdd(nbig, 1)] = (int)i;
  }
}

// One warp per big triangle (all lanes make its Bin), its candidate tiles
// split among the lanes, the warps striding over the list of big triangles.
template <bool kFill>
__global__ void __launch_bounds__(kBinThreads)
k2_bin_big(const float* __restrict__ geom, int* __restrict__ counts,
           const int* __restrict__ offsets, int* __restrict__ ids, int nids,
           const int* __restrict__ big, const int* __restrict__ nbig, int ntri, int r) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (kBinThreads / 32);
  const int n = *nbig;
  for (int j = (blockIdx.x * kBinThreads + threadIdx.x) / 32; j < n; j += warps) {
    const long long i = big[j];
    const Bin s = make_bin(geom + i * kGeom, r);
    emit<kFill>(s, i, lane, 32, counts, offsets, ids, nids, ntri, r);
  }
}

// ---- raster --------------------------------------------------------------

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Stage {
  float g[2][kBatch * kGeom];
  int id[2][kBatch];
};

// Start copying batch k0.. of the tile's list into stage buffer `buf`.
__device__ __forceinline__ void load_batch(Stage& st, int buf, const float* gb, const int* lst,
                                           int k0, int n) {
  const int m = min(kBatch, n - k0);
  for (int e = threadIdx.x; e < m * (kGeom / 2); e += kThreads) {
    const int t = e / (kGeom / 2);
    const int part = e - t * (kGeom / 2);
    cp_async8(&st.g[buf][t * kGeom + 2 * part], gb + (long long)lst[k0 + t] * kGeom + 2 * part);
  }
  for (int e = threadIdx.x; e < m; e += kThreads) st.id[buf][e] = lst[k0 + e];
  cp_async_commit();
}

// Call f(id, geometry) for every triangle of the list, in list order, every
// thread of the block over the same triangles.
template <class F>
__device__ __forceinline__ void walk(Stage& st, const float* gb, const int* lst, int n, F&& f) {
  const int nb = (n + kBatch - 1) / kBatch;
  if (nb == 0) return;
  load_batch(st, 0, gb, lst, 0, n);
  for (int j = 0; j < nb; ++j) {
    if (j + 1 < nb) {
      load_batch(st, (j + 1) & 1, gb, lst, (j + 1) * kBatch, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m = min(kBatch, n - j * kBatch);
    const float* g = st.g[j & 1];
    const int* id = st.id[j & 1];
    for (int i = 0; i < m; ++i) f(id[i], g + i * kGeom);
    __syncthreads();
  }
}

// A plane at the pixel centre, rounded as the plain version: qx*a + (qy*b + c).
__device__ __forceinline__ float plane(float a, float b, float c, float qx, float qy) {
  return __fadd_rn(__fmul_rn(qx, a), __fadd_rn(__fmul_rn(qy, b), c));
}

// The covering test of a staged geometry row at the pixel centre, its depth
// in *z: e0, e1, e2, then z, then the discard (front and D); most triangles
// fail at e0.
__device__ __forceinline__ bool covers(const float* g, float qx, float qy, float* z) {
  if (!(plane(g[0], g[1], g[2], qx, qy) >= 0.f)) return false;
  if (!(plane(g[3], g[4], g[5], qx, qy) >= 0.f)) return false;
  if (!(plane(g[6], g[7], g[8], qx, qy) >= 0.f)) return false;
  *z = plane(g[9], g[10], g[11], qx, qy);
  if (!(*z >= 0.f && *z <= 1.f)) return false;
  return !(plane(g[15], g[16], g[17], qx, qy) < 0.5f && plane(g[12], g[13], g[14], qx, qy) > 0.f);
}

template <int A>
__global__ void __launch_bounds__(kThreads)
k2_raster(const float* __restrict__ geom, const float* __restrict__ pay,
          const int* __restrict__ offsets, const int* __restrict__ ids, int nids,
          float* __restrict__ attrs, float* __restrict__ depth, uint8_t* __restrict__ front,
          uint8_t* __restrict__ covered, int ntri, int r) {
  constexpr int NP = 3 * A + 4;
  __shared__ __align__(16) Stage st;
  __shared__ int most_tied;
  const int nt = (r + kTile - 1) / kTile;
  const int blk = blockIdx.x;
  const int b = blk / (nt * nt);
  const int tile = blk - b * nt * nt;
  const int px = (tile % nt) * kTile + threadIdx.x % kTile;
  const int py = (tile / nt) * kTile + threadIdx.x / kTile;
  const bool inside = px < r && py < r;
  const float qx = px + 0.5f, qy = py + 0.5f;
  // The tile's list, cut at the end of ids (a list longer than ids was
  // given room for loses its tail, and nothing is read past ids).
  const int end = min(offsets[blk + 1], nids);
  const int begin = min(offsets[blk], end);
  const int n = end - begin;
  const float* gb = geom + (long long)b * ntri * kGeom;
  const float* pb = pay + (long long)b * ntri * NP;
  const int* lst = ids + begin;

  // Depth-only walk. The ids of the winners at zbuf are kept in ascending
  // order, up to kKeep of them (the others are counted).
  float zbuf = kFar;
  int cnt = 0;
  int win[kKeep];
#pragma unroll
  for (int k = 0; k < kKeep; ++k) win[k] = INT_MAX;
  walk(st, gb, lst, n, [&](int id, const float* g) {
    float z;
    if (!inside || !covers(g, qx, qy, &z)) return;
    if (z < zbuf) {
      zbuf = z;
      cnt = 1;
      win[0] = id;
#pragma unroll
      for (int k = 1; k < kKeep; ++k) win[k] = INT_MAX;
    } else if (z == zbuf) {
      ++cnt;
      int v = id;
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        const int lo = min(v, win[k]);
        v = max(v, win[k]);
        win[k] = lo;
      }
    }
  });

  // Sums of payload columns over the winners, in ascending triangle id, up
  // to four columns at a time (no thread holds all 3A+4): from the kept ids,
  // or, in a tile where a pixel has more than kKeep winners, by one more
  // walk per winner of its most tied such pixel, each adding the next
  // winner by id. Every thread of the block calls it alike.
  const bool overflow = __syncthreads_or(cnt > kKeep);
  int passes = 0;
  if (overflow) {
    if (threadIdx.x == 0) most_tied = 0;
    __syncthreads();
    if (cnt > kKeep) atomicMax(&most_tied, cnt);
    __syncthreads();
    passes = most_tied;
  }
  auto sums = [&](int c0, int c1, int c2, int c3, float(&v)[4]) {
    const int col[4] = {c0, c1, c2, c3};
    auto add = [&](int id) {
      const float* pw = pb + (long long)id * NP;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col[k] >= 0) v[k] = __fadd_rn(v[k], pw[col[k]]);
    };
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = 0.f;
#pragma unroll
    for (int w = 0; w < kKeep; ++w)
      if (w < cnt && cnt <= kKeep) add(win[w]);
    int last = -1;
    for (int p = 0; p < passes; ++p) {
      const bool live = cnt > kKeep && p < cnt;
      int next = INT_MAX;
      walk(st, gb, lst, n, [&](int id, const float* g) {
        float z;
        if (!live || id <= last || id >= next || !covers(g, qx, qy, &z)) return;
        if (z == zbuf) next = id;
      });
      if (live) {
        add(next);
        last = next;
      }
    }
  };

  // Finish, as the plain version's finish: the tie average acc / max(cnt, 1)
  // (x / 1 is x, so a lone winner needs no division), then the perspective
  // division.
  const float cntf = static_cast<float>(cnt);
  const bool cov = zbuf < 1.5f;
  const long long pix = ((long long)b * r + py) * r + px;
  float d[4];
  sums(3 * A, 3 * A + 1, 3 * A + 2, 3 * A + 3, d);  // the 1/w plane, front
  if (cnt > 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = __fdiv_rn(d[k], cntf);
  }
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(qx, d[0]), __fmul_rn(qy, d[1])), d[2]);
  const float den_c = den < 1e-12f ? 1e-12f : den;  // keeps a NaN, as torch.clamp
  for (int i = 0; i < A; ++i) {
    float v[4];
    sums(i, A + i, 2 * A + i, -1, v);
    if (cnt > 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = __fdiv_rn(v[k], cntf);
    }
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(qx, v[0]), __fmul_rn(qy, v[1])), v[2]);
    if (inside) attrs[pix * A + i] = cov ? __fdiv_rn(num, den_c) : 0.f;
  }
  if (!inside) return;
  depth[pix] = cov ? zbuf : 1.0f;
  front[pix] = cov && __fmul_rn(d[3], 2.f) > cntf;
  covered[pix] = cov;
}

template <int A>
void launch_raster(int blocks, cudaStream_t s, const void* geom, const void* pay,
                   const void* offsets, const void* ids, int nids, void* attrs, void* depth,
                   void* front, void* covered, int ntri, int r) {
  k2_raster<A><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(geom), static_cast<const float*>(pay),
      static_cast<const int*>(offsets), static_cast<const int*>(ids), nids,
      static_cast<float*>(attrs),
      static_cast<float*>(depth), static_cast<uint8_t*>(front), static_cast<uint8_t*>(covered),
      ntri, r);
}

int bad_shape(int nbuf, int ntri, int r) {
  return nbuf < 1 || ntri < 1 || r < 1 || (long long)nbuf * r * r >= (1LL << 31);
}

}  // namespace

// The bins, in two calls. cols: host array of 18 + npay pointers to the
// plane columns, [nbuf * ntri] f32 each (18 geometry, then npay payload);
// valid [nbuf * ntri] u8; geom [nbuf, ntri, 18] and pay [nbuf, ntri, npay]
// f32 receive the columns triangle-major in the count call and are read by
// the fill call; big [nbuf * ntri] int32 and nbig [1] int32 (zeroed before
// the count call) receive the triangles with many candidate tiles in the
// count call. Count (fill = 0): counts [nbuf * nt * nt] int32, zeroed, nt =
// ceil(r / 16), receives the per-tile counts. Fill (fill = 1): offsets
// [nbuf * nt * nt + 1] int32 is their exclusive scan, counts a zeroed
// cursor, and ids [nids] int32 receives each tile's triangle ids (local to
// the buffer, in no set order; no entry at or past nids is written, so nids
// below offsets[-1] cuts lists short). Returns cudaGetLastError().
extern "C" int dense_raster_bins(const void* const* cols, int npay, const void* valid, void* geom,
                                 void* pay, void* counts, const void* offsets, void* ids,
                                 int nids, void* big, void* nbig, int nbuf, int ntri, int r,
                                 int fill, void* stream) {
  if (bad_shape(nbuf, ntri, r) || npay < 7 || kGeom + npay > kMaxCols || nids < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Columns c{};
  for (int k = 0; k < kGeom + npay; ++k) c.p[k] = static_cast<const float*>(cols[k]);
  const long long n = (long long)nbuf * ntri;
  const unsigned blocks = (unsigned)((n + kBinThreads - 1) / kBinThreads);
  const unsigned big_blocks = blocks < 1024u ? blocks : 1024u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto small = fill ? k2_bin_small<true> : k2_bin_small<false>;
  small<<<blocks, kBinThreads, 0, s>>>(
      c, npay, static_cast<const uint8_t*>(valid), static_cast<float*>(geom),
      static_cast<float*>(pay), static_cast<int*>(counts), static_cast<const int*>(offsets),
      static_cast<int*>(ids), nids, static_cast<int*>(big), static_cast<int*>(nbig), nbuf, ntri,
      r);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto large = fill ? k2_bin_big<true> : k2_bin_big<false>;
  large<<<big_blocks, kBinThreads, 0, s>>>(
      static_cast<const float*>(geom), static_cast<int*>(counts), static_cast<const int*>(offsets),
      static_cast<int*>(ids), nids, static_cast<const int*>(big), static_cast<const int*>(nbig),
      ntri, r);
  return static_cast<int>(cudaGetLastError());
}

// The raster over the bins: geom [nbuf, ntri, 18], pay [nbuf, ntri, 3A+4]
// f32, offsets and ids [nids] from the two calls above (no entry of ids at or
// past nids is read); writes attrs [npix, A] f32, depth [npix] f32, front and
// covered [npix] u8, npix = nbuf * r * r. 1 <= A <= 11. Returns
// cudaGetLastError().
extern "C" int dense_raster_tiles(const void* geom, const void* pay, const void* offsets,
                                  const void* ids, int nids, void* attrs, void* depth, void* front,
                                  void* covered, int nbuf, int ntri, int r, int A, void* stream) {
  if (bad_shape(nbuf, ntri, r) || nids < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (r + kTile - 1) / kTile;
  const int blocks = nbuf * nt * nt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_CASE(a) \
  case a: launch_raster<a>(blocks, s, geom, pay, offsets, ids, nids, attrs, depth, front, covered, ntri, r); break;
  switch (A) {
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4) K2_CASE(5) K2_CASE(6)
    K2_CASE(7) K2_CASE(8) K2_CASE(9) K2_CASE(10) K2_CASE(11)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K2_CASE
  return static_cast<int>(cudaGetLastError());
}
