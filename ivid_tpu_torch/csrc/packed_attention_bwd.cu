// Packed-qkv multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the backward the JAX package runs for its packed attention
// (ivid_tpu/ops/attention.py:_packed_bwd, which calls the Pallas flash VJP of
// jax.experimental.pallas.ops.tpu.flash_attention on the unpacked layout). It
// reads the forward's inputs and outputs in the packed layout: qkv
// [B, T, 3C] with head-major [h][q|k|v][64] columns, out and dout [B, T, C]
// token-major, and the per-row log-sum-exp lse [B, H, T] that the forward
// kernel (csrc/packed_attention.cu) wrote. It writes dqkv [B, T, 3C] in the
// input type; every sum is taken in f32.
//
// With s = scale, q' = q s, k' = k s, P = softmax(q' k'^T) and
// D = rowsum(dO o O):
//   dV = P^T dO,  dS = P o (dO V^T - D),  dQ = s^2 dS K,  dK = s^2 dS^T Q.
// P is rebuilt per 64x64 tile as exp2(q.k * scale^2 log2(e) - lse log2(e)).
//
// What bounds it on the H100: operations. Per (sample, head) the backward
// does five T x T x 64 products (S twice, dP twice, dV, dK, dQ less the two
// it shares): 10 B H T^2 D flops counted the usual way, 21.5 GFLOP at the
// training shape [8, 1024, 768] with 4 heads, against 989 TFLOP/s bf16
// (21.7 us). Its operands are 50 MB.
//
// Design (a first version: right, simple, no atomics):
// - delta kernel: D per row, one warp per (token, head).
// - dK/dV kernel: one block per (sample, head, 64-key tile), 4 warps of 16
//   keys. The block walks all query tiles; per tile each warp computes
//   S^T = K Q^T and dP^T = V dO^T for its keys, forms P^T and dS^T in shared
//   memory, and accumulates dV += P^T dO and dK += dS^T Q in wmma
//   accumulator fragments that stay in registers for the whole walk.
// - dQ kernel: one block per (sample, head, 64-query tile), the mirror image:
//   S = Q K^T and dP = dO V^T per key tile, dQ += dS K in registers.
// - bf16 runs the products on the tensor cores (wmma 16x16x16, f32
//   accumulation), with P and dS rounded to bf16 as their operands; f32 runs
//   exact FMAs on the CUDA cores, two threads per row holding half of the 64
//   dims each (the layout of the forward's f32 path), with the staged tiles
//   interleaved so the pair reads neighbouring banks.
// - The dQ kernel recomputes S and dP that the dK/dV kernel also computed:
//   two of the seven products are done twice, which avoids atomics on dQ.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head width
constexpr int kTile = 64;     // queries or keys per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kWarps;  // 16 rows per warp
constexpr int kHalf = kD / 2;
constexpr int kLdh = kD + 8;           // bf16 tile row stride (elements)
constexpr int kLdf = kD + 4;           // f32 tile row stride (elements)
constexpr int kTileH = kTile * kLdh;
constexpr int kWarpH = kRows * kLdh;
constexpr int kWarpF = kRows * kLdf;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 kernels: four 64-row bf16 tiles, the tile's lse
// and D, and per warp two f32 and two bf16 16-row panels.
constexpr size_t kSmemBf16 = sizeof(bf16) * (4 * kTileH + kWarps * 2 * kWarpH) +
                             sizeof(float) * (2 * kTile + kWarps * 2 * kWarpF);

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// D[b, h, t] = sum_d dout[b, t, h*64+d] * out[b, t, h*64+d]; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
               int batch, int seq, int heads) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;  // (b*seq+t)*heads+h
  const int lane = threadIdx.x % 32;
  if (row >= (long long)batch * seq * heads) return;
  const T* o = out + row * kD;
  const T* g = dout + row * kD;
  float acc = to_f(o[lane]) * to_f(g[lane]) + to_f(o[lane + 32]) * to_f(g[lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % heads;
    const long long bt = row / heads;
    const int t = bt % seq;
    const int b = bt / seq;
    delta[((long long)b * heads + h) * seq + t] = acc;
  }
}

// Copy 64 rows x 64 bf16 from rows row0.. of a row-major source with row
// stride `ld` (elements) into a [64][kLdh] tile; rows past `seq` are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int row0,
                                          int seq) {
  for (int e = threadIdx.x; e < kTile * (kD / 8); e += kThreads) {
    const int r = e / (kD / 8);
    const int c = (e % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq) v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = v;
  }
}

// Per-row lse (in base-2 units) and D of a 64-row tile; rows past `seq` get
// lse = +inf, so their P is exactly 0.
__device__ __forceinline__ void load_rowstats(float* lse_s, float* dl_s, const float* lse,
                                              const float* delta, int row0, int seq) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool ok = row0 + i < seq;
    lse_s[i] = ok ? lse[row0 + i] * kLog2e : INFINITY;
    dl_s[i] = ok ? delta[row0 + i] : 0.f;
  }
}

// Write a warp's 16 x 64 f32 panel (row stride kLdf) as bf16 rows of dqkv.
__device__ __forceinline__ void store_rows_bf16(const float* panel, bf16* dst_base, long long ld,
                                                int row0, int seq, float mul) {
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  if (row0 + r >= seq) return;
  const float* src = panel + r * kLdf + half * kHalf;
  bf16* dst = dst_base + (long long)(row0 + r) * ld + half * kHalf;
#pragma unroll
  for (int j = 0; j < kHalf; j += 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(src[j] * mul, src[j + 1] * mul);
  }
}

// ----------------------------------------------------------------- bf16 dK/dV
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dqkv, int seq, int heads, float qscale, float gscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTileH;
  bf16* q_s = v_s + kTileH;
  bf16* do_s = q_s + kTileH;
  bf16* pt_s = do_s + kTileH;            // per warp [16][kLdh]: P^T
  bf16* dst_s = pt_s + kWarps * kWarpH;  // per warp [16][kLdh]: dS^T
  float* st_s = reinterpret_cast<float*>(dst_s + kWarps * kWarpH);  // per warp S^T
  float* dpt_s = st_s + kWarps * kWarpF;                             // per warp dP^T
  float* lse_s = dpt_s + kWarps * kWarpF;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c3 = 3LL * heads * kD;
  const long long c1 = (long long)heads * kD;
  const bf16* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  const bf16* gbase = dout + (long long)b * seq * c1 + (long long)h * kD;
  const float* lse_bh = lse + ((long long)b * heads + h) * seq;
  const float* dl_bh = delta + ((long long)b * heads + h) * seq;
  bf16* pt_w = pt_s + warp * kWarpH;
  bf16* dst_w = dst_s + warp * kWarpH;
  float* st_w = st_s + warp * kWarpF;
  float* dpt_w = dpt_s + warp * kWarpF;

  load_tile(k_s, base + kD, c3, k0, seq);
  load_tile(v_s, base + 2 * kD, c3, k0, seq);

  FragC dk[kD / 16], dv[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  const int r = lane >> 1;  // elementwise lanes: key row r, query columns half*32..
  const int half = lane & 1;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(q_s, base, c3, q0, seq);
    load_tile(do_s, gbase, c1, q0, seq);
    load_rowstats(lse_s, dl_s, lse_bh, dl_bh, q0, seq);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries.
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      FragC s_acc, dp_acc;
      wmma::fill_fragment(s_acc, 0.f);
      wmma::fill_fragment(dp_acc, 0.f);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k) {
        FragA a;
        FragBc bq;
        wmma::load_matrix_sync(a, k_s + warp * kWarpH + k * 16, kLdh);
        wmma::load_matrix_sync(bq, q_s + n * 16 * kLdh + k * 16, kLdh);
        wmma::mma_sync(s_acc, a, bq, s_acc);
        wmma::load_matrix_sync(a, v_s + warp * kWarpH + k * 16, kLdh);
        wmma::load_matrix_sync(bq, do_s + n * 16 * kLdh + k * 16, kLdh);
        wmma::mma_sync(dp_acc, a, bq, dp_acc);
      }
      wmma::store_matrix_sync(st_w + n * 16, s_acc, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(dpt_w + n * 16, dp_acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    // P^T = exp2(S^T qscale - lse2[q]); dS^T = P^T o (dP^T - D[q]).
#pragma unroll 8
    for (int j = 0; j < kHalf; ++j) {
      const int col = half * kHalf + j;
      const float p = exp2f(st_w[r * kLdf + col] * qscale - lse_s[col]);
      const float ds = p * (dpt_w[r * kLdf + col] - dl_s[col]);
      pt_w[r * kLdh + col] = __float2bfloat16(p);
      dst_w[r * kLdh + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q.
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
      for (int k = 0; k < kTile / 16; ++k) {
        FragA a;
        FragBr bm;
        wmma::load_matrix_sync(a, pt_w + k * 16, kLdh);
        wmma::load_matrix_sync(bm, do_s + k * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dv[n], a, bm, dv[n]);
        wmma::load_matrix_sync(a, dst_w + k * 16, kLdh);
        wmma::load_matrix_sync(bm, q_s + k * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dk[n], a, bm, dk[n]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(st_w + n * 16, dk[n], kLdf, wmma::mem_row_major);
    wmma::store_matrix_sync(dpt_w + n * 16, dv[n], kLdf, wmma::mem_row_major);
  }
  __syncwarp();
  bf16* obase = dqkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  store_rows_bf16(st_w, obase + kD, c3, k0 + warp * kRows, seq, gscale);
  store_rows_bf16(dpt_w, obase + 2 * kD, c3, k0 + warp * kRows, seq, 1.f);
}

// ------------------------------------------------------------------- bf16 dQ
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dqkv, int seq, int heads, float qscale, float gscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kTileH;
  bf16* k_s = do_s + kTileH;
  bf16* v_s = k_s + kTileH;
  bf16* ds_s = v_s + kTileH;                                        // per warp [16][kLdh]: dS
  float* s_s = reinterpret_cast<float*>(ds_s + kWarps * 2 * kWarpH);  // per warp S
  float* dp_s = s_s + kWarps * kWarpF;                                // per warp dP
  float* lse_s = dp_s + kWarps * kWarpF;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c3 = 3LL * heads * kD;
  const long long c1 = (long long)heads * kD;
  const bf16* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  const bf16* gbase = dout + (long long)b * seq * c1 + (long long)h * kD;
  bf16* ds_w = ds_s + warp * kWarpH;
  float* s_w = s_s + warp * kWarpF;
  float* dp_w = dp_s + warp * kWarpF;

  load_tile(q_s, base, c3, q0, seq);
  load_tile(do_s, gbase, c1, q0, seq);
  load_rowstats(lse_s, dl_s, lse + ((long long)b * heads + h) * seq,
                delta + ((long long)b * heads + h) * seq, q0, seq);
  __syncthreads();
  FragA qf[kD / 16], gf[kD / 16];
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) {
    wmma::load_matrix_sync(qf[k], q_s + warp * kWarpH + k * 16, kLdh);
    wmma::load_matrix_sync(gf[k], do_s + warp * kWarpH + k * 16, kLdh);
  }
  FragC dq[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(dq[n], 0.f);

  const int r = lane >> 1;  // elementwise lanes: query row r, key columns half*32..
  const int half = lane & 1;
  const float lse2 = lse_s[warp * kRows + r];
  const float drow = dl_s[warp * kRows + r];

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(k_s, base + kD, c3, k0, seq);
    load_tile(v_s, base + 2 * kD, c3, k0, seq);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      FragC s_acc, dp_acc;
      wmma::fill_fragment(s_acc, 0.f);
      wmma::fill_fragment(dp_acc, 0.f);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k) {
        FragBc bk;
        wmma::load_matrix_sync(bk, k_s + n * 16 * kLdh + k * 16, kLdh);
        wmma::mma_sync(s_acc, qf[k], bk, s_acc);
        wmma::load_matrix_sync(bk, v_s + n * 16 * kLdh + k * 16, kLdh);
        wmma::mma_sync(dp_acc, gf[k], bk, dp_acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, s_acc, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(dp_w + n * 16, dp_acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P o (dP - D), with keys past `seq` masked out.
#pragma unroll 8
    for (int j = 0; j < kHalf; ++j) {
      const int col = half * kHalf + j;
      float ds = 0.f;
      if (k0 + col < seq) {
        const float p = exp2f(s_w[r * kLdf + col] * qscale - lse2);
        ds = p * (dp_w[r * kLdf + col] - drow);
      }
      ds_w[r * kLdh + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ += dS K.
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
      for (int k = 0; k < kTile / 16; ++k) {
        FragA a;
        FragBr bm;
        wmma::load_matrix_sync(a, ds_w + k * 16, kLdh);
        wmma::load_matrix_sync(bm, k_s + k * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dq[n], a, bm, dq[n]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(s_w + n * 16, dq[n], kLdf, wmma::mem_row_major);
  }
  __syncwarp();
  store_rows_bf16(s_w, dqkv + (long long)b * seq * c3 + (long long)h * 3 * kD, c3,
                  q0 + warp * kRows, seq, gscale);
}

// ------------------------------------------------------------------ f32 paths
// Stage 64 rows x 64 f32 of a row-major source into a tile whose two
// 32-dim halves are interleaved: element (r, c) at r*64 + (c%32)*2 + c/32.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ld,
                                              int row0, int seq) {
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e % kD;
    dst[r * kD + (c % kHalf) * 2 + c / kHalf] =
        row0 + r < seq ? src[(long long)(row0 + r) * ld + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dqkv, int seq, int heads, float qscale, float gscale) {
  __shared__ float q_s[kTile * kD];
  __shared__ float do_s[kTile * kD];
  __shared__ float lse_s[kTile];
  __shared__ float dl_s[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int kj = blockIdx.x * kTile + row;
  const bool kvalid = kj < seq;
  const long long c3 = 3LL * heads * kD;
  const long long c1 = (long long)heads * kD;
  const float* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  const float* gbase = dout + (long long)b * seq * c1 + (long long)h * kD;
  const float* lse_bh = lse + ((long long)b * heads + h) * seq;
  const float* dl_bh = delta + ((long long)b * heads + h) * seq;

  float kr[kHalf], vr[kHalf], dk[kHalf], dv[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    kr[d] = kvalid ? base[(long long)kj * c3 + kD + half * kHalf + d] : 0.f;
    vr[d] = kvalid ? base[(long long)kj * c3 + 2 * kD + half * kHalf + d] : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile_f32(q_s, base, c3, q0, seq);
    load_tile_f32(do_s, gbase, c1, q0, seq);
    load_rowstats(lse_s, dl_s, lse_bh, dl_bh, q0, seq);
    __syncthreads();
    for (int i = 0; i < kTile; ++i) {
      const float* qi = q_s + i * kD + half;
      const float* gi = do_s + i * kD + half;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        s = fmaf(kr[d], qi[2 * d], s);
        dp = fmaf(vr[d], gi[2 * d], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = exp2f(s * qscale - lse_s[i]);
      const float ds = p * (dp - dl_s[i]);
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        dv[d] = fmaf(p, gi[2 * d], dv[d]);
        dk[d] = fmaf(ds, qi[2 * d], dk[d]);
      }
    }
  }
  if (kvalid) {
    float* dst = dqkv + ((long long)b * seq + kj) * c3 + (long long)h * 3 * kD + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      dst[kD + d] = dk[d] * gscale;
      dst[2 * kD + d] = dv[d];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dqkv, int seq, int heads, float qscale, float gscale) {
  __shared__ float k_s[kTile * kD];
  __shared__ float v_s[kTile * kD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int qi = blockIdx.x * kTile + row;
  const bool qvalid = qi < seq;
  const long long c3 = 3LL * heads * kD;
  const long long c1 = (long long)heads * kD;
  const float* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  const float* gbase = dout + (long long)b * seq * c1 + (long long)h * kD;
  const long long bh = ((long long)b * heads + h) * seq;
  const float lse2 = qvalid ? lse[bh + qi] * kLog2e : INFINITY;
  const float drow = qvalid ? delta[bh + qi] : 0.f;

  float qr[kHalf], gr[kHalf], dq[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = qvalid ? base[(long long)qi * c3 + half * kHalf + d] : 0.f;
    gr[d] = qvalid ? gbase[(long long)qi * c1 + half * kHalf + d] : 0.f;
    dq[d] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    const int nk = min(kTile, seq - k0);
    __syncthreads();
    load_tile_f32(k_s, base + kD, c3, k0, seq);
    load_tile_f32(v_s, base + 2 * kD, c3, k0, seq);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* kj = k_s + j * kD + half;
      const float* vj = v_s + j * kD + half;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        s = fmaf(qr[d], kj[2 * d], s);
        dp = fmaf(gr[d], vj[2 * d], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float ds = exp2f(s * qscale - lse2) * (dp - drow);
#pragma unroll
      for (int d = 0; d < kHalf; ++d) dq[d] = fmaf(ds, kj[2 * d], dq[d]);
    }
  }
  if (qvalid) {
    float* dst = dqkv + ((long long)b * seq + qi) * c3 + (long long)h * 3 * kD + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) dst[d] = dq[d] * gscale;
  }
}

}  // namespace

// qkv and dqkv [batch, seq, 3*heads*64]; out and dout [batch, seq, heads*64];
// all contiguous and of one type, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1). lse [batch, heads, seq] f32 from the forward launch; delta
// is f32 scratch of the same shape. qscale = scale^2 * log2(e), gscale =
// scale^2. Writes every element of dqkv. Returns cudaGetLastError().
extern "C" int packed_attention_bwd_launch(const void* qkv, const void* out, const void* dout,
                                           const void* lse, void* delta, void* dqkv, int batch,
                                           int seq, int heads, float qscale, float gscale,
                                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)batch * seq * heads;
  const unsigned dgrid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (is_bf16) {
    const bf16* q = static_cast<const bf16*>(qkv);
    const bf16* o = static_cast<const bf16*>(out);
    const bf16* g = static_cast<const bf16*>(dout);
    bf16* dq = static_cast<bf16*>(dqkv);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_bf16,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemBf16));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(attn_bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBf16));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_delta<bf16><<<dgrid, kThreads, 0, s>>>(o, g, delta_f, batch, seq, heads);
    attn_bwd_dkdv_bf16<<<grid, kThreads, kSmemBf16, s>>>(q, g, lse_f, delta_f, dq, seq, heads,
                                                         qscale, gscale);
    attn_bwd_dq_bf16<<<grid, kThreads, kSmemBf16, s>>>(q, g, lse_f, delta_f, dq, seq, heads,
                                                       qscale, gscale);
  } else {
    const float* q = static_cast<const float*>(qkv);
    const float* o = static_cast<const float*>(out);
    const float* g = static_cast<const float*>(dout);
    float* dq = static_cast<float*>(dqkv);
    attn_bwd_delta<float><<<dgrid, kThreads, 0, s>>>(o, g, delta_f, batch, seq, heads);
    attn_bwd_dkdv_f32<<<grid, kThreads, 0, s>>>(q, g, lse_f, delta_f, dq, seq, heads, qscale,
                                                gscale);
    attn_bwd_dq_f32<<<grid, kThreads, 0, s>>>(q, g, lse_f, delta_f, dq, seq, heads, qscale,
                                              gscale);
  }
  return static_cast<int>(cudaGetLastError());
}
