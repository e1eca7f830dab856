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
// What bounds it on the H100: operations. The function needs five T x T x
// 64 products per (sample, head) (S, dP, dV, dK, dQ): 10 B H T^2 D flops,
// 21.5 GFLOP at the training shape [8, 1024, 768] with 4 heads, against 989
// TFLOP/s bf16 (21.7 us). This design does seven (the dQ blocks redo S and
// dP): 30.1 GFLOP, 30.4 us. Its operands are 50 MB. It also takes two
// exponentials per (key, query) pair, one in each kind of block below, on
// the SM's special-function units (16 a clock): ~16 us at that shape and
// the 1.98 GHz boost clock, near the products' own bound.
//
// Design (no atomics, so dqkv is deterministic):
// - stats kernel: per row, lse in base-2 units and D = rowsum(dO o O), a
//   few lanes per (token, head) reading 16 bytes each, into f32 pairs
//   [B, H, Tp, 2] with T padded to a multiple of 64 (pad rows get lse =
//   +inf, so their P is exactly 0). One launch; its time counts in K4's.
// - dK/dV blocks: one block (one warpgroup) per (sample, head, 64-key
//   tile), walking all query tiles. Per tile, S^T = K Q^T and dP^T = V dO^T
//   are wgmma m64n64k16 from shared memory; P^T = exp2(S^T qscale - lse2)
//   and dS^T = P^T o (dP^T - D) are formed in registers and packed to bf16
//   as A operands; dV += P^T dO and dK += dS^T Q are wgmma with A from
//   registers and B (MN-major) from shared memory. The dK and dV
//   accumulators stay in registers for the whole walk.
// - dQ blocks: one per (sample, head, 64-query tile), the mirror image:
//   S = Q K^T and dP = dO V^T per key tile, dS in registers, dQ += dS K.
//   They redo S and dP, two of the seven products, which avoids atomics on
//   dQ.
// - A block is one warpgroup and its steps depend on each other, so the
//   design overlaps what it can inside the block and fills the SMs with
//   blocks: the products go out in groups (S, then dP, then the first
//   update), and each elementwise step runs on the CUDA cores and
//   special-function units while the tensor cores finish the next group.
//   Both kinds of block share one launch, the dK/dV blocks first, so the
//   shorter dQ blocks fill the SMs that the last dK/dV blocks leave idle.
//   At ~170 registers two blocks share an SM; capped at 168 for three,
//   ptxas serializes the products for want of registers and the launch is
//   no faster.
// - Tiles arrive by TMA (3D tensor maps over qkv and dout in their packed
//   layouts; the 64 stats pairs of a query tile by a bulk copy on the same
//   barrier) into a two-stage ring: tile j+1 is in flight while tile j is
//   multiplied. S, P, dP and dS never touch shared memory.
// - f32 runs exact FMAs on the CUDA cores, two threads per row holding half
//   of the 64 dims each (the layout of the forward's f32 path), with the
//   staged tiles interleaved so the pair reads neighbouring banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head width
constexpr int kTile = 64;     // queries or keys per tile
constexpr int kThreads = 128;
constexpr int kHalf = kD / 2;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kStages = 2;
constexpr int kTileB = hopper::kTileBytes;
constexpr int kStatBytes = kTile * 8;  // a tile's (lse2, D) pairs
// dK/dV: slack, K, V, kStages (Q, dO) pairs, kStages stats tiles, barriers.
constexpr size_t kSmemDkdv = 1024 + (2 + 2 * kStages) * kTileB + kStages * kStatBytes +
                             8 * (1 + kStages);
// dQ: slack, Q, dO, kStages (K, V) pairs, barriers.
constexpr size_t kSmemDq = 1024 + (2 + 2 * kStages) * kTileB + 8 * (1 + kStages);
constexpr size_t kSmemBf16 = kSmemDkdv > kSmemDq ? kSmemDkdv : kSmemDq;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// stats[b, h, t] = (lse[b, h, t] log2(e), sum_d dout[b, t, h*64+d] out[b, t, h*64+d])
// for t < seq, (+inf, 0) for seq <= t < tpad. kLanes lanes share a (token,
// head) row, each reading 16 bytes of out and of dout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_stats(const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
               float2* __restrict__ stats, long long rows, int seq, int tpad, int heads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = kD / kVec;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;  // (b*tpad+t)*heads+h
  const int part = threadIdx.x % kLanes;
  const bool valid = row < rows;  // the shuffles below need every lane
  const int h = row % heads;
  const long long bt = row / heads;
  const int t = bt % tpad;
  const int b = bt / tpad;
  const long long bh = (long long)b * heads + h;
  float acc = 0.f;
  if (valid && t < seq) {
    const long long src = (((long long)b * seq + t) * heads + h) * kD + part * kVec;
    const uint4 ov = *reinterpret_cast<const uint4*>(out + src);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + src);
    const T* o = reinterpret_cast<const T*>(&ov);
    const T* g = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc += to_f(o[i]) * to_f(g[i]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && part == 0) {
    stats[bh * tpad + t] = t < seq ? make_float2(lse[bh * seq + t] * kLog2e, acc)
                                   : make_float2(INFINITY, 0.f);
  }
}

// ----------------------------------------------------------------- bf16 dK/dV
// One 64-key tile [k0, k0 + 64) of (b, h), walking every query tile.
__device__ __forceinline__ void dkdv_bf16(const CUtensorMap* qkv_map, const CUtensorMap* do_map,
                                          const float2* __restrict__ stats,
                                          bf16* __restrict__ dqkv, unsigned char* smem, int b,
                                          int h, int k0, int seq, int tpad, int heads,
                                          float qscale, float gscale) {
  using namespace hopper;
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + kTileB;
  unsigned char* qd_s = smem + 2 * kTileB;  // stage s: Q at 2s, dO at 2s+1 tiles
  unsigned char* st_s = smem + (2 + 2 * kStages) * kTileB;  // stage s at s * kStatBytes
  uint64_t* bars = reinterpret_cast<uint64_t*>(st_s + kStages * kStatBytes);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int ntiles = tpad / kTile;
  const int col_q = h * 3 * kD;
  const float2* stats_bh = stats + ((long long)b * heads + h) * tpad;

  auto issue_q = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(&full[s], 2 * kTileB + kStatBytes);
    tma_load_3d(qd_s + 2 * s * kTileB, qkv_map, &full[s], col_q, j * kTile, b);
    tma_load_3d(qd_s + (2 * s + 1) * kTileB, do_map, &full[s], h * kD, j * kTile, b);
    bulk_load(st_s + s * kStatBytes, stats_bh + j * kTile, kStatBytes, &full[s]);
  };
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(kv_bar, 2 * kTileB);
    tma_load_3d(k_s, qkv_map, kv_bar, col_q + kD, k0, b);
    tma_load_3d(v_s, qkv_map, kv_bar, col_q + 2 * kD, k0, b);
    issue_q(0);
  }
  __syncthreads();

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const uint64_t dk_a = desc_sw128(k_s);
  const uint64_t dv_a = desc_sw128(v_s);
  mbar_wait(kv_bar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    if (tid == 0 && j + 1 < ntiles) issue_q(j + 1);  // its stage was freed at j - 1
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint64_t dq_b = desc_sw128(qd_s + 2 * s * kTileB);
    const uint64_t do_b = desc_sw128(qd_s + (2 * s + 1) * kTileB);

    // S^T = K Q^T and dP^T = V dO^T (rows: this block's keys; columns: the
    // tile's queries) as two groups, so P^T's exponentials run while the
    // tensor cores still form dP^T.
    float st[32], dpt[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) mma_ss(st, dk_a + kk * kStepK, dq_b + kk * kStepK, kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) mma_ss(dpt, dv_a + kk * kStepK, do_b + kk * kStepK, kk);
    wg_commit();
    wg_wait<1>();
    fence_acc(st);

    // P^T = exp2(S^T qscale - lse2[q]) in place, packed as the A operand of
    // dV += P^T dO (dO as MN-major B), which runs while dS^T is formed.
    const float4* rs = reinterpret_cast<const float4*>(st_s + s * kStatBytes);
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float4 r4 = rs[4 * (2 * kk + e / 2) + t4];  // (lse2, D) of queries c, c + 1
        st[i] = exp2_approx(st[i] * qscale - r4.x);
        st[i + 1] = exp2_approx(st[i + 1] * qscale - r4.z);
        pa[kk][e] = pack_bf16(st[i], st[i + 1]);
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) mma_rs(dv, pa[kk], do_b + kk * kStepMN);
    wg_commit();
    wg_wait<1>();
    fence_acc(dpt);

    // dS^T = P^T o (dP^T - D[q]), the A operand of dK += dS^T Q.
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float4 r4 = rs[4 * (2 * kk + e / 2) + t4];
        dsa[kk][e] = pack_bf16(st[i] * (dpt[i] - r4.y), st[i + 1] * (dpt[i + 1] - r4.w));
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) mma_rs(dk, dsa[kk], dq_b + kk * kStepMN);
    wg_commit();
    wg_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    __syncthreads();  // stage s is consumed: the next issue may refill it
  }

  const long long ld = 3LL * heads * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= seq) continue;
    bf16* dst = dqkv + ((long long)b * seq + key) * ld + col_q + 2 * t4;
#pragma unroll
    for (int jj = 0; jj < kD / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dst + kD + 8 * jj) =
          __floats2bfloat162_rn(dk[i] * gscale, dk[i + 1] * gscale);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2 * kD + 8 * jj) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ------------------------------------------------------------------- bf16 dQ
// One 64-query tile [q0, q0 + 64) of (b, h), walking every key tile.
__device__ __forceinline__ void dq_bf16(const CUtensorMap* qkv_map, const CUtensorMap* do_map,
                                        const float2* __restrict__ stats,
                                        bf16* __restrict__ dqkv, unsigned char* smem, int b,
                                        int h, int q0, int seq, int tpad, int heads, float qscale,
                                        float gscale) {
  using namespace hopper;
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + kTileB;
  unsigned char* kv_s = smem + 2 * kTileB;  // stage s: K at 2s, V at 2s+1 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (2 + 2 * kStages) * kTileB);
  uint64_t* qd_bar = bars;
  uint64_t* full = bars + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int ntiles = tpad / kTile;
  const int col_q = h * 3 * kD;

  auto issue_kv = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(&full[s], 2 * kTileB);
    tma_load_3d(kv_s + 2 * s * kTileB, qkv_map, &full[s], col_q + kD, j * kTile, b);
    tma_load_3d(kv_s + (2 * s + 1) * kTileB, qkv_map, &full[s], col_q + 2 * kD, j * kTile, b);
  };
  if (tid == 0) {
    mbar_init(qd_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(qd_bar, 2 * kTileB);
    tma_load_3d(q_s, qkv_map, qd_bar, col_q, q0, b);
    tma_load_3d(do_s, do_map, qd_bar, h * kD, q0, b);
    issue_kv(0);
  }
  __syncthreads();

  // lse2 and D of rows g and g + 8 of the warp's 16 (pad rows: +inf, 0).
  const float2* stats_bh = stats + ((long long)b * heads + h) * tpad;
  const float2 rs[2] = {stats_bh[q0 + warp * 16 + g], stats_bh[q0 + warp * 16 + g + 8]};
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  const uint64_t dq_a = desc_sw128(q_s);
  const uint64_t do_a = desc_sw128(do_s);
  mbar_wait(qd_bar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    if (tid == 0 && j + 1 < ntiles) issue_kv(j + 1);  // its stage was freed at j - 1
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint64_t dk_b = desc_sw128(kv_s + 2 * s * kTileB);
    const uint64_t dv_b = desc_sw128(kv_s + (2 * s + 1) * kTileB);

    // S = Q K^T and dP = dO V^T for this block's queries and the tile's
    // keys, as two groups: P's exponentials run while dP is formed.
    float sa[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) mma_ss(sa, dq_a + kk * kStepK, dk_b + kk * kStepK, kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) mma_ss(dp, do_a + kk * kStepK, dv_b + kk * kStepK, kk);
    wg_commit();
    wg_wait<1>();
    fence_acc(sa);

    // P in place, keys past `seq` (zeros from TMA) masked out.
    const int kbase = j * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool valid = kbase + 8 * (i / 4) + 2 * t4 + (i & 1) < seq;
      sa[i] = valid ? exp2_approx(sa[i] * qscale - rs[(i >> 1) & 1].x) : 0.f;
    }
    wg_wait<0>();
    fence_acc(dp);

    // dS = P o (dP - D), the A operand of dQ += dS K (K as MN-major B).
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float d = rs[e & 1].y;
        dsa[kk][e] = pack_bf16(sa[i] * (dp[i] - d), sa[i + 1] * (dp[i + 1] - d));
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) mma_rs(dq, dsa[kk], dk_b + kk * kStepMN);
    wg_commit();
    wg_wait<0>();
    fence_acc(dq);
    __syncthreads();  // stage s is consumed: the next issue may refill it
  }

  const long long ld = 3LL * heads * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= seq) continue;
    bf16* dst = dqkv + ((long long)b * seq + qi) * ld + col_q + 2 * t4;
#pragma unroll
    for (int jj = 0; jj < kD / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          __floats2bfloat162_rn(dq[i] * gscale, dq[i + 1] * gscale);
    }
  }
}

// Both bf16 passes in one launch: blockIdx.z < batch are the dK/dV blocks,
// the rest the dQ blocks. The longer dK/dV blocks come first in the grid,
// so the dQ blocks fill the SMs that the last of them leave idle.
__global__ void __launch_bounds__(kThreads)
attn_bwd_bf16(const __grid_constant__ CUtensorMap qkv_map,
              const __grid_constant__ CUtensorMap do_map, const float2* __restrict__ stats,
              bf16* __restrict__ dqkv, int batch, int seq, int tpad, int heads, float qscale,
              float gscale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  const int z = blockIdx.z;
  const int row0 = blockIdx.x * kTile;
  if (z < batch) {
    dkdv_bf16(&qkv_map, &do_map, stats, dqkv, smem, z, blockIdx.y, row0, seq, tpad, heads,
              qscale, gscale);
  } else {
    dq_bf16(&qkv_map, &do_map, stats, dqkv, smem, z - batch, blockIdx.y, row0, seq, tpad, heads,
            qscale, gscale);
  }
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
                  const float2* __restrict__ stats, float* __restrict__ dqkv, int seq, int tpad,
                  int heads, float qscale, float gscale) {
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
  const float2* stats_bh = stats + ((long long)b * heads + h) * tpad;

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
    for (int i = tid; i < kTile; i += kThreads) {
      const float2 st = stats_bh[q0 + i];  // pad rows: +inf, 0
      lse_s[i] = st.x;
      dl_s[i] = st.y;
    }
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
                const float2* __restrict__ stats, float* __restrict__ dqkv, int seq, int tpad,
                int heads, float qscale, float gscale) {
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
  const float2 st = stats[((long long)b * heads + h) * tpad + qi];  // pad rows: +inf, 0
  const float lse2 = st.x;
  const float drow = st.y;

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
// (is_bf16 = 1; qkv and dout 16-byte aligned). lse [batch, heads, seq] f32
// from the forward launch; scratch is f32 [batch, heads, tpad, 2] with tpad
// = seq rounded up to a multiple of 64. qscale = scale^2 * log2(e), gscale =
// scale^2. Writes every element of dqkv. Returns a CUDA error code:
// cudaErrorInvalidValue if the driver refuses a tensor map, else
// cudaGetLastError() after the launches.
extern "C" int packed_attention_bwd_launch(const void* qkv, const void* out, const void* dout,
                                           const void* lse, void* scratch, void* dqkv, int batch,
                                           int seq, int heads, float qscale, float gscale,
                                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpad = (seq + kTile - 1) / kTile * kTile;
  const long long rows = (long long)batch * tpad * heads;
  const int lanes = is_bf16 ? kD / 8 : kD / 4;  // the stats kernel's lanes per row
  const unsigned sgrid = static_cast<unsigned>((rows * lanes + kThreads - 1) / kThreads);
  const dim3 grid(tpad / kTile, heads, batch);
  const float* lse_f = static_cast<const float*>(lse);
  float2* stats = static_cast<float2*>(scratch);
  if (is_bf16) {
    static bool opted_in[hopper::kMaxDevices] = {};
    const cudaError_t err = hopper::smem_opt_in(attn_bwd_bf16, kSmemBf16, opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap qkv_map, do_map;
    if (!hopper::make_tile_map(&qkv_map, qkv, 3ull * heads * kD, seq, batch) ||
        !hopper::make_tile_map(&do_map, dout, 1ull * heads * kD, seq, batch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    attn_bwd_stats<bf16><<<sgrid, kThreads, 0, s>>>(static_cast<const bf16*>(out),
                                                    static_cast<const bf16*>(dout), lse_f, stats,
                                                    rows, seq, tpad, heads);
    const dim3 grid2(tpad / kTile, heads, 2 * batch);  // dK/dV blocks, then dQ blocks
    attn_bwd_bf16<<<grid2, kThreads, kSmemBf16, s>>>(qkv_map, do_map, stats,
                                                     static_cast<bf16*>(dqkv), batch, seq, tpad,
                                                     heads, qscale, gscale);
  } else {
    const float* q = static_cast<const float*>(qkv);
    const float* g = static_cast<const float*>(dout);
    float* dq = static_cast<float*>(dqkv);
    attn_bwd_stats<float><<<sgrid, kThreads, 0, s>>>(static_cast<const float*>(out), g, lse_f,
                                                     stats, rows, seq, tpad, heads);
    attn_bwd_dkdv_f32<<<grid, kThreads, 0, s>>>(q, g, stats, dq, seq, tpad, heads, qscale, gscale);
    attn_bwd_dq_f32<<<grid, kThreads, 0, s>>>(q, g, stats, dq, seq, tpad, heads, qscale, gscale);
  }
  return static_cast<int>(cudaGetLastError());
}
