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
// - f32 takes split-precision TF32 products on the tensor cores (csrc/tf32.cuh:
//   each operand as hi + lo, each product as lo*hi + hi*lo + hi*hi, near f32
//   accuracy). Its bound is the 10 B H T^2 D flops taken 3 times at 494.7
//   TFLOP/s (0.130 ms at [8, 1024, 768]); this design does 14 of the 10
//   (the dQ blocks redo S and dP). The same two kinds of block in one launch,
//   four warps of 16 rows each; mma.sync m16n8k8 instead of wgmma, because
//   wgmma's tf32 form reads shared-memory operands K-major only and five of
//   the products here need a transposed one. A block's own two tiles stay
//   raw and each warp splits its A fragments as it loads them; the two it
//   streams arrive by 16-byte cp.async copies and are split in place once
//   per block. S^T, dP^T, S and dP are summed in the tensor cores'
//   accumulator (one tile each); dK, dV and dQ, which run over the whole
//   walk, in step sums added on the CUDA cores (tf32.cuh: the tensor cores
//   round toward zero). P^T, dS^T and dS stay in registers (the token order
//   of tf32.cuh maps an accumulator onto the next product's A operand).
//   105 KB of shared memory: two blocks share an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head width
constexpr int kTile = 64;     // queries or keys per tile
constexpr int kThreads = 128;
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

// ------------------------------------------------------------------ f32 path
// Split-precision TF32 products (csrc/tf32.cuh), the structure of the bf16
// backward: dK/dV blocks and dQ blocks in one launch. A block's own two
// tiles (dK/dV: K and V of its keys; dQ: Q and dO of its queries) stay raw
// and each warp splits its A fragments as it loads them; the other two
// (dK/dV: Q and dO; dQ: K and V) stream by in 64-row tiles, copied by
// cp.async and split in place once per block. Nothing is copied ahead: at
// 105 KB two blocks share an SM and each one's copies run under the other's
// products (measured 1.5x faster than one block per SM with its next tile
// copied ahead, 171 KB).
// Own raw tiles (2), streamed hi/lo tiles (4), a query tile's (lse2, D) pairs.
constexpr size_t kSmemF32 = 6 * tf32::kTileF * sizeof(float) + kTile * sizeof(float2);

// acc (16 x 64, from zero) += A B^T over the 64 head dims: A the warp's 16 rows
// [m0, m0 + 16) of a raw own tile, B the 64 rows of a split streamed tile.
__device__ __forceinline__ void tile_product(float (&acc)[32], const float* a_raw,
                                             const uint32_t* b_hi, const uint32_t* b_lo, int m0,
                                             int g, int t4) {
  using namespace tf32;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    FragA a;
    load_a_split(a, a_raw, m0, 8 * kk, g, t4);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      FragB b;
      load_b_rows(b, b_hi, b_lo, 8 * nt, 8 * kk, g, t4);
      mma3_tile(acc + 4 * nt, a, b);
    }
  }
}

// acc (16 x 64) += P B over the tile's 64 tokens: P an accumulator in
// registers (tokens as its columns), B a split streamed tile (tokens as its
// rows); a running sum, so in step sums.
__device__ __forceinline__ void walk_product(float (&acc)[32], const float (&p)[32],
                                             const uint32_t* b_hi, const uint32_t* b_lo, int g,
                                             int t4) {
  using namespace tf32;
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    FragA a;
    a_from_acc(a, p + 4 * kk);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      FragB b;
      load_b_cols(b, b_hi, b_lo, 8 * kk, 8 * nt, g, t4);
      mma3(acc + 4 * nt, a, b);
    }
  }
}

// dK/dV block, one query tile: S^T = K Q^T and dP^T = V dO^T for this warp's
// 16 keys, P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q.
// Each product in a loop of its own: one A and one B fragment live at a
// time, which keeps the registers under the cap of two blocks per SM.
__device__ __forceinline__ void dkdv_tile_f32(const float* own, const uint32_t* str,
                                              const float2* st_s, float (&dk)[32],
                                              float (&dv)[32], int m0, int g, int t4,
                                              float qscale) {
  using namespace tf32;
  float st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  tile_product(st, own, str, str + kTileF, m0, g, t4);
  tile_product(dpt, own + kTileF, str + 2 * kTileF, str + 3 * kTileF, m0, g, t4);
  // P^T = exp2(S^T qscale - lse2[q]) and dS^T = P^T o (dP^T - D[q]) in place;
  // column (query) 8 (i / 4) + 2 t4 + (i & 1). Pad queries: lse2 = +inf, P = 0.
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 r = st_s[8 * (i / 4) + 2 * t4 + (i & 1)];
    const float p = hopper::exp2_approx(st[i] * qscale - r.x);
    st[i] = p;
    dpt[i] = p * (dpt[i] - r.y);
  }
  walk_product(dv, st, str + 2 * kTileF, str + 3 * kTileF, g, t4);
  walk_product(dk, dpt, str, str + kTileF, g, t4);
}

// dQ block, one key tile: S = Q K^T and dP = dO V^T for this warp's 16
// queries, dS in registers (keys past `seq` masked), then dQ += dS K.
__device__ __forceinline__ void dq_tile_f32(const float* own, const uint32_t* str,
                                            const float2 (&rs)[2], float (&dq)[32], int m0,
                                            int kbase, int seq, int g, int t4, float qscale) {
  using namespace tf32;
  float sa[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = dp[i] = 0.f;
  tile_product(sa, own, str, str + kTileF, m0, g, t4);
  tile_product(dp, own + kTileF, str + 2 * kTileF, str + 3 * kTileF, m0, g, t4);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 r = rs[(i >> 1) & 1];
    const bool valid = kbase + 8 * (i / 4) + 2 * t4 + (i & 1) < seq;
    const float p = valid ? hopper::exp2_approx(sa[i] * qscale - r.x) : 0.f;
    sa[i] = p * (dp[i] - r.y);
  }
  walk_product(dq, sa, str, str + kTileF, g, t4);
}

// Both f32 passes in one launch, laid out as attn_bwd_bf16's: blockIdx.z <
// batch are the dK/dV blocks (one per 64-key tile), the rest the dQ blocks
// (one per 64-query tile).
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
             const float2* __restrict__ stats, float* __restrict__ dqkv, int batch, int seq,
             int tpad, int heads, float qscale, float gscale) {
  using namespace tf32;
  extern __shared__ float4 smem_f4[];
  float* own = reinterpret_cast<float*>(smem_f4);
  uint32_t* str = reinterpret_cast<uint32_t*>(own + 2 * kTileF);
  float2* st_s = reinterpret_cast<float2*>(str + 4 * kTileF);

  const bool dkdv = blockIdx.z < batch;
  const int b = dkdv ? blockIdx.z : blockIdx.z - batch;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int ntiles = tpad / kTile;
  const long long c3 = 3LL * heads * kD;
  const long long c1 = (long long)heads * kD;
  const float* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  const float* gbase = dout + (long long)b * seq * c1 + (long long)h * kD;
  const float2* stats_bh = stats + ((long long)b * heads + h) * tpad;
  const float* own0 = dkdv ? base + kD : base;
  const float* own1 = dkdv ? base + 2 * kD : gbase;
  const long long own1_ld = dkdv ? c3 : c1;
  const float* str0 = dkdv ? base : base + kD;
  const float* str1 = dkdv ? gbase : base + 2 * kD;
  const long long str1_ld = dkdv ? c1 : c3;

  stage(own, own0, c3, row0, seq);
  stage(own + kTileF, own1, own1_ld, row0, seq);
  cp_commit();

  // lse2 and D of a dQ block's rows g and g + 8 of its warp's 16 (pad: +inf, 0).
  const float2 rs[2] = {stats_bh[row0 + warp * 16 + g], stats_bh[row0 + warp * 16 + g + 8]};
  float acc0[32], acc1[32];  // dK/dV: dK and dV; dQ: dQ in acc0
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with tile j-1's parts
    stage(reinterpret_cast<float*>(str), str0, c3, j * kTile, seq);
    stage(reinterpret_cast<float*>(str + 2 * kTileF), str1, str1_ld, j * kTile, seq);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    // In place: the hi tiles are where the copies landed.
    split_tile(str, str + kTileF, reinterpret_cast<const float*>(str));
    split_tile(str + 2 * kTileF, str + 3 * kTileF, reinterpret_cast<const float*>(str + 2 * kTileF));
    if (dkdv && tid < kTile) st_s[tid] = stats_bh[j * kTile + tid];
    __syncthreads();
    if (dkdv) {
      dkdv_tile_f32(own, str, st_s, acc0, acc1, warp * 16, g, t4, qscale);
    } else {
      dq_tile_f32(own, str, rs, acc0, warp * 16, j * kTile, seq, g, t4, qscale);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    float* dst = dqkv + ((long long)b * seq + row) * c3 + (long long)h * 3 * kD + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int i = 4 * nt + 2 * r;
      if (dkdv) {
        *reinterpret_cast<float2*>(dst + kD + 8 * nt) =
            make_float2(acc0[i] * gscale, acc0[i + 1] * gscale);
        *reinterpret_cast<float2*>(dst + 2 * kD + 8 * nt) = make_float2(acc1[i], acc1[i + 1]);
      } else {
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            make_float2(acc0[i] * gscale, acc0[i + 1] * gscale);
      }
    }
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
    static bool opted_in[hopper::kMaxDevices] = {};
    const cudaError_t err = hopper::smem_opt_in(attn_bwd_f32, kSmemF32, opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* g = static_cast<const float*>(dout);
    attn_bwd_stats<float><<<sgrid, kThreads, 0, s>>>(static_cast<const float*>(out), g, lse_f,
                                                     stats, rows, seq, tpad, heads);
    const dim3 grid2(tpad / kTile, heads, 2 * batch);  // dK/dV blocks, then dQ blocks
    attn_bwd_f32<<<grid2, kThreads, kSmemF32, s>>>(static_cast<const float*>(qkv), g, stats,
                                                   static_cast<float*>(dqkv), batch, seq, tpad,
                                                   heads, qscale, gscale);
  }
  return static_cast<int>(cudaGetLastError());
}
