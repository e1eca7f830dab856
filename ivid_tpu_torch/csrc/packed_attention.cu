// Packed-qkv multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ivid_tpu/ops/attention.py:_attn_kernel
// (launched by _packed_attention_fwd_kernel). Same function: exact softmax
// attention read straight out of the fused projection qkv [B, T, 3C], whose
// columns are head-major [h][q|k|v][64], written token-major into out [B, T, C]
// at column h*64. No unpack or transpose copies exist on either side.
//
// What bounds it on the H100: operations. At the training shape (T=1024, 4
// heads, batch 8) the work is 4*B*H*T^2*64 = 8.6 GFLOP per call over 16 MB of
// operands, far above the bf16 ridge point (8.7 us of tensor-core time, 4.7
// us of bytes). Next to the products sit the softmax's exponentials: T^2 per
// (sample, head), 16 per 64-wide product step a thread, on the SM's
// 16-per-clock special-function units, about as many clocks as the products.
//
// Design (both paths):
// - One block per (sample, head, 64-query tile), 128 threads: batch 2 at
//   T=1024 gives 128 blocks for the 132 SMs.
// - The TPU kernel keeps the whole [BQ, T] f32 logits panel in VMEM (4 MB at
//   T=1024); a block here has at most 227 KB of shared memory, so keys stream
//   in 64-row K/V tiles with an online softmax: running max and sum in f32,
//   the output accumulator rescaled per tile, one divide at the end (the TPU
//   kernel's deferred division). Scores are multiplied by scale^2 * log2(e)
//   in f32 so the softmax uses exp2 (the TPU kernel's exp2 fold).
// - bf16: the block is one warpgroup. S = Q K^T is a wgmma m64n64k16 with Q
//   and K read from shared memory; S, the softmax of it, P and the 64 x 64
//   f32 output accumulator never leave the registers: the row max and sum
//   reduce over the quad of lanes that shares a row, P is packed to bf16
//   pairs in the A-operand layout, and O += P V is a wgmma with A from
//   registers and V (MN-major) from shared memory. Q and the K/V tiles arrive
//   by TMA from a 3D tensor map over qkv (the packed columns in place, rows
//   past T read as zeros) into two-stage rings, one for K and one for V,
//   each slot refilled as soon as its own product is done, so loads run a
//   tile ahead of the products. 42 KB of shared memory and ~110 registers
//   let 4 blocks share an SM: the 512 blocks of batch 8 fit in one wave.
// - The products and the softmax overlap inside the warpgroup: S of tile
//   j+1 is issued before P_j V_j, and the softmax of tile j+1 runs on the
//   CUDA cores and special-function units while the tensor cores finish
//   both; only the rescale of O waits for P_j V_j. At batch 2 one block is
//   alone on its SM, so this overlap, not other blocks, hides the latency.
// - f32: split-precision TF32 products on the tensor cores (csrc/tf32.cuh:
//   each operand as hi + lo, each product as lo*hi + hi*lo + hi*hi), which
//   hold the plain version's 1e-4 at 3x the TF32 work. What bounds it: the
//   same 4 B H T^2 D flops, taken 3 times at 494.7 TFLOP/s (0.052 ms at
//   [8, 1024, 768]). One block per (sample, head, 64-query tile), four
//   warps of 16 queries. Q is split once into A fragments kept in
//   registers. Each 64-key K/V tile arrives by 16-byte cp.async copies into
//   a raw stage and is split into hi and lo tiles once per block; the next
//   tile's copies run while this one is multiplied. S = Q K^T (m16n8k8,
//   three products a k8 step, summed in the tensor cores' accumulator)
//   lands in the bf16 path's accumulator layout, so the same online softmax
//   runs on it in registers; O, which runs over the whole walk, is summed
//   in step sums added on the CUDA cores (tf32.cuh); P is split in
//   registers and multiplies V with its keys taken in the order that maps
//   the accumulator onto the A operand (tf32.cuh), so P never touches shared
//   memory. 102 KB of shared memory: two blocks share an SM.
// - The TPU's even-head rule (128-lane stripes) does not apply.
// - For training, the launch may also write each row's log-sum-exp of the
//   logits (f32 [B, H, T], natural log) so the backward
//   (csrc/packed_attention_bwd.cu) rebuilds P without a second softmax pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int kD = 64;        // head width (the only one the configs use)
constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr float kLn2 = 0.69314718055994531f;

// ---------------------------------------------------------------- bf16 path
constexpr int kStages = 2;  // of the K ring and of the V ring
constexpr int kTile = hopper::kTileBytes;
// Alignment slack, the Q tile, kStages K and kStages V tiles, the barriers.
constexpr size_t kSmemBf16 = 1024 + (1 + 2 * kStages) * kTile + 8 * (1 + 2 * kStages);

// Online softmax of one tile of raw scores q.k in place: masks keys past
// `seq`, moves the running max m (base-2 units) of rows g and g + 8, sets
// alpha to the factor that rescales what was accumulated before, and leaves
// p = exp2(s qscale - m) in sc and its partial row sums added to l.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float qscale, int kbase,
                                             int seq, int t4) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (kbase + kBK > seq && kbase + 8 * (i / 4) + 2 * t4 + (i & 1) >= seq) sc[i] = -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mnew = fmaxf(m[r], mx[r] * qscale);  // finite: every tile holds >= 1 key
    alpha[r] = hopper::exp2_approx(m[r] - mnew);
    m[r] = mnew;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = hopper::exp2_approx(fmaf(sc[i], qscale, -m[r]));
    l[r] += sc[i];
  }
}

// P as the A operand of the value product: bf16 pairs, one k16 step per row.
__device__ __forceinline__ void pack_p(const float (&sc)[32], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = hopper::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_bf16(const __grid_constant__ CUtensorMap qkv_map,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int seq,
                          int heads, float qscale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + kTile;                  // K ring
  unsigned char* v_s = smem + (1 + kStages) * kTile;  // V ring
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (1 + 2 * kStages) * kTile);
  uint64_t* q_bar = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int ntiles = (seq + kBK - 1) / kBK;
  const int col_q = h * 3 * kD;

  // K and V tiles travel in separate rings: K of tile j+1 is multiplied
  // while V of tile j still is, and each slot is refilled as soon as its
  // own product is done.
  auto issue = [&](unsigned char* ring, uint64_t* full, int col, int j) {
    const int s = j % kStages;
    mbar_expect_tx(&full[s], kTile);
    tma_load_3d(ring + s * kTile, &qkv_map, &full[s], col, j * kBK, b);
  };
  auto issue_k = [&](int j) { issue(k_s, k_full, col_q + kD, j); };
  auto issue_v = [&](int j) { issue(v_s, v_full, col_q + 2 * kD, j); };
  auto k_desc = [&](int j) { return desc_sw128(k_s + (j % kStages) * kTile); };
  auto v_desc = [&](int j) { return desc_sw128(v_s + (j % kStages) * kTile); };
  auto wait_k = [&](int j) { mbar_wait(&k_full[j % kStages], (j / kStages) & 1); };
  auto wait_v = [&](int j) { mbar_wait(&v_full[j % kStages], (j / kStages) & 1); };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < 2 * kStages; ++s) mbar_init(&k_full[s], 1);  // k_full, v_full
    mbar_fence_init();
    mbar_expect_tx(q_bar, kTile);
    tma_load_3d(q_s, &qkv_map, q_bar, col_q, q0, b);
    for (int j = 0; j < kStages && j < ntiles; ++j) {
      issue_k(j);
      issue_v(j);
    }
  }
  __syncthreads();

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // Running max (base-2 units) and this thread's share of the running sum,
  // for rows g (index 0) and g + 8 (index 1) of the warp's 16.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float sc[32];
  uint32_t pa[kBK / 16][4];
  const uint64_t dq = desc_sw128(q_s);
  mbar_wait(q_bar, 0);

  // Tile 0's scores and softmax; then, per tile j, S of tile j+1 is issued
  // before P_j V_j, and the softmax of tile j+1 runs while the tensor cores
  // finish P_j V_j.
  wait_k(0);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) mma_ss(sc, dq + kk * kStepK, k_desc(0) + kk * kStepK, kk);
  wg_commit();
  wg_wait<0>();
  fence_acc(sc);
  softmax_tile(sc, m, l, alpha, qscale, 0, seq, t4);
  pack_p(sc, pa);
  __syncthreads();  // K of tile 0 is consumed
  if (tid == 0 && kStages < ntiles) issue_k(kStages);

  for (int j = 0; j + 1 < ntiles; ++j) {
    wait_k(j + 1);
    wg_fence();
    const uint64_t dk = k_desc(j + 1);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) mma_ss(sc, dq + kk * kStepK, dk + kk * kStepK, kk);
    wg_commit();
    wait_v(j);
    wg_fence();  // P_j and the rescaled O may be computed as late as here
    const uint64_t dv = v_desc(j);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) mma_rs(o, pa[kk], dv + kk * kStepMN);
    wg_commit();
    wg_wait<1>();  // S of tile j+1 is in; P_j V_j may still run
    fence_acc(sc);
    softmax_tile(sc, m, l, alpha, qscale, (j + 1) * kBK, seq, t4);
    wg_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p(sc, pa);
    __syncthreads();  // K of tile j+1 and V of tile j are consumed: refill
    if (tid == 0) {
      if (j + 1 + kStages < ntiles) issue_k(j + 1 + kStages);
      if (j + kStages < ntiles) issue_v(j + kStages);
    }
  }
  wait_v(ntiles - 1);
  wg_fence();
  const uint64_t dv = v_desc(ntiles - 1);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) mma_rs(o, pa[kk], dv + kk * kStepMN);
  wg_commit();
  wg_wait<0>();
  fence_acc(o);

  // The quad of lanes sharing a row holds its sum in four parts.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long ld = (long long)heads * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= seq) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* dst = out + ((long long)b * seq + qi) * ld + h * kD + 2 * t4;
#pragma unroll
    for (int jj = 0; jj < kD / 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          __floats2bfloat162_rn(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
    }
    if (lse != nullptr && t4 == 0) {
      lse[((long long)b * heads + h) * seq + qi] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ----------------------------------------------------------------- f32 path
// Raw K and V tiles (the next tile's copies land here), then the hi and lo
// parts of K and of V.
constexpr size_t kSmemF32 = 6 * tf32::kTileF * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
packed_attention_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
                         float* __restrict__ lse, int seq, int heads, float qscale) {
  using namespace tf32;
  extern __shared__ float4 smem_f4[];
  float* raw_k = reinterpret_cast<float*>(smem_f4);
  float* raw_v = raw_k + kTileF;
  uint32_t* kh = reinterpret_cast<uint32_t*>(raw_v + kTileF);
  uint32_t* kl = kh + kTileF;
  uint32_t* vh = kl + kTileF;
  uint32_t* vl = vh + kTileF;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int ntiles = (seq + kBK - 1) / kBK;
  const long long c3 = 3LL * heads * kD;
  const float* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;

  // Q is staged once, and each warp splits its 16 rows into A fragments
  // that stay in registers for the whole walk.
  stage(raw_k, base, c3, q0, seq);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  FragA qa[kD / 8];
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) load_a_split(qa[kk], raw_k, warp * 16, 8 * kk, g, t4);
  __syncthreads();
  stage(raw_k, base + kD, c3, 0, seq);
  stage(raw_v, base + 2 * kD, c3, 0, seq);
  cp_commit();

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float sc[32];

  for (int j = 0; j < ntiles; ++j) {
    cp_wait_all();
    __syncthreads();  // tile j has landed, and every warp is done with tile j-1's parts
    split_tile(kh, kl, raw_k);
    split_tile(vh, vl, raw_v);
    __syncthreads();
    if (j + 1 < ntiles) {  // tile j+1 is copied while tile j is multiplied
      stage(raw_k, base + kD, c3, (j + 1) * kBK, seq);
      stage(raw_v, base + 2 * kD, c3, (j + 1) * kBK, seq);
      cp_commit();
    }

    // S = Q K^T: this warp's 16 queries x the tile's 64 keys, in the
    // accumulator layout of the bf16 path (rows g and g + 8).
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        FragB kb;
        load_b_rows(kb, kh, kl, 8 * nt, 8 * kk, g, t4);
        mma3_tile(sc + 4 * nt, qa[kk], kb);
      }
    }
    softmax_tile(sc, m, l, alpha, qscale, j * kBK, seq, t4);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V with P split in registers, keys in the order of tf32.cuh.
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      FragA pa;
      a_from_acc(pa, sc + 4 * kk);
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        FragB vb;
        load_b_cols(vb, vh, vl, 8 * kk, 8 * nt, g, t4);
        mma3(o + 4 * nt, pa, vb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long ld = (long long)heads * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= seq) continue;
    const float inv = 1.f / l[r];
    float* dst = out + ((long long)b * seq + qi) * ld + h * kD + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
    }
    if (lse != nullptr && t4 == 0) {
      lse[((long long)b * heads + h) * seq + qi] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

}  // namespace

// qkv [batch, seq, 3*heads*64] and out [batch, seq, heads*64], contiguous,
// both float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1; qkv 16-byte aligned).
// lse is null or f32 [batch, heads, seq]: the natural log-sum-exp of each
// row's logits scale^2 * q.k. qscale is scale^2 * log2(e). Returns a CUDA
// error code: cudaErrorInvalidValue if the driver refuses qkv's tensor map,
// else cudaGetLastError() after the launch.
extern "C" int packed_attention_fwd_launch(const void* qkv, void* out, void* lse, int batch,
                                           int seq, int heads, float qscale,
                                           int is_bf16, void* stream) {
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // Below the 48 KB a launch may take without the opt-in attribute.
    static_assert(kSmemBf16 <= 48 * 1024, "K1 bf16 shared memory needs the opt-in attribute");
    CUtensorMap map;
    if (!hopper::make_tile_map(&map, qkv, 3ull * heads * kD, seq, batch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    packed_attention_fwd_bf16<<<grid, kThreads, kSmemBf16, s>>>(
        map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), seq, heads, qscale);
  } else {
    static bool opted_in[hopper::kMaxDevices] = {};
    const cudaError_t err = hopper::smem_opt_in(packed_attention_fwd_f32, kSmemF32, opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    packed_attention_fwd_f32<<<grid, kThreads, kSmemF32, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(lse), seq,
        heads, qscale);
  }
  return static_cast<int>(cudaGetLastError());
}
