// Packed-qkv multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ivid_tpu/ops/attention.py:_attn_kernel
// (launched by _packed_attention_fwd_kernel). Same function: exact softmax
// attention read straight out of the fused projection qkv [B, T, 3C], whose
// columns are head-major [h][q|k|v][64], written token-major into out [B, T, C]
// at column h*64. No unpack or transpose copies exist on either side.
//
// What bounds it on the H100: at the slice's shape (T=1024, 4 heads, batch 2)
// the work is 4*B*H*T^2*64 = 2.1 GFLOP per call over 6 MB of operands, far
// above the bf16 ridge point, so the products bound it: the bf16 path runs
// them on the tensor cores (wmma 16x16x16, f32 accumulation); the f32 path
// keeps exact f32 FMAs on the CUDA cores. With one block per (sample, head,
// 64-query tile) the slice's shape fills only 128 blocks, about one per SM, so
// latency rather than peak throughput sets the pace.
//
// Design (both paths):
// - One block per (sample, head, 64-query tile), 128 threads.
// - The TPU kernel keeps the whole [BQ, T] f32 logits panel in VMEM (4 MB at
//   T=1024); a block here has at most 227 KB of shared memory, so keys stream
//   in 64-row K/V tiles with an online softmax: running max and sum in f32,
//   the output accumulator rescaled per tile, one divide at the end (the TPU
//   kernel's deferred division). Scores are multiplied by scale^2 * log2(e)
//   in f32 so the softmax uses exp2 (the TPU kernel's exp2 fold).
// - bf16: each warp owns 16 query rows. Its q fragments stay in registers;
//   per tile it computes S = q k^T with wmma into shared memory, two lanes per
//   row run the online softmax over S and write P in bf16, rescale the row's
//   f32 accumulator tile, and wmma adds P v into it.
// - f32: two threads per query row, each holding 32 of the 64 dims of q and of
//   the accumulator in registers; K/V tiles are stored with the two halves
//   interleaved, so the pair reads neighbouring banks and the rest of the warp
//   reads the same words (broadcast): no bank conflicts.
// - The TPU's even-head rule (128-lane stripes) does not apply.
// - For training, the launch may also write each row's log-sum-exp of the
//   logits (f32 [B, H, T], natural log) so the backward
//   (csrc/packed_attention_bwd.cu) rebuilds P without a second softmax pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kD = 64;        // head width (the only one the configs use)
constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kHalf = kD / 2;
constexpr float kLn2 = 0.69314718055994531f;

// ---------------------------------------------------------------- bf16 path
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBQ / kWarps;  // 16 query rows per warp
constexpr int kLdh = kD + 8;         // bf16 tile row stride (elements)
constexpr int kLdf = kD + 4;         // f32 tile row stride (elements)
constexpr int kTileH = kBQ * kLdh;   // one 64-row bf16 tile
constexpr int kWarpH = kRows * kLdh; // one warp's 16-row bf16 tile
constexpr int kWarpF = kRows * kLdf; // one warp's 16-row f32 tile
constexpr size_t kSmemBf16 =
    sizeof(__nv_bfloat16) * (3 * kTileH + kWarps * kWarpH) + sizeof(float) * 2 * kWarps * kWarpF;

// Copy 64 rows x 64 bf16 at column `col` of the packed rows starting at `row0`
// into a [64][kLdh] tile, 16 bytes per thread and step; rows past `seq` are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long c3, int row0, int seq, int col) {
  for (int e = threadIdx.x; e < kBQ * (kD / 8); e += kThreads) {
    const int r = e / (kD / 8);
    const int c = (e % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq) {
      v = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * c3 + col + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_bf16(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int seq, int heads, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kTileH;
  __nv_bfloat16* v_s = k_s + kTileH;
  __nv_bfloat16* p_s = v_s + kTileH;  // per warp [16][kLdh]
  float* s_s = reinterpret_cast<float*>(p_s + kWarps * kWarpH);  // per warp [16][kLdf]
  float* o_s = s_s + kWarps * kWarpF;                              // per warp [16][kLdf]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c3 = 3LL * heads * kD;
  const __nv_bfloat16* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  __nv_bfloat16* p_w = p_s + warp * kWarpH;
  float* s_w = s_s + warp * kWarpF;
  float* o_w = o_s + warp * kWarpF;

  load_tile(q_s, base, c3, q0, seq, 0);
  for (int e = lane; e < kWarpF; e += 32) o_w[e] = 0.f;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[kD / 16];
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) {
    wmma::load_matrix_sync(qf[k], q_s + warp * kWarpH + k * 16, kLdh);
  }

  // Softmax lanes: row r of the warp's 16, columns half*32 .. half*32+31.
  const int r = lane >> 1;
  const int half = lane & 1;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile(k_s, base, c3, k0, seq, kD);
    load_tile(v_s, base, c3, k0, seq, 2 * kD);
    __syncthreads();

    // S = q k^T for this warp's 16 rows and the tile's 64 keys.
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, k_s + n * 16 * kLdh + k * 16, kLdh);
        wmma::mma_sync(acc, qf[k], kf, acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over the tile; P in bf16; rescale the accumulator row.
    float v[kHalf];
    float mt = -INFINITY;
    const float* srow = s_w + r * kLdf + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      v[j] = (k0 + half * kHalf + j < seq) ? srow[j] * qscale : -INFINITY;
      mt = fmaxf(mt, v[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float mnew = fmaxf(m, mt);  // finite: every tile holds >= 1 key
    const float alpha = exp2f(m - mnew);
    float ls = 0.f;
    __nv_bfloat16* prow = p_w + r * kLdh + half * kHalf;
    float* orow = o_w + r * kLdf + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float p = exp2f(v[j] - mnew);
      ls += p;
      prow[j] = __float2bfloat16(p);
      orow[j] *= alpha;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = mnew;
    __syncwarp();

    // o += P v.
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + n * 16, kLdf, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_w + k * 16, kLdh);
        wmma::load_matrix_sync(vf, v_s + k * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(o_w + n * 16, acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qi = q0 + warp * kRows + r;
  if (qi < seq) {
    const float inv = 1.f / l;
    const float* orow = o_w + r * kLdf + half * kHalf;
    __nv_bfloat16* dst = out + ((long long)b * seq + qi) * heads * kD + h * kD + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j) =
          __floats2bfloat162_rn(orow[j] * inv, orow[j + 1] * inv);
    }
    if (lse != nullptr && half == 0) {
      lse[((long long)b * heads + h) * seq + qi] = (m + log2f(l)) * kLn2;
    }
  }
}

// ----------------------------------------------------------------- f32 path
__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
                         float* __restrict__ lse, int seq, int heads, float qscale) {
  __shared__ float ks[kBK * kD];
  __shared__ float vs[kBK * kD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const long long c3 = 3LL * heads * kD;
  const float* base = qkv + (long long)b * seq * c3 + (long long)h * 3 * kD;
  const int qi = q0 + row;
  const bool qvalid = qi < seq;

  float q[kHalf];
  float o[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    q[d] = qvalid ? base[(long long)qi * c3 + half * kHalf + d] * qscale : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    const int nk = min(kBK, seq - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < kBK * kD; e += kThreads) {
      const int rr = e / kD;
      const int c = e % kD;  // fastest: coalesced global reads
      const int slot = rr * kD + (c % kHalf) * 2 + c / kHalf;
      float kv = 0.f, vv = 0.f;
      if (rr < nk) {
        const float* p = base + (long long)(k0 + rr) * c3;
        kv = p[kD + c];
        vv = p[2 * kD + c];
      }
      ks[slot] = kv;
      vs[slot] = vv;
    }
    __syncthreads();

    float s[kBK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* kr = ks + j * kD + half;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) acc = fmaf(q[d], kr[2 * d], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      s[j] = j < nk ? acc : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float mnew = fmaxf(m, mt);
    const float alpha = exp2f(m - mnew);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = exp2f(s[j] - mnew);
      l += p;
      const float* vr = vs + j * kD + half;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) o[d] = fmaf(p, vr[2 * d], o[d]);
    }
    m = mnew;
  }

  if (qvalid) {
    float* dst = out + ((long long)b * seq + qi) * heads * kD + h * kD + half * kHalf;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) dst[d] = o[d] * inv;
    if (lse != nullptr && half == 0) {
      lse[((long long)b * heads + h) * seq + qi] = (m + log2f(l)) * kLn2;
    }
  }
}

}  // namespace

// qkv [batch, seq, 3*heads*64] and out [batch, seq, heads*64], contiguous,
// both float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1). lse is null or f32
// [batch, heads, seq]: the natural log-sum-exp of each row's logits
// scale^2 * q.k. qscale is scale^2 * log2(e). Returns cudaGetLastError()
// after the launch.
extern "C" int packed_attention_fwd_launch(const void* qkv, void* out, void* lse, int batch,
                                           int seq, int heads, float qscale,
                                           int is_bf16, void* stream) {
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_attention_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBf16));
    if (err != cudaSuccess) return static_cast<int>(err);
    packed_attention_fwd_bf16<<<grid, kThreads, kSmemBf16, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), seq, heads, qscale);
  } else {
    packed_attention_fwd_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(lse), seq,
        heads, qscale);
  }
  return static_cast<int>(cudaGetLastError());
}
