// Split-precision TF32 products on Hopper's tensor cores ("3xTF32"), the
// building blocks of the f32 attention kernels K1 and K4.
//
// Each f32 operand x is split into hi = tf32_rn(x) (cvt.rna.tf32.f32) and
// lo = tf32_rn(x - hi), so x = hi + lo to about 2^-22 |x|. A product of two
// such operands is taken as lo*hi + hi*lo + hi*hi, small terms first, with
// f32 accumulation (see mma3): the dropped lo*lo is about 2^-22 relative, so
// the result stays near f32 accuracy. At 494.7 TFLOP/s of dense TF32, three
// products per f32 product give ~165 TFLOP/s of f32-accurate work, against
// 67 TFLOP/s on the CUDA cores.
//
// The products are mma.sync m16n8k8 .tf32 (not wgmma: its tf32 form takes
// both shared-memory operands K-major only, and the backward needs Q^T, K^T,
// dO^T, P^T and dS^T as operands). Fragments are read from shared memory by
// plain loads, in whichever layout an operand needs.
//
// Fragment layouts of m16n8k8 (lane = 4 g + t):
// - A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// - B (8 x 8, k x n): b0 (k = t, n = g), b1 (k = t + 4, n = g);
// - C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// An accumulator's columns 2t and 2t + 1 are not the A operand's columns t
// and t + 4. So when a product's result (P, dS) is the next product's A, the
// 8 tokens of its k step are taken in the order 0 2 4 6 1 3 5 7 (k index t
// holds token 2t, k index t + 4 token 2t + 1), and the B operand's rows are
// read in the same order (b0 from token 2t, b1 from 2t + 1): the sum over the
// step is the same, and P never leaves the registers.
//
// Staged tiles are 64 rows x 64 f32 with a row stride of kLd = 68 floats: the
// fragment loads of both orientations (row g and column t, or row 2t and
// column g) then fall on 32 different banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

constexpr int kRows = 64;
constexpr int kLd = 68;                // row stride of a staged tile, in floats
constexpr int kTileF = kRows * kLd;    // floats (or tf32 words) in one staged tile

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));  // x - hi is exact in f32
}

// d (16 x 8, four f32) += A B.
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// t = A B into a fresh accumulator.
__device__ __forceinline__ void mma_zero(float (&t)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += A B to near f32 accuracy, for a running sum (O, dK, dV, dQ: summed
// over every tile of the walk): the k step's lo*hi + hi*lo + hi*hi, small
// terms first, into a fresh accumulator that is then added to d on the CUDA
// cores. The tensor cores round their f32 accumulator toward zero, so a walk
// summed in it drifts with its length (5e-6 from f64 at T = 1024, measured
// on the H100); a step's sum keeps the drift to the step, and the walk's
// adds round to nearest.
__device__ __forceinline__ void mma3(float* d, const FragA& a, const FragB& b) {
  float t[4];
  mma_zero(t, a.lo, b.hi[0], b.hi[1]);
  mma(t, a.hi, b.lo[0], b.lo[1]);
  mma(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// d += A B to near f32 accuracy, summed in the tensor cores' accumulator:
// for a product that starts from zero in every tile (S, dP), whose drift
// stays that of one tile's 8 steps. Both kinds of sum together hold 1.1e-6
// from f64 at T = 1024 (the plain version in f32: 5e-7; the CPU model in
// tests/test_torch_attention_tf32.py), and the tile products cost no adds.
__device__ __forceinline__ void mma3_tile(float* d, const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// A fragment split from f32 values of a staged (not yet split) tile.
__device__ __forceinline__ void load_a_split(FragA& a, const float* raw, int m0, int k0, int g,
                                             int t) {
  const int i = (m0 + g) * kLd + k0 + t;
  const int idx[4] = {i, i + 8 * kLd, i + 4, i + 8 * kLd + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) split(raw[idx[e]], a.hi[e], a.lo[e]);
}

// A fragment from a 16 x 8 accumulator c (c0..c3) whose 8 columns are the
// k step's tokens, in the token order of the header note.
__device__ __forceinline__ void a_from_acc(FragA& a, const float* c) {
  split(c[0], a.hi[0], a.lo[0]);  // (g, token 2t)
  split(c[2], a.hi[1], a.lo[1]);  // (g + 8, token 2t)
  split(c[1], a.hi[2], a.lo[2]);  // (g, token 2t + 1)
  split(c[3], a.hi[3], a.lo[3]);  // (g + 8, token 2t + 1)
}

// B fragment with n = rows [n0, n0 + 8) and k = columns [k0, k0 + 8) of a
// split tile (B = tile^T: a product over the tile's columns, e.g. Q K^T).
__device__ __forceinline__ void load_b_rows(FragB& b, const uint32_t* hi, const uint32_t* lo,
                                            int n0, int k0, int g, int t) {
  const int i = (n0 + g) * kLd + k0 + t;
  b.hi[0] = hi[i];
  b.hi[1] = hi[i + 4];
  b.lo[0] = lo[i];
  b.lo[1] = lo[i + 4];
}

// B fragment with k = rows [k0, k0 + 8) in the token order of a_from_acc and
// n = columns [n0, n0 + 8) of a split tile (a product over the tile's rows,
// e.g. P V).
__device__ __forceinline__ void load_b_cols(FragB& b, const uint32_t* hi, const uint32_t* lo,
                                            int k0, int n0, int g, int t) {
  const int i = (k0 + 2 * t) * kLd + n0 + g;
  b.hi[0] = hi[i];
  b.hi[1] = hi[i + kLd];
  b.lo[0] = lo[i];
  b.lo[1] = lo[i + kLd];
}

// ------------------------------------------------------------------ staging
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copies rows [row0, row0 + 64) x 64 f32 of a row-major source (row stride
// ld floats, 16-byte aligned rows) into a staged tile by 16-byte
// asynchronous copies; rows at or past `seq` read as zeros. The caller
// commits and waits.
__device__ __forceinline__ void stage(float* dst, const float* src, long long ld, int row0,
                                      int seq) {
  for (int e = threadIdx.x; e < kRows * 16; e += blockDim.x) {
    const int r = e / 16;
    const int c = (e % 16) * 4;
    const bool ok = row0 + r < seq;
    cp_async16(dst + r * kLd + c, ok ? src + (long long)(row0 + r) * ld + c : src, ok);
  }
}

// Splits a staged tile into its hi and lo tiles, once per block. The hi
// tile may be the staged tile itself (a split in place).
__device__ __forceinline__ void split_tile(uint32_t* hi, uint32_t* lo, const float* raw) {
  for (int e = threadIdx.x; e < kRows * 16; e += blockDim.x) {
    const int off = (e / 16) * kLd + (e % 16) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

}  // namespace tf32
