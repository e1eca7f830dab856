// Hopper (sm_90a) building blocks of the attention kernels: mbarriers, TMA
// tile loads, and warpgroup matrix multiplies (wgmma m64n64k16, bf16 inputs,
// f32 accumulators in registers).
//
// Tiles are 64 rows x 64 bf16 (128 bytes a row), loaded by TMA with the
// 128-byte swizzle into 1024-byte aligned shared memory, which is the layout
// a wgmma descriptor with the 128-byte swizzle reads:
// - as a K-major operand (rows are M or N, the 64 values of a row are K):
//   one k16 step is 32 bytes further along the row, so the descriptor's
//   start address advances by 2 (16-byte units);
// - as an MN-major B operand with the transpose bit (rows are K, the 64
//   values of a row are N): one k16 step is 16 rows, 2048 bytes, so the
//   start address advances by 128.
// In both, 8-row groups are 1024 bytes apart. Both offset fields of the
// descriptor are set to 1024 bytes: the one that is not used at N = 64 is
// then harmless whichever it is.
//
// Register layouts (per warp w of the warpgroup, lane = 4 g + t):
// - accumulator d[32] of a 64x64 product: d[4j + e] holds row 16 w + g
//   (e = 0, 1) or 16 w + g + 8 (e = 2, 3), column 8 j + 2 t + (e & 1);
// - A operand of one k16 step kk, four 32-bit registers of bf16 pairs:
//   {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
//   {d[8kk+6], d[8kk+7]} of an accumulator whose columns are that step's K,
//   so a product's f32 result becomes the next product's A without leaving
//   the registers (pack_bf16).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 64 * 2;  // one 64 x 64 bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle
// repeats every 8 rows of 128 bytes); launches reserve 1024 bytes for it.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ------------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` of copies to complete on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A copy that never
// lands (a fault, not a slow copy: each try waits up to a hardware time
// limit) traps after 2^26 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// ----------------------------------------------------------------------- TMA
// One box of a 3D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A tensor map over a contiguous bf16 array [depth, rows, cols] read in
// 64 x 64 boxes with the 128-byte swizzle; rows past `rows` read as zeros.
// Returns false if the driver refuses it (cols * 2 must be a multiple of 16
// and the base 16-byte aligned).
inline bool make_tile_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                          uint64_t depth) {
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * 2, cols * rows * 2};
  const cuuint32_t box[3] = {64, kTileRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Above 48 KB of dynamic shared memory a kernel must opt in. The attribute
// is per device, and setting it costs host time, so it is set once per
// device: `done` is the caller's flag array of kMaxDevices entries.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel* kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// --------------------------------------------------------------------- wgmma
// Descriptor of a 64-row tile with the 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
constexpr uint64_t kStepK = 2;     // descriptor advance of one k16 step, K-major
constexpr uint64_t kStepMN = 128;  // descriptor advance of one k16 step, MN-major

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most the N most recently committed groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator across the asynchronous
// product: call after the wg_wait that covers it, before reading it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D32_OPS(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B^T (d = A B^T when `accumulate` is 0), A and B K-major tiles in
// shared memory: a product over the 64-wide head dimension.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B, A from registers (pack_bf16 pairs), B an MN-major tile in shared
// memory (the transpose bit): a product over a 64-row tile of tokens.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_D32
#undef HOPPER_D32_OPS

// 2^x on the special-function unit alone (results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace hopper
