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
// at 24 chunks, compares each chunk with all 1024 pixels (one-hot, for its
// vector and matrix units) and reads the range twice, once per pass. This
// kernel has no cap and no padding, and reads each fragment once.
//
// What bounds it on the H100: bytes. It must read the 20 bytes (lp, z,
// payload) of each fragment that falls on a pixel once and write 20 bytes
// per pixel: at the bench shape (733,184 fragments, 144 tiles) 17.6 MB,
// 5.3 us at 3.35 TB/s; on a training step's warp render (8 x 384^2, ~3.65M
// valid fragments) about 97 MB, ~29 us. At the bench shape there are barely
// more tiles (144) than SMs (132), so a block's own instructions per
// fragment, not the card's bandwidth, set its pace; the design keeps them
// few.
//
// Design:
// - One pass. Per pixel the result is the reduction of its fragments
//   (z, pay, 1) under one associative operator, `combine`: the smaller
//   depth, and the sums and counts of the sides whose depth equals it (the
//   ties). Folded into a start of (9.0, 0, 0) it gives exactly the two
//   passes' result: z <= zbuf is z == the minimum when the minimum is at most
//   9.0, and no fragment when it is above. So nothing is read twice.
// - Search only where it can matter. The fragments that fall on no pixel
//   (lp >= 1024) sort last, and only the last tile holds them (the warp
//   render's ~0.5M). lp[e-1] says whether a range ends in them; only then
//   does warp 0 search, probing 32 points a round (4 rounds for 0.5M
//   fragments, not 19 dependent loads).
// - Staged once. The range streams through kStages chunks of kChunk
//   fragments in shared memory (double-buffered): per chunk, one thread
//   starts three bulk copies (1-D TMA: lp, z, payload) from a 4-aligned
//   start, completing on the stage's mbarrier (the array end, if not a whole
//   16 bytes, by 4-byte cp.async copies); the next chunk's copies fly while
//   one is reduced. Per-thread 16-byte cp.async copies of the same chunks
//   were slower: each SM kept few of them in flight, and their traffic
//   stalled the shared-memory loads of the reduction beside them. 20 bytes
//   a fragment: 80 KB of staging and the 20 KB result, two blocks per SM.
// - Fragment-parallel. Thread k owns fragments [8k, 8k + 8) of a chunk; a run
//   of equal lp is a segment, and each pixel's result is stored once, from
//   its segment's total, into the tile's result in shared memory. A thread
//   reduces its fragments in order and stores each segment that starts and
//   ends among them. A segment that comes in from earlier threads takes a
//   carry: the warp's segmented scan of the threads' totals (head flags; one
//   shuffle when every thread of the warp holds a head, a full scan by
//   shuffles only where a segment covers a whole thread), then the warps'
//   totals in warp order, then the segment left open at the previous
//   chunk's end; the thread where it ends stores it. A stacked pixel
//   (thousands of fragments) costs what as many fragments on many pixels
//   cost.
// - Deterministic. The operator's order is fixed by the fragment indices,
//   so two launches on the same inputs give bit-equal outputs. The depth
//   and count are exact; the sums differ from the sequential walk only by
//   rounding.
// Blocks of 256 threads; the result leaves shared memory as float4 rows.

#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;

constexpr int kP = 1024;                    // pixels per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // fragments per thread per chunk
constexpr int kChunk = kThreads * kItems;   // fragments per staged chunk
constexpr int kStages = 2;                  // chunks in shared memory
constexpr float kFar = 9.0f;                // clear depth

struct Stage {
  int lp[kChunk];
  float z[kChunk];
  float pay[3 * kChunk];
};

struct Acc {
  float m, s0, s1, s2, c;  // depth minimum; payload sums and count at it
};

struct Open {
  Acc a;    // the segment open at a chunk's end, from its head on
  int key;  // its lp (-1: none)
};

struct Smem {
  Stage stage[kStages];
  float res[5][kP];        // [zbuf; sum_0; sum_1; sum_2; count]
  Acc warp_acc[kWarps];    // each warp's scan total
  int warp_head[kWarps];   // whether a segment starts in the warp
  Open open[2];            // the open segment after chunk j - 1, at [j & 1]
  uint64_t full[kStages];  // a stage's copies landed
  int end;                 // end of the on-pixel range
};

constexpr size_t kSmem = sizeof(Smem);

__device__ __forceinline__ Acc identity() {
  return {__int_as_float(0x7f800000), 0.f, 0.f, 0.f, 0.f};  // +inf: no fragment
}

// a then b: the smaller depth, and the sums of the sides tied at it.
__device__ __forceinline__ Acc combine(const Acc& a, const Acc& b) {
  const float m = fminf(a.m, b.m);
  const bool ta = a.m == m;
  const bool tb = b.m == m;
  return {m, (ta ? a.s0 : 0.f) + (tb ? b.s0 : 0.f), (ta ? a.s1 : 0.f) + (tb ? b.s1 : 0.f),
          (ta ? a.s2 : 0.f) + (tb ? b.s2 : 0.f), (ta ? a.c : 0.f) + (tb ? b.c : 0.f)};
}

__device__ __forceinline__ Acc shfl_up(const Acc& a, int d) {
  return {__shfl_up_sync(0xffffffffu, a.m, d), __shfl_up_sync(0xffffffffu, a.s0, d),
          __shfl_up_sync(0xffffffffu, a.s1, d), __shfl_up_sync(0xffffffffu, a.s2, d),
          __shfl_up_sync(0xffffffffu, a.c, d)};
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(hopper::smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Store pixel p's result from the total of all its fragments (p outside the
// tile: no pixel): combine((9.0, 0, 0), a), which is a where its depth is
// at most 9.0 and (9.0, 0, 0) where it is above.
__device__ __forceinline__ void store(float (*res)[kP], int p, const Acc& a) {
  if (p < 0 || p >= kP || !(a.m <= kFar)) return;
  res[0][p] = a.m;
  res[1][p] = a.s0;
  res[2][p] = a.s1;
  res[3][p] = a.s2;
  res[4][p] = a.c;
}

// The total that comes into warp `warp` from the warps before it (in warp
// order, back to the nearest one where a segment starts) and, if none
// does, from the segment open at the chunk's start.
__device__ __forceinline__ Acc from_before(const Smem& sm, int warp, const Acc& open) {
  Acc pre = identity();
  for (int w = warp - 1; w >= 0; --w) {
    pre = combine(sm.warp_acc[w], pre);
    if (sm.warp_head[w]) return pre;
  }
  return combine(open, pre);
}

// Start copying the fragments [c0, min(c0 + kChunk, e)) into stage `k` (c0 a
// multiple of 4), from one thread: lp, z and the payload of the whole groups
// of 4 fragments (16-byte multiples) by three bulk copies (1-D TMA)
// completing on the stage's barrier, the group that holds e, if e is no
// multiple of 4, by 4-byte cp.async copies, which the thread waits for
// before the next block-wide barrier.
__device__ __forceinline__ void load_chunk(Smem& sm, int k, const int* lp, const float* z,
                                           const float* pay, int c0, int e) {
  Stage& st = sm.stage[k];
  const int n = min(kChunk, e - c0);
  const int whole = n & ~3;
  // The stage was last read through the generic proxy; the copies write it
  // through the async one.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(&sm.full[k], whole * 20);
  if (whole > 0) {
    bulk_load(st.lp, lp + c0, whole * 4, &sm.full[k]);
    bulk_load(st.z, z + c0, whole * 4, &sm.full[k]);
    bulk_load(st.pay, pay + 3LL * c0, whole * 12, &sm.full[k]);
  }
  for (int i = whole; i < n; ++i) {
    cp_async4(&st.lp[i], lp + c0 + i);
    cp_async4(&st.z[i], z + c0 + i);
    for (int ch = 0; ch < 3; ++ch) cp_async4(&st.pay[3 * i + ch], pay + 3LL * (c0 + i) + ch);
  }
  cp_commit();
}

// First index of [s, e) whose lp is >= kP, given lp[e - 1] >= kP; the range
// is sorted by lp. One warp, 32 probes a round.
__device__ int search_end(const int* lp, int s, int e) {
  const int lane = threadIdx.x & 31;
  int lo = s, hi = e - 1;  // the answer lies in [lo, hi]; lp[hi] >= kP
  while (hi - lo > 31) {
    const int probe = lo + static_cast<int>((long long)(hi - lo) * (lane + 1) / 33);
    const unsigned ge = __ballot_sync(0xffffffffu, lp[probe] >= kP);
    const int first = ge ? __ffs(ge) - 1 : 32;
    const int below = __shfl_sync(0xffffffffu, probe, first == 0 ? 0 : first - 1);
    const int at = __shfl_sync(0xffffffffu, probe, first == 32 ? 31 : first);
    if (first == 32) {
      lo = at + 1;
    } else {
      hi = at;
      if (first > 0) lo = below + 1;
    }
  }
  const int i = lo + lane;
  const unsigned ge = __ballot_sync(0xffffffffu, i <= hi && lp[i] >= kP);
  return lo + __ffs(ge) - 1;
}

__global__ void __launch_bounds__(kThreads, 2)
tile_resolve(const int* __restrict__ bounds, const int* __restrict__ lp,
             const float* __restrict__ z, const float* __restrict__ pay,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = bounds[blockIdx.x];
  const int e = bounds[blockIdx.x + 1];
  const int base = s & ~3;
  // The first chunks' copies start before the search: past the on-pixel
  // end they are wasted, never wrong.
  const int issued = e > s ? min(kStages - 1, (e - base + kChunk - 1) / kChunk) : 0;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) hopper::mbar_init(&sm.full[k], 1);
    hopper::mbar_fence_init();
    for (int j = 0; j < issued; ++j) load_chunk(sm, j, lp, z, pay, base + j * kChunk, e);
  }
  for (int i = tid; i < 5 * kP; i += kThreads) (&sm.res[0][0])[i] = i < kP ? kFar : 0.f;
  if (tid == 0) sm.open[0] = {identity(), -1};
  if (warp == 0) {
    int end = e;
    if (e > s && lp[e - 1] >= kP) end = search_end(lp, s, e);
    if (lane == 0) sm.end = end;
  }
  __syncthreads();
  const int end = sm.end;
  const int chunks = end > s ? (end - base + kChunk - 1) / kChunk : 0;

  for (int j = 0; j < chunks; ++j) {
    mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // chunk j landed; chunk j - 1's stage is free
    if (tid == 0 && j + kStages - 1 < chunks) {
      load_chunk(sm, (j + kStages - 1) % kStages, lp, z, pay, base + (j + kStages - 1) * kChunk,
                 e);
    }
    const Stage& st = sm.stage[j % kStages];
    const int c0 = base + j * kChunk;
    const int i0 = kItems * tid;  // the thread's first fragment in the chunk
    // The thread's fragments, as 16-byte loads. Segment keys: lp inside
    // [s, end), -1 outside (its own segment, never folded, like every lp
    // outside [0, 1024)).
    int key[kItems];
    Acc v[kItems];
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 l4 = *reinterpret_cast<const int4*>(&st.lp[i0 + 4 * q]);
      const float4 z4 = *reinterpret_cast<const float4*>(&st.z[i0 + 4 * q]);
      const float4* p4 = reinterpret_cast<const float4*>(&st.pay[3 * (i0 + 4 * q)]);
      const float4 pa = p4[0], pb = p4[1], pc = p4[2];
      const int l[4] = {l4.x, l4.y, l4.z, l4.w};
      v[4 * q] = {z4.x, pa.x, pa.y, pa.z, 1.f};
      v[4 * q + 1] = {z4.y, pa.w, pb.x, pb.y, 1.f};
      v[4 * q + 2] = {z4.z, pb.z, pb.w, pc.x, 1.f};
      v[4 * q + 3] = {z4.w, pc.y, pc.z, pc.w, 1.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int g = c0 + i0 + 4 * q + k;
        key[4 * q + k] = g >= s && g < end ? l[k] : -1;
      }
    }
    // The keys just before and after the thread's fragments. The chunk's
    // first fragment follows the segment left open at the previous chunk's
    // end; its last fragment leaves its segment open.
    const Open open = sm.open[j & 1];
    int prev = __shfl_up_sync(0xffffffffu, key[kItems - 1], 1);
    int next = __shfl_down_sync(0xffffffffu, key[0], 1);
    if (lane == 0) {
      const int g = c0 + i0 - 1;
      prev = i0 == 0 ? open.key : (g >= s && g < end ? st.lp[i0 - 1] : -1);
    }
    if (lane == 31) {
      const int g = c0 + i0 + kItems;
      next = i0 + kItems == kChunk ? key[kItems - 1] : (g < end ? st.lp[i0 + kItems] : -1);
    }
    const bool first_head = key[0] != prev;
    // The open segment ended with the previous chunk.
    if (tid == 0 && first_head) store(sm.res, open.key, open.a);
    // In order: `lead` sums the fragments before the thread's first head
    // (a segment from earlier threads or chunks), `run` the segment since
    // the last head; a segment that starts and ends here is stored at once.
    bool has_head = false;
    Acc lead = identity(), run = identity();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool head = k == 0 ? first_head : key[k] != key[k - 1];
      const bool tail = key[k] != (k + 1 < kItems ? key[k + 1] : next);
      if (head && !has_head) lead = run;
      run = head ? v[k] : combine(run, v[k]);
      has_head |= head;
      if (tail && has_head) store(sm.res, key[k], run);
    }
    if (!has_head) lead = run;
    // Inclusive segmented scan of the threads' totals over the warp's lanes:
    // (whether a segment starts in the thread, the total since its last head
    // or, with none, of all its fragments).
    bool f = has_head;
    Acc inc = run;
    if (__any_sync(0xffffffffu, !has_head)) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Acc o = shfl_up(inc, d);
        const bool of = __shfl_up_sync(0xffffffffu, f, d);
        if (lane >= d) {
          if (!f) inc = combine(o, inc);
          f |= of;
        }
      }
    }
    if (lane == 31) {
      sm.warp_acc[warp] = inc;
      sm.warp_head[warp] = f;
    }
    // What comes in from the lanes before: the scan shifted up by one.
    Acc carry = shfl_up(inc, 1);
    const bool cf = __shfl_up_sync(0xffffffffu, f, 1) && lane > 0;
    if (lane == 0) carry = identity();
    __syncthreads();
    if (!first_head && (has_head || key[kItems - 1] != next)) {
      // The segment from earlier threads or chunks ends here.
      if (!cf) carry = combine(from_before(sm, warp, open.a), carry);
      store(sm.res, key[0], combine(carry, lead));
    }
    if (tid == kThreads - 1) {
      // The segment open at the chunk's end, for the next chunk.
      sm.open[(j + 1) & 1] = {f ? inc : combine(from_before(sm, warp, open.a), inc),
                              key[kItems - 1]};
    }
  }
  __syncthreads();
  if (tid == 0 && chunks > 0) store(sm.res, sm.open[chunks & 1].key, sm.open[chunks & 1].a);
  // Copies the search made needless still land before the block ends.
  for (int j = chunks; j < issued; ++j) mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
  cp_wait_all();
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + (long long)blockIdx.x * 5 * kP);
  const float4* r = reinterpret_cast<const float4*>(&sm.res[0][0]);
  for (int i = tid; i < 5 * kP / 4; i += kThreads) o[i] = r[i];
}

}  // namespace

// bounds [tiles + 1] int32 (non-decreasing), lp [N] int32, z [N] f32,
// pay [N, 3] f32, all contiguous on the device and 16-byte aligned, each
// tile's range sorted by lp; out [tiles, 5, 1024] f32, 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int tile_resolve_launch(const void* bounds, const void* lp, const void* z,
                                   const void* pay, void* out, int tiles, void* stream) {
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[hopper::kMaxDevices] = {};
  const cudaError_t err = hopper::smem_opt_in(tile_resolve, kSmem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_resolve<<<tiles, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bounds), static_cast<const int*>(lp),
      static_cast<const float*>(z), static_cast<const float*>(pay), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
