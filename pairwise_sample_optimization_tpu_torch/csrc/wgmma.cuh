// Hopper warpgroup-product helpers shared by the flash-attention kernels
// built on wgmma (the bf16 forward at head dims 40, 64, 80, 160 and 512,
// the bf16 backward at 40, 64, 80 and 160): the swizzled shared-memory layouts that cp.async
// writes and wgmma reads, the shared-memory matrix descriptors, the wgmma
// instructions and the fences around them, and the bulk reductions that
// add a shared-memory tile into global memory.
//
// Layouts (CUTLASS's canonical GMMA layouts, bf16):
// - a row of 64 values (128 bytes) is one row of the 128-byte swizzle:
//   16-byte chunk ch of row r sits at r * 128 + ((ch ^ (r % 8)) * 16);
//   tiles are 1024-byte aligned, 8-row groups 1024 bytes apart;
// - a row of 16 values (32 bytes) is one row of the 32-byte swizzle:
//   chunk ch of row r at r * 32 + ((ch ^ ((r / 4) % 2)) * 16); tiles are
//   256-byte aligned, 8-row groups 256 bytes apart.
// A head dim of 64 * n + r (r a multiple of 8 below 64) is stored as n
// blocks of 64 columns in the 128-byte swizzle followed by ceil(r / 16)
// blocks of 16 columns in the 32-byte one (d = 80: one; 160: two; 40: three,
// the last holding columns 32..39 and 8 zero-filled columns). Read K-major
// (the k of the product runs along the row) a block gives 4 or 1 k-steps
// of 16; read MN-major (the k runs down the rows) it gives an n of 64 or 16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace pso {

__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return (uint32_t)(r * 128 + ((ch ^ (r & 7)) << 4));
}
__device__ __forceinline__ uint32_t sw32(int r, int ch) {
  return (uint32_t)(r * 32 + ((ch ^ ((r >> 2) & 1)) << 4));
}

// The column blocks of a row of D bf16 values: 128-byte-swizzled blocks of
// 64 columns, then 32-byte-swizzled blocks of 16; the 16-byte chunks a row
// holds (a zero-filled one where D % 16 == 8); a 64-row tile's bytes.
template <int D>
struct RowBlocks {
  static_assert(D % 8 == 0, "head dim: a multiple of 8");
  static constexpr int FULL = D / 64, TAILS = (D % 64 + 15) / 16;
  static constexpr int CHUNKS = D / 8, SLOTS = 8 * FULL + 2 * TAILS;
  static constexpr int TILE = 64 * (128 * FULL + 32 * TAILS);
};

// Start copying rows [row0, row0 + ROWS) of one head, D bf16 values each,
// into the swizzled tile at shared address dst (column blocks of ROWS rows
// one after the other, as above); rows at or past n, and the pad chunk of a
// head dim that is not a multiple of 16, are zero-filled, their source
// clamped to a real address. A copy of more than 8 chunks a thread (the
// d = 512 tiles) is unrolled by 4 only: fully unrolled, its addresses would
// take registers from the 128 of O that stay live across it. Where the
// threads do not divide the tile's chunks (64 rows of d = 40 or 80 over 256
// threads) the last round's surplus threads copy nothing.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void copy_rows_swz(uint32_t dst, const __nv_bfloat16* src,
                                              long long row_stride, int row0, int n) {
  using RB = RowBlocks<D>;
  constexpr int FULL = RB::FULL, SLOTS = RB::SLOTS, TOTAL = ROWS * SLOTS;
  constexpr int ITERS = (TOTAL + NTHREADS - 1) / NTHREADS;
  auto chunk = [&](int it) {
    const unsigned i = threadIdx.x + it * NTHREADS;  // unsigned: / and % fold to shifts
    if (TOTAL % NTHREADS != 0 && i >= (unsigned)TOTAL) return;
    const int r = i / SLOTS, c = i % SLOTS;
    const int row = row0 + r, src_row = row < n ? row : n - 1, blk = c >> 3;
    const int tb = RB::TAILS > 1 ? (c - 8 * FULL) >> 1 : 0;  // 32-byte block of a tail chunk
    const uint32_t off = blk < FULL ? blk * (ROWS * 128) + sw128(r, c & 7)
                                    : FULL * (ROWS * 128) + tb * (ROWS * 32) + sw32(r, c & 1);
    const bool real = SLOTS == RB::CHUNKS || c < RB::CHUNKS;
    cp_async_16(dst + off, src + (long long)src_row * row_stride + (real ? c * 8 : 0),
                row < n && real);
  };
  if constexpr (ITERS <= 8) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) chunk(it);
  } else {
#pragma unroll 4
    for (int it = 0; it < ITERS; ++it) chunk(it);
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (1: 128-byte swizzle, 3: 32-byte).
// The stride offset is the distance between 8-row groups; the leading one,
// for an MN-major operand, between blocks of 64 columns (unused where the
// product's n is one block, and for K-major swizzled operands).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return smem_desc(addr, lbo_bytes, 1024, 1);
}
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo_bytes = 256) {
  return smem_desc(addr, lbo_bytes, 256, 3);
}
// Advancing a K-major descriptor by one k-step of 16 values (32 bytes of a
// row) adds 2; an MN-major one by 16 rows adds 128 (128-byte rows) or 32
// (32-byte rows), all in 16-byte units. An MN-major operand of several
// 16-column blocks (n = 48) gives their distance as the leading offset.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmma are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// This thread's cp.async writes (or plain stores), made visible to the
// async proxy's reads (wgmma, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk asynchronous reduction (one thread starts it): dst[i] += src[i] for
// the bytes / 4 floats at shared address src, into global memory at dst,
// each element added atomically. Both 16-byte aligned, bytes a multiple of
// 16. Committed and waited for as bulk groups.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N bulk groups still reading their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// At most N bulk groups not complete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

#define PSO_ACC32(c)                                                                       \
  "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]), "+f"(c[1][1]), \
      "+f"(c[1][2]), "+f"(c[1][3]), "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]),            \
      "+f"(c[2][3]), "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),            \
      "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]), "+f"(c[5][0]),            \
      "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]), "+f"(c[6][0]), "+f"(c[6][1]),            \
      "+f"(c[6][2]), "+f"(c[6][3]), "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])

// Accumulators: a 64 x N fp32 tile over the warpgroup; warp w holds rows
// 16w..16w+15 as N / 8 m16n8 fragments c[n-tile][4] (pso::acc_to_a's
// layout).

// c = [c +] A B (m64n64k16), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&c)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : PSO_ACC32(c)
      : "l"(da), "l"(db), "r"(accumulate));
}

// c = [c +] A B (m64n64k16), A and B MN-major in shared memory (both
// transposed by the instruction: the k of the product runs down the rows).
__device__ __forceinline__ void wgmma_ss_tt(float (&c)[8][4], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : PSO_ACC32(c)
      : "l"(da), "l"(db), "r"(accumulate));
}

// c += A B (m64n64k16) with A (this warp's 16x16 slice) in registers and B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&c)[8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : PSO_ACC32(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef PSO_ACC32

// The same with n = 16 (a 32-byte-swizzled B block).
__device__ __forceinline__ void wgmma_rs_mn_n16(float (&c)[2][4], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]),
        "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with n = 16 (a 32-byte-swizzled B block).
__device__ __forceinline__ void wgmma_ss_tt_n16(float (&c)[2][4], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]),
        "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// n = 48 over three 32-byte-swizzled B blocks of 16 columns (d = 40's row),
// read MN-major through one descriptor whose leading byte offset is the
// distance between the blocks: A from registers, or MN-major in shared memory.
#define PSO_ACC24(c)                                                                       \
  "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]), "+f"(c[1][1]), \
      "+f"(c[1][2]), "+f"(c[1][3]), "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]),            \
      "+f"(c[2][3]), "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),            \
      "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]), "+f"(c[5][0]),            \
      "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3])
__device__ __forceinline__ void wgmma_rs_mn_n48(float (&c)[6][4], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}, "
      "{%24,%25,%26,%27}, %28, p, 1, 1, 1;\n}\n"
      : PSO_ACC24(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_tt_n48(float (&c)[6][4], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      : PSO_ACC24(c)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef PSO_ACC24

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}

// P (or dS) stays in its registers until the wgmma that reads it is done.
template <int N>
__device__ __forceinline__ void fence_a(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
    asm volatile("" ::"r"(a[kk][0]), "r"(a[kk][1]), "r"(a[kk][2]), "r"(a[kk][3]));
}

}  // namespace pso
