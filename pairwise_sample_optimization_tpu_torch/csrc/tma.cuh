// Hopper's Tensor Memory Accelerator and shared-memory barriers, for the
// kernels whose copies one producer thread issues (the bf16 forward at
// d = 40, the int8 3x3 convolution and matmul): tensor maps built on the
// host, bulk tensor copies into shared memory that complete on an mbarrier,
// the mbarriers' waits and arrivals, and named barriers between warpgroups.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pso {

// ---- host: tensor maps --------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of a (B, S, H, D) bf16 view (strides in elements, the last dim
// contiguous) read as boxes of 16 columns x `rows` rows of one (batch,
// head), 32-byte swizzled (pso::sw32's layout). The map's dims go by
// growing stride: (D, H, S, B) where a head is nearer than a row (the
// packed layout, *hs = 1), else (D, S, H, B); coordinates in that order.
// Rows at or past S and columns at or past D read as zeros.
inline cudaError_t bshd_map(CUtensorMap* map, int* hs, const void* base, int d, int s, int h,
                            int b, long long ss, long long sh, long long sb, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  *hs = sh <= ss;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(*hs ? h : s), (cuuint64_t)(*hs ? s : h),
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(*hs ? sh : ss) * 2,
                                 (cuuint64_t)(*hs ? ss : sh) * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {16, *hs ? 1u : (cuuint32_t)rows, *hs ? (cuuint32_t)rows : 1u, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a dense tensor of `rank` dims (dims[0] contiguous, strides in
// bytes of dims 1.., multiples of 16) read or written as boxes of box[0..rank)
// elements, 128-byte swizzled in shared memory (a box row of 128 bytes is
// one swizzle row; 1024-byte aligned boxes). Coordinates outside the tensor,
// negative ones too, read as zeros and are not written. The int8 3x3
// convolution's NHWC activations (C, W, H, B), (O, 3, 3, C) weights (C, 9,
// O), both UINT8, and bf16 NCHW output (W, H, O, B); the int8 matmul's
// int8 rows (K, M) and (K, N) and its bf16 or fp32 output (N, M).
inline cudaError_t sw128_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             int rank, const long long* dims, const long long* strides,
                             const int* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], estr[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    estr[i] = 1;
    if (i + 1 < rank) st[i] = (cuuint64_t)strides[i];
  }
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, st, bx, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: copies and barriers -----------------------------------------

// One box of a 2-D, 3-D or 4-D map at coordinates (c0, c1[, c2[, c3]]) into
// shared memory at dst; its bytes complete the transaction count of the
// mbarrier at bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// One box of a bshd_map at (column c, row, head, batch).
__device__ __forceinline__ void tma_load_bshd(uint32_t dst, const CUtensorMap* map, int hs, int c,
                                              int row, int head, int batch, uint32_t bar) {
  tma_load_4d(dst, map, c, hs ? head : row, hs ? row : head, batch, bar);
}

// One box of a 2-D or 4-D map written from shared memory at src to
// coordinates (c0, c1[, c2, c3]) (clipped at the tensor's edges); committed
// and waited for as bulk groups (pso::bulk_commit, bulk_wait_read, bulk_wait).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Fetch a tensor map's descriptor (a __grid_constant__ kernel parameter)
// ahead of its first copy.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// The barriers' initialisation, visible to the async proxy (the copies).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that never
// ends is a fault: after 2^24 polls the kernel traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (polls > (1u << 24)) __trap();
  }
}

// Named barriers (ids 1..15) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace pso
