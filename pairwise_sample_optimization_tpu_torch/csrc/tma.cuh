// Hopper's Tensor Memory Accelerator and shared-memory barriers, for the
// kernels whose copies one producer thread issues (the bf16 forward at
// d = 40): tensor maps built on the host, bulk tensor copies into shared
// memory that complete on an mbarrier, the mbarriers' waits and arrivals,
// and named barriers between warpgroups.
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

// ---- device: copies and barriers -----------------------------------------

// One box of a bshd_map at (column c, row, head, batch) into shared memory
// at dst; its bytes complete the transaction count of the mbarrier at bar.
__device__ __forceinline__ void tma_load_bshd(uint32_t dst, const CUtensorMap* map, int hs, int c,
                                              int row, int head, int batch, uint32_t bar) {
  const int c1 = hs ? head : row, c2 = hs ? row : head;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(c1), "r"(c2), "r"(batch), "r"(bar)
      : "memory");
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
