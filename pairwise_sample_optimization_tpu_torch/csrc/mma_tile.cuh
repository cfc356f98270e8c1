// Tile helpers shared by the flash-attention kernels (forward and backward):
// conversions, the mma.sync m16n8k16 tile product (bf16 operands, fp32
// accumulation) with its exact-fp32 counterpart, and the strided tile copy
// into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pso {

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c (16x8 fp32 fragment) += A (16x16, row-major at A, leading dim lda)
//                          * B (16x8; element (k, n) at B[n*ldb + k] when
//                            kBRowsAreN, else at B[k*ldb + n]).
// Fragment ownership (PTX m16n8k16): lane = 4*g + t; c[0..1] are row g,
// cols 2t, 2t+1; c[2..3] are row g+8, same cols.
template <bool kBRowsAreN>
__device__ __forceinline__ void tile_mma(float (&c)[4], const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a0 = *reinterpret_cast<const uint32_t*>(A + g * lda + 2 * t);
  uint32_t a1 = *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 2 * t);
  uint32_t a2 = *reinterpret_cast<const uint32_t*>(A + g * lda + 8 + 2 * t);
  uint32_t a3 = *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 8 + 2 * t);
  uint32_t b0, b1;
  if (kBRowsAreN) {
    b0 = *reinterpret_cast<const uint32_t*>(B + g * ldb + 2 * t);
    b1 = *reinterpret_cast<const uint32_t*>(B + g * ldb + 8 + 2 * t);
  } else {
    b0 = pack_bf16(B[(2 * t) * ldb + g], B[(2 * t + 1) * ldb + g]);
    b1 = pack_bf16(B[(2 * t + 8) * ldb + g], B[(2 * t + 9) * ldb + g]);
  }
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The same fragment contract computed with fp32 FMAs (fp32 inputs).
template <bool kBRowsAreN>
__device__ __forceinline__ void tile_mma(float (&c)[4], const float* A, int lda,
                                         const float* B, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
    const float b0 = kBRowsAreN ? B[(2 * t) * ldb + k] : B[k * ldb + 2 * t];
    const float b1 = kBRowsAreN ? B[(2 * t + 1) * ldb + k] : B[k * ldb + 2 * t + 1];
    c[0] = fmaf(a_lo, b0, c[0]);
    c[1] = fmaf(a_lo, b1, c[1]);
    c[2] = fmaf(a_hi, b0, c[2]);
    c[3] = fmaf(a_hi, b1, c[3]);
  }
}

// Copy rows [row0, row0 + rows) of one head into shared memory (leading
// dim ld), zero-filling rows at or past n. 16-byte vectors; the wrapper
// guarantees 16-byte aligned rows.
template <typename T, int D, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long row_stride,
                                          int row0, int rows, int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

}  // namespace pso
