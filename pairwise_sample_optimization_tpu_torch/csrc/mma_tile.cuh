// Tile helpers shared by the flash-attention kernels (forward and backward):
// the m16n8k16 fragment contract computed with exact fp32 FMAs and the
// strided tile copy into shared memory (the fp32 kernels). Below them, the
// register-fragment helpers of the bf16 kernels: cp.async with zero-fill
// and its commit / wait, the base-2 exponential, and the packing of fp32
// accumulators into a bf16 A fragment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pso {

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

// c (16x8 fp32 fragment) += A (16x16, row-major at A, leading dim lda)
//                          * B (16x8; element (k, n) at B[n*ldb + k] when
//                            kBRowsAreN, else at B[k*ldb + n]), in fp32.
// Fragment ownership (PTX m16n8k16): lane = 4*g + t; c[0..1] are row g,
// cols 2t, 2t+1; c[2..3] are row g+8, same cols.
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

// ---- register fragments (m16n8k16, bf16) ----------------------------------
// Fragment ownership as in tile_mma: lane = 4*g + t. An A fragment (16x16) is
// {a0, a1, a2, a3} = rows (g, g+8, g, g+8) x cols (2t, 2t, 8+2t, 8+2t), two
// bf16 each; a B fragment (16x8, element (k, n)) is {b0, b1} = k (2t, 8+2t)
// and k+1 x col n = g.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (what __expf runs after scaling by log2 e).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to one packed bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the 16-column chunk j of a 16-row accumulator tile held
// as m16n8 fragments c[n-tile][4] (n-tiles 2j and 2j+1): a product's output
// becomes the next product's A operand without leaving registers.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int j) {
  a[0] = pack_f32(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_f32(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_f32(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_f32(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// Asynchronous global -> shared copies (sm_80+). With valid == false no
// byte is read and the destination is zero-filled (src-size 0); the caller
// still passes an address inside the tensor.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace pso
