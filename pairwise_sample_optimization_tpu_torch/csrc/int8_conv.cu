// Dynamic int8 on Hopper (sm_90a): the quantize, the 3x3 convolution and the
// dequantize of the opt-in int8 paths (ops/qconv.py).
//
// None of these replaces a TPU kernel. The JAX package computes them in
// pairwise_sample_optimization_tpu/ops/qconv.py with jnp and
// lax.dot_general / lax.conv_general_dilated, outside any Pallas kernel;
// the port needs kernels of its own because PyTorch has no int8
// convolution and no fused absmax-quantize on CUDA.
//
// Q1 (two kernels, launched one after the other):
//   q8_absmax_kernel       per-row absmax over strided rows: a row is n_seg
//                          segments of seg_len contiguous elements, which
//                          covers a token of an (M, K) matrix (one segment),
//                          a sample of an NCHW tensor (C segments of H*W)
//                          and a channel (B segments of H*W); a per-segment
//                          divisor (the SmoothQuant migration, one per
//                          channel of a sample) divides each element first.
//                          Blocks take chunks of a segment and meet in an
//                          atomicMax, which is exact in any order.
//   q8_quantize_rows_kernel  (M, K) -> int8 (M, K) and the scale (M,).
//   q8_quantize_nhwc_kernel  NCHW -> int8 NHWC and the scale (B,), through a
//                          shared-memory transpose, so the convolution reads
//                          its K dimension (channels) contiguously.
//   The scale is s = max(absmax, 1e-8) / 127 and q = clip(rint(v / s),
//   -127, 127): a true division and round-half-to-even, as JAX's jnp.round,
//   so the integers are those of the JAX package and of the plain version.
//   Bound by bytes: each input element is read twice (once per kernel).
// Q2 q8_conv3x3_kernel: 3x3, stride 1, pad 1 convolution of int8 NHWC
//   activations with int8 (O, 3, 3, C) weights as an implicit GEMM
//   (M = B*H*W pixels, N = O, K = 9*C ordered (tap, channel)), on
//   mma.sync.m16n8k32 s8 tensor-core products with int32 accumulators. The
//   tiles come in by cp.async with zero-fill at the image borders and past
//   K, in a 4-stage ring; no im2col copy is made (it would hold 9x the
//   activation). Epilogue: acc * (s_x[b] * s_w[o]) (+ bias[o]) in fp32
//   with explicit _rn operations (no FMA contraction, so the result is
//   that of the plain version's separate fp32 operations), cast, staged in
//   shared memory and written NCHW along pixels. Bound by int8 operations
//   at the decoder's and the UNet's widths.
// Q3 q8_dequant_kernel: the int32 product of torch._int_mm (the int8
//   matmul; JAX leaves it to lax.dot_general) read once, acc * (s_x[row] *
//   s_w[col]) (+ bias[col]) with the same _rn operations, cast. Bound by
//   bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float partial[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float m = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, partial[i]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(q);
}

// ---- Q1a: absmax ------------------------------------------------------------
// Block: one chunk of one segment of one row. The row's maximum is reduced
// with atomicMax on the float's bits (non-negative floats order as their
// bits), into `absmax` zeroed by the entry point: max is exact, so the
// order of the atomics does not change the result.
template <typename T>
__global__ void __launch_bounds__(kThreads) q8_absmax_kernel(
    const T* __restrict__ x, const float* __restrict__ div, float* __restrict__ absmax,
    long long row_stride, int n_seg, long long seg_len, long long seg_stride, int splits,
    long long chunk) {
  const long long blk = blockIdx.x;
  const long long row_seg = blk / splits;
  const int split = static_cast<int>(blk - row_seg * splits);
  const long long row = row_seg / n_seg;
  const int seg = static_cast<int>(row_seg - row * n_seg);
  const long long lo = split * chunk;
  const long long hi = lo + chunk < seg_len ? lo + chunk : seg_len;
  const T* base = x + row * row_stride + seg * seg_stride;
  const float d = div != nullptr ? div[seg] : 1.f;
  float m = 0.f;
  for (long long l = lo + threadIdx.x; l < hi; l += blockDim.x) {
    float v = to_float(base[l]);
    if (div != nullptr) v = __fdiv_rn(v, d);
    m = fmaxf(m, fabsf(v));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(absmax + row), __float_as_int(m));
}

// s = max(absmax, 1e-8) / 127
__device__ __forceinline__ float scale_of(float a) {
  return __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
}

// ---- Q1b: quantize rows ----------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) q8_quantize_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ absmax, int8_t* __restrict__ q,
    float* __restrict__ scale, long long rows, long long k) {
  const long long row = blockIdx.x;
  if (row >= rows) return;
  const float s = scale_of(absmax[row]);
  if (threadIdx.x == 0) scale[row] = s;
  const T* src = x + row * k;
  int8_t* dst = q + row * k;
  for (long long i = threadIdx.x; i < k; i += blockDim.x) dst[i] = quantize(to_float(src[i]), s);
}

// ---- Q1c: quantize NCHW -> NHWC ------------------------------------------
// Block: 32 channels x 32 pixels of one sample; 256 threads (32 x 8).
template <typename T>
__global__ void __launch_bounds__(kThreads) q8_quantize_nhwc_kernel(
    const T* __restrict__ x, const float* __restrict__ div, const float* __restrict__ absmax,
    int8_t* __restrict__ q, float* __restrict__ scale, int channels, long long hw) {
  __shared__ int8_t tile[32][33];
  const int b = blockIdx.z;
  const long long p0 = static_cast<long long>(blockIdx.x) * 32;
  const int c0 = blockIdx.y * 32;
  const float s = scale_of(absmax[b]);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scale[b] = s;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  // read along pixels (contiguous in NCHW)
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i;
    const long long p = p0 + tx;
    int8_t v = 0;
    if (c < channels && p < hw) {
      float f = to_float(x[(static_cast<long long>(b) * channels + c) * hw + p]);
      if (div != nullptr) f = __fdiv_rn(f, div[c]);
      v = quantize(f, s);
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  // write along channels (contiguous in NHWC)
  for (int i = ty; i < 32; i += 8) {
    const long long p = p0 + i;
    const int c = c0 + tx;
    if (c < channels && p < hw) q[(static_cast<long long>(b) * hw + p) * channels + c] = tile[tx][i];
  }
}

// ---- Q2: int8 3x3 convolution as an implicit GEMM ---------------------------
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int LDS = BK + 16;  // bytes a shared row: 80 keeps fragment reads conflict-free
constexpr int kStageBytes = (BM + BN) * LDS;
constexpr int kConvSmem = STAGES * kStageBytes;  // 81,920 bytes
constexpr int LDC = BM + 4;                       // floats a row of the epilogue's staging
static_assert(BN * LDC * 4 <= kConvSmem, "epilogue staging must fit the ring");

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) q8_conv3x3_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias, T* __restrict__ out, int batch,
    int height, int width, int channels, int outc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;  // 2 x 4 warps of 64 x 32
  const long long hw = static_cast<long long>(height) * width;
  const long long M = batch * hw;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * channels;
  const int ktiles = (K + BK - 1) / BK;

  // each thread copies 16 bytes of two A rows and of two B rows per stage, at
  // the same 16-byte column kc
  const int kc = tid & 3;
  int a_b[2], a_oh[2], a_ow[2];
  bool a_ok[2];
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    a_b[i] = static_cast<int>(mm / hw);
    const long long rem = mm - a_b[i] * hw;
    a_oh[i] = static_cast<int>(rem / width);
    a_ow[i] = static_cast<int>(rem - static_cast<long long>(a_oh[i]) * width);
  }

  auto load_stage = [&](int slot, int kt) {
    unsigned char* As = smem + slot * kStageBytes;
    unsigned char* Bs = As + BM * LDS;
    const int k = kt * BK + kc * 16;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / channels : 0;
    const int c = k_ok ? k - tap * channels : 0;
    const int dr = tap / 3 - 1, ds = tap % 3 - 1;
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int ih = a_oh[i] + dr, iw = a_ow[i] + ds;
      const bool ok = a_ok[i] && k_ok && ih >= 0 && ih < height && iw >= 0 && iw < width;
      const int8_t* src =
          ok ? xq + ((static_cast<long long>(a_b[i]) * height + ih) * width + iw) * channels + c
             : xq;
      pso::cp_async_16(pso::smem_u32(As + row * LDS + kc * 16), src, ok);
      const int o = n0 + row;
      const bool okb = k_ok && o < outc;
      pso::cp_async_16(pso::smem_u32(Bs + row * LDS + kc * 16),
                       okb ? wq + static_cast<long long>(o) * K + k : wq, okb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    pso::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    pso::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    pso::cp_async_commit();
    const unsigned char* As = smem + (kt % STAGES) * kStageBytes;
    const unsigned char* Bs = As + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const unsigned char* p = As + (warp_m * 64 + mi * 16 + g) * LDS + ks * 32 + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const unsigned char* p = Bs + (warp_n * 32 + ni * 8 + g) * LDS + ks * 32 + 4 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  pso::cp_async_wait<0>();
  __syncthreads();

  // epilogue: scale (and bias) in fp32 into shared memory as [channel][pixel]
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp_m * 64 + mi * 16 + g + half * 8;
      const long long m = m0 + row;
      if (m >= M) continue;
      const float s_x = sx[m / hw];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = warp_n * 32 + ni * 8 + 2 * t + e;
          const int o = n0 + col;
          if (o >= outc) continue;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]), __fmul_rn(s_x, sw[o]));
          if (bias != nullptr) y = __fadd_rn(y, bias[o]);
          Cs[col * LDC + row] = y;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int col = idx / BM, row = idx % BM;
    const long long m = m0 + row;
    const int o = n0 + col;
    if (m >= M || o >= outc) continue;
    const long long b = m / hw;
    out[(b * outc + o) * hw + (m - b * hw)] = from_f32<T>(Cs[col * LDC + row]);
  }
}

// ---- Q3: dequantize an int32 product ----------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) q8_dequant_kernel(
    const int32_t* __restrict__ acc, const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ out, long long rows, long long cols) {
  const long long n = rows * cols;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / cols, c = i - r * cols;
    float y = __fmul_rn(__int2float_rn(acc[i]), __fmul_rn(sx[r], sw[c]));
    if (bias != nullptr) y = __fadd_rn(y, bias[c]);
    out[i] = from_f32<T>(y);
  }
}

long long grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16;
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 fp32 (the input's for Q1, the output's for Q2 and Q3)
int q8_absmax(int dtype, const void* x, const float* div, float* absmax, long long rows,
              long long row_stride, int n_seg, long long seg_len, long long seg_stride,
              int splits, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(absmax, 0, rows * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows * n_seg * splits));
  if (dtype == 0)
    q8_absmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), div, absmax, row_stride, n_seg, seg_len,
        seg_stride, splits, chunk);
  else
    q8_absmax_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), div, absmax,
                                                      row_stride, n_seg, seg_len, seg_stride,
                                                      splits, chunk);
  return static_cast<int>(cudaGetLastError());
}

int q8_quantize_rows(int dtype, const void* x, const float* absmax, int8_t* q, float* scale,
                     long long rows, long long k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = k >= 1024 ? kThreads : 128;
  if (dtype == 0)
    q8_quantize_rows_kernel<__nv_bfloat16><<<static_cast<unsigned>(rows), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), absmax, q, scale, rows, k);
  else
    q8_quantize_rows_kernel<float><<<static_cast<unsigned>(rows), threads, 0, s>>>(
        static_cast<const float*>(x), absmax, q, scale, rows, k);
  return static_cast<int>(cudaGetLastError());
}

int q8_quantize_nhwc(int dtype, const void* x, const float* div, const float* absmax, int8_t* q,
                     float* scale, int batch, int channels, long long hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((hw + 31) / 32), (channels + 31) / 32, batch);
  if (dtype == 0)
    q8_quantize_nhwc_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), div, absmax, q, scale, channels, hw);
  else
    q8_quantize_nhwc_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), div, absmax, q, scale, channels, hw);
  return static_cast<int>(cudaGetLastError());
}

int q8_conv3x3(int dtype, const int8_t* xq, const int8_t* wq, const float* sx, const float* sw,
               const float* bias, void* out, int batch, int height, int width, int channels,
               int outc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m = static_cast<long long>(batch) * height * width;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), (outc + BN - 1) / BN);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(q8_conv3x3_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    q8_conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, kConvSmem, s>>>(
        xq, wq, sx, sw, bias, static_cast<__nv_bfloat16*>(out), batch, height, width, channels,
        outc);
  } else {
    err = cudaFuncSetAttribute(q8_conv3x3_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    q8_conv3x3_kernel<float><<<grid, kThreads, kConvSmem, s>>>(
        xq, wq, sx, sw, bias, static_cast<float*>(out), batch, height, width, channels, outc);
  }
  return static_cast<int>(cudaGetLastError());
}

int q8_dequant(int dtype, const int32_t* acc, const float* sx, const float* sw, const float* bias,
               void* out, long long rows, long long cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(grid_for(rows * cols));
  if (dtype == 0)
    q8_dequant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        acc, sx, sw, bias, static_cast<__nv_bfloat16*>(out), rows, cols);
  else
    q8_dequant_kernel<float><<<grid, kThreads, 0, s>>>(acc, sx, sw, bias,
                                                       static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
