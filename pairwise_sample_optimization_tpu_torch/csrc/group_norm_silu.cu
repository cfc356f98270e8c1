// Fused GroupNorm + SiLU for NCHW activations on Hopper (sm_90a), as two
// kernels:
//
// K4 gn_stats_kernel replaces pairwise_sample_optimization_tpu/ops/
//    fused_groupnorm.py::_stats_kernel: per-(batch, group) fp32 sum and
//    sum of squares.
// K5 gn_norm_silu_kernel replaces ops/fused_groupnorm.py::_norm_kernel:
//    mean = sum/n, var = sumsq/n - mean^2, then
//    y = silu((x - mean) * rsqrt(var + eps) * gamma + beta) in x's dtype.
//    var is clamped at 0 here, as the plain path (ops/group_norm.py) does;
//    the TPU kernel left it unclamped.
//
// What bounds it on an H100: bytes. x is read twice (once per kernel) and
// y written once, about 10 operations per element, far below the card's
// operations-per-byte line.
//
// Design: in NCHW each (batch, group) slab is contiguous, C/G * H*W
// elements, so no channel->group one-hot product is needed (the TPU kernel
// needed one because Mosaic could not split the lane dim by the group
// size). The TPU kernel carried sums across sequential row tiles; here the
// grid is (B*G slabs) x (splits) so enough blocks run on 132 SMs: K4
// writes one partial (sum, sumsq) per block and K5 adds the slab's few
// partials in a fixed order (deterministic, no atomics) before it
// normalizes its own chunk. Loads and stores are 16-byte vectors; the
// wrapper requires H*W % 8 == 0 so a vector never straddles two channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements of T in one 16-byte vector
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// Sum of a and b over the block; every thread gets the result.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 partial[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = make_float2(a, b);
  __syncthreads();
  float2 tot = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    tot.x += partial[w].x;
    tot.y += partial[w].y;
  }
  return tot;
}

// grid (B*G, splits): partial[(slab * splits + split) * 2 + {0, 1}]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, long long slab_len,
                long long chunk_len) {
  constexpr int VN = kVec<T>;
  const long long slab = blockIdx.x;
  const long long start = blockIdx.y * chunk_len;
  const long long end = min(start + chunk_len, slab_len);
  const T* base = x + slab * slab_len;
  float s = 0.f, ss = 0.f;
  for (long long i = start + (long long)threadIdx.x * VN; i < end; i += (long long)kThreads * VN) {
    const uint4 raw = *reinterpret_cast<const uint4*>(base + i);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const float f = to_float(v[e]);
      s += f;
      ss = fmaf(f, f, ss);
    }
  }
  const float2 tot = block_sum2(s, ss);
  if (threadIdx.x == 0) {
    float* out = partial + (slab * gridDim.y + blockIdx.y) * 2;
    out[0] = tot.x;
    out[1] = tot.y;
  }
}

// grid (B*G, splits)
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_norm_silu_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                    const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ y,
                    long long slab_len, long long chunk_len, int hw, int cg, int groups,
                    float eps) {
  constexpr int VN = kVec<T>;
  const long long slab = blockIdx.x;
  const int g = (int)(slab % groups);
  const float* part = partial + slab * gridDim.y * 2;
  float s = 0.f, ss = 0.f;
  for (int i = 0; i < (int)gridDim.y; ++i) {  // fixed order: deterministic
    s += part[2 * i];
    ss += part[2 * i + 1];
  }
  const float n = (float)slab_len;
  const float mean = s / n;
  const float var = fmaxf(ss / n - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);

  const long long start = blockIdx.y * chunk_len;
  const long long end = min(start + chunk_len, slab_len);
  const long long off = slab * slab_len;
  for (long long i = start + (long long)threadIdx.x * VN; i < end; i += (long long)kThreads * VN) {
    const int c = g * cg + (int)(i / hw);
    const float ga = to_float(gamma[c]), be = to_float(beta[c]);
    const uint4 raw = *reinterpret_cast<const uint4*>(x + off + i);
    const T* vin = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* vout = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const float v = (to_float(vin[e]) - mean) * inv * ga + be;
      vout[e] = from_float<T>(v / (1.f + __expf(-v)));
    }
    *reinterpret_cast<uint4*>(y + off + i) = out;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32. x is (B, C, H*W) contiguous;
// partial is (B*G, splits, 2) fp32.
int gn_stats(int dtype, const void* x, float* partial, int slabs, int splits, long long slab_len,
             long long chunk_len, void* stream) {
  dim3 grid(slabs, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), partial, slab_len, chunk_len);
  else if (dtype == 1)
    gn_stats_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), partial,
                                                     slab_len, chunk_len);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// gamma / beta are (C,) in x's dtype; y is shaped like x.
int gn_silu_norm(int dtype, const void* x, const float* partial, const void* gamma,
                 const void* beta, void* y, int slabs, int splits, long long slab_len,
                 long long chunk_len, int hw, int cg, int groups, float eps, void* stream) {
  dim3 grid(slabs, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_norm_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), partial, static_cast<const __nv_bfloat16*>(gamma),
        static_cast<const __nv_bfloat16*>(beta), static_cast<__nv_bfloat16*>(y), slab_len,
        chunk_len, hw, cg, groups, eps);
  else if (dtype == 1)
    gn_norm_silu_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), partial, static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(y), slab_len, chunk_len, hw, cg,
        groups, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
