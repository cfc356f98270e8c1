// Dynamic int8 on Hopper (sm_90a): the quantize, the 3x3 convolution and the
// matmul of the opt-in int8 paths (ops/qconv.py).
//
// None of these replaces a TPU kernel. The JAX package computes them in
// pairwise_sample_optimization_tpu/ops/qconv.py with jnp and
// lax.dot_general / lax.conv_general_dilated, outside any Pallas kernel;
// the port needs kernels of its own because PyTorch has no int8
// convolution, no int8 product with a fused dequantize and no fused
// absmax-quantize on CUDA.
//
// Q1 (two kernels, launched one after the other):
//   q8_absmax_kernel       per-row absmax over strided rows: a row is n_seg
//                          segments of seg_len contiguous elements, which
//                          covers a token of an (M, K) matrix (one segment),
//                          a sample of an NCHW tensor (C segments of H*W)
//                          and a channel (B segments of H*W); a per-segment
//                          divisor (the SmoothQuant migration, one per
//                          channel of a sample) divides each element first.
//                          One launch: a warp a short row, or blocks over
//                          chunks of a long one whose last block to finish
//                          takes the rows' maxima (exact in any order).
//   q8_quantize_rows_kernel  (M, K) -> int8 (M, K) and the scale (M,); the
//                          int8 rows optionally padded to 16 bytes (for the
//                          matmul's TMA maps).
//   q8_quantize_nhwc_kernel  NCHW -> int8 NHWC and the scale (B,), through a
//                          shared-memory transpose, so the convolution reads
//                          its K dimension (channels) contiguously.
//   The scale is s = max(absmax, 1e-8) / 127 and q = clip(rint(v / s),
//   -127, 127): a true division and round-half-to-even, as JAX's jnp.round,
//   so the integers are those of the JAX package and of the plain version.
//   Bound by bytes: each input element is read twice (once per kernel);
//   16-byte loads, 8- or 16-byte stores.
// Q2 q8_conv3x3_kernel: 3x3, stride 1, pad 1 convolution of int8 NHWC
//   activations with int8 (O, 3, 3, C) weights as an implicit GEMM on
//   wgmma s8 products fed by TMA (namespace q2 below): a producer warp, two
//   consumer warpgroups, the conv's padding the tensor map's zero fill,
//   a persistent grid, K split over blocks where the tiles do not fill the
//   card (int32 partial sums, the last block to finish adds them: one
//   launch). Epilogue: acc * (s_x[b] * s_w[o]) (+ bias[o]) in fp32 with
//   explicit _rn operations, cast, written NCHW. Bound by int8 operations
//   at the decoder's and the UNet's widths.
// Q3 q8_matmul_kernel: the int8 matmul, int8 (M, K) x int8 (N, K)^T, on
//   the same parts (namespace q8mm below: 2-D tensor maps, M from 1, split
//   K where the tiles leave half the SMs idle), with the dequantize acc *
//   (s_x[m] * s_w[n]) (+ bias[n]) (the same _rn operations) as its
//   epilogue, written by TMA stores: the int32 product never reaches device
//   memory. It takes the place of torch._int_mm and a dequantize pass. Bound
//   by int8 operations at the UNet's wide products, by bytes at narrow ones.
//
// Checks: on the CPU, tests/test_torch_port_int8_plans.py walks the plans
// (ops/qconv.py) as the kernels walk them and tests/test_torch_port_int8.py
// holds the plain versions against the JAX package; on the card,
// chip_smoke.py holds every kernel bit-equal to its plain version at the
// paths' shapes and edges, and scripts/time_port_int8.py times them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(q);
}

// ---- Q1a: absmax ------------------------------------------------------------
// A row is n_seg segments of seg_len contiguous elements, segment s at
// row * row_stride + s * seg_stride. The host's plan (ops/qconv.py::
// absmax_plan) gives each row `tpr` threads (32 to 256: 256 / tpr rows a
// block) and, for a few long rows, `splits` blocks a row, each over `chunk`
// elements of the row's n_seg * seg_len (segment by segment). Unsplit, a
// row's threads write its maximum; split, each block writes its own to
// `partial` and the last block to finish (a counter, counted after a
// fence) takes every row's maximum over its splits, a group of lanes a row,
// and resets the counter for the next launch (one counter a device: split
// launches run one at a time, as the port's single stream runs them). One
// launch a call, nothing zeroed first; max is exact, so neither the order
// of the blocks nor that of the loads changes a bit of the result. Loads are 16 bytes where the
// piece is aligned (a scalar head and tail around them), 4 in flight a
// thread.
__device__ unsigned int g_absmax_done = 0;  // blocks done in the running launch

template <bool DIV>
__device__ __forceinline__ float absf(float v, float d) {
  return fabsf(DIV ? __fdiv_rn(v, d) : v);
}

template <bool DIV>
__device__ __forceinline__ float vec_max(uint4 u, float d, float m, const float*) {
  m = fmaxf(m, fmaxf(absf<DIV>(__uint_as_float(u.x), d), absf<DIV>(__uint_as_float(u.y), d)));
  return fmaxf(m, fmaxf(absf<DIV>(__uint_as_float(u.z), d), absf<DIV>(__uint_as_float(u.w), d)));
}
template <bool DIV>
__device__ __forceinline__ float vec_max(uint4 u, float d, float m, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(m, fmaxf(absf<DIV>(__uint_as_float(w[i] << 16), d),
                       absf<DIV>(__uint_as_float(w[i] & 0xffff0000u), d)));
  return m;
}

// This thread's maximum of |p[i] (/ d)| over its share (i = tid, tid +
// NTH, ...) of n contiguous elements, folded into m.
template <typename T, bool DIV, int NTH, int UNROLL = 4>
__device__ __forceinline__ float piece_max(const T* p, int n, float d, int tid, float m) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
  const int head = min(n, mis ? V - mis : 0);
  if (tid < head) m = fmaxf(m, absf<DIV>(to_float(p[tid]), d));
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  const int nv = (n - head) / V;
  int i = tid;
  for (; i + (UNROLL - 1) * NTH < nv; i += UNROLL * NTH) {
    uint4 u[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) u[k] = __ldg(pv + i + k * NTH);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) m = vec_max<DIV>(u[k], d, m, p);
  }
  for (; i < nv; i += NTH) m = vec_max<DIV>(__ldg(pv + i), d, m, p);
  const int e = head + nv * V + tid;
  if (e < n) m = fmaxf(m, absf<DIV>(to_float(p[e]), d));
  return m;
}

// The maximum of m over groups of `lanes` (a power of 2 up to 32) lanes.
__device__ __forceinline__ float group_max(float m, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <typename T, bool DIV, int TPR>
__global__ void __launch_bounds__(kThreads) q8_absmax_kernel(
    const T* __restrict__ x, const float* __restrict__ div, float* __restrict__ absmax,
    float* __restrict__ partial, long long rows, long long row_stride, int n_seg, int seg_len,
    long long seg_stride, int splits, int chunk) {
  constexpr int PER_BLOCK = kThreads / TPR;
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x / splits) * PER_BLOCK + threadIdx.x / TPR;
  const int split = static_cast<int>(blockIdx.x % splits);
  const int lo = split * chunk, hi = min(lo + chunk, n_seg * seg_len);
  float m = 0.f;
  if (row < rows) {
    const T* base = x + row * row_stride;
    for (int s = lo / seg_len; s * seg_len < hi; ++s) {  // segment by segment
      const int a = max(lo, s * seg_len) - s * seg_len, b = min(hi, (s + 1) * seg_len) - s * seg_len;
      m = piece_max<T, DIV, TPR>(base + s * seg_stride + a, b - a, DIV ? div[s] : 1.f, tid, m);
    }
  }
  m = group_max(m, 32);
  if constexpr (TPR > 32) {  // a row's warps meet in shared memory
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (tid == 0)
      for (int w = 1; w < TPR / 32; ++w) m = fmaxf(m, warp_max[warp + w]);
  }
  if (splits == 1) {
    if (tid == 0 && row < rows) absmax[row] = m;
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();  // the partial before the count
    last = atomicAdd(&g_absmax_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a group of lanes a row (a power of 2 up to a warp), each lane over
  // every lanes-th split
  int lanes = 1;
  while (lanes < 32 && lanes < splits) lanes <<= 1;
  const int group = threadIdx.x / lanes, groups = kThreads / lanes, gl = threadIdx.x % lanes;
  for (long long r0 = 0; r0 < rows; r0 += groups) {  // whole warps go round together
    const long long r = r0 + group;
    float mr = 0.f;
    if (r < rows)
      for (int s = gl; s < splits; s += lanes) mr = fmaxf(mr, __ldcg(partial + r * splits + s));
    mr = group_max(mr, lanes);
    if (gl == 0 && r < rows) absmax[r] = mr;
  }
  if (threadIdx.x == 0) g_absmax_done = 0;
}

// s = max(absmax, 1e-8) / 127
__device__ __forceinline__ float scale_of(float a) {
  return __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
}

// ---- Q1b / Q1c: quantize ---------------------------------------------------
// Bound by bytes (n * el read, n written). Both read 16 bytes a load (8 bf16
// or 4 fp32 values) and write 8 or 16 bytes a store, and quantize with
// scale_of and quantize_n below (quantize above where its test fails), so
// the integers are the plain version's.

// Eight values at p (16-byte aligned; fp32: two loads), as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p)),
              b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(w[i]);
}

// quantize(f[i], s) for N values at once, through t = f * r with r = RN(1 /
// s): |t - RN(f / s)| < |t| * 2^-21 (two roundings of at most 2^-24 each,
// and RN's), so where every |t| is at least 129 or further than |t| * 2^-20
// from a half-integer, clip(rint(t)) is clip(rint(RN(f / s))), the plain
// version's integer (a NaN fails the test); else the group takes the
// true division. The common case has no division and no branch a value.
template <int N>
__device__ __forceinline__ void quantize_n(const float* f, float s, float r, int8_t* q) {
  bool fast = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float t = f[i] * r, a = fabsf(t);
    fast &= a >= 129.f || fabsf(a - floorf(a) - 0.5f) > a * 0x1p-20f;
    q[i] = static_cast<int8_t>(fminf(fmaxf(rintf(t), -127.f), 127.f));
  }
  if (!fast) {
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = quantize(f[i], s);
  }
}

__device__ __forceinline__ uint32_t pack4(const int8_t* v) {
  return (uint32_t)(uint8_t)v[0] | ((uint32_t)(uint8_t)v[1] << 8) |
         ((uint32_t)(uint8_t)v[2] << 16) | ((uint32_t)(uint8_t)v[3] << 24);
}

// Eight quantized values at q: one 8-byte store where q is 8-byte aligned.
__device__ __forceinline__ void store8(int8_t* q, const float (&f)[8], float s, float r,
                                       bool aligned) {
  int8_t v[8];
  quantize_n<8>(f, s, r, v);
  if (aligned) {
    *reinterpret_cast<uint2*>(q) = make_uint2(pack4(v), pack4(v + 4));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = v[i];
  }
}

// Q1b: rows of k values. A row takes TPR threads (32 to 256, so 256 / TPR
// rows a block; ops/qconv.py::quantize_rows_plan picks TPR from k, as
// absmax_plan does for Q1a); a thread quantizes groups of 8 values (one
// 16-byte load of bf16, two of fp32; an 8-byte store where the row's int8
// base lines up), up to QLOADS in flight, between a scalar head (to x's
// 16-byte boundary) and a scalar tail. Output rows lie ldq bytes apart (k
// rounded up to 16, as the int8 matmul's TMA maps need; the pad is not
// written).
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads) q8_quantize_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ absmax, int8_t* __restrict__ q,
    float* __restrict__ scale, long long rows, int k, long long ldq) {
  constexpr int PER_BLOCK = kThreads / TPR, QLOADS = 4;
  const long long row = static_cast<long long>(blockIdx.x) * PER_BLOCK + threadIdx.x / TPR;
  const int tid = threadIdx.x % TPR;
  if (row >= rows) return;
  const float s = scale_of(absmax[row]), r = __frcp_rn(s);
  if (tid == 0) scale[row] = s;
  const T* p = x + row * k;
  int8_t* d = q + row * ldq;
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
  const int head = min(k, mis ? V - mis : 0);
  if (tid < head) d[tid] = quantize(to_float(p[tid]), s);
  const int groups = (k - head) / 8;
  const T* pv = p + head;
  int8_t* dv = d + head;
  const bool aligned = (reinterpret_cast<uintptr_t>(dv) & 7) == 0;
  for (int i = tid; i < groups; i += QLOADS * TPR) {
    float f[QLOADS][8];
#pragma unroll
    for (int u = 0; u < QLOADS; ++u)
      if (i + u * TPR < groups) load8(pv + 8 * (i + u * TPR), f[u]);
#pragma unroll
    for (int u = 0; u < QLOADS; ++u)
      if (i + u * TPR < groups) store8(dv + 8 * (i + u * TPR), f[u], s, r, aligned);
  }
  const int e = head + groups * 8 + tid;
  if (e < k) d[e] = quantize(to_float(p[e]), s);
}

// Q1c: NCHW -> NHWC. A block is QC channels x QP pixels of one sample (QP
// 128, or 32 where the 128-pixel tiles would not give each SM four blocks:
// ops/qconv.py::quantize_nhwc_plan): its
// threads read 16 bytes along pixels (V values of one channel, divided by
// the channel's divisor where one is given, quantized) into a shared
// [channel][pixel] tile of bytes, then each thread gathers 32 channels of
// one pixel and writes them as two 16-byte stores along channels. Scalar
// loads where the sample's rows are off 16 bytes (H*W not a multiple of V);
// where C is not a multiple of 16, byte stores, a warp's lanes on
// consecutive channels of a pixel.
constexpr int QC = 64;

template <typename T, int QP>
__global__ void __launch_bounds__(kThreads) q8_quantize_nhwc_kernel(
    const T* __restrict__ x, const float* __restrict__ div, const float* __restrict__ absmax,
    int8_t* __restrict__ q, float* __restrict__ scale, int channels, long long hw) {
  constexpr int V = 16 / sizeof(T);  // pixels a 16-byte load
  __shared__ __align__(16) uint8_t tile[QC][QP];
  const int b = blockIdx.z, c0 = blockIdx.y * QC;
  const long long p0 = static_cast<long long>(blockIdx.x) * QP;
  const float s = scale_of(absmax[b]), rs = __frcp_rn(s);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scale[b] = s;
  const T* xb = x + static_cast<long long>(b) * channels * hw;
  const bool vec = hw % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  constexpr int LOADS = QC * QP / V / kThreads;  // 16-byte loads a thread, all in flight
  uint4 raw[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = threadIdx.x + l * kThreads, c = idx / (QP / V);
    const long long p = p0 + (idx % (QP / V)) * V;
    raw[l] = make_uint4(0, 0, 0, 0);
    if (vec && c0 + c < channels && p < hw)
      raw[l] = __ldg(reinterpret_cast<const uint4*>(xb + (c0 + c) * hw + p));
  }
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = threadIdx.x + l * kThreads;
    const int c = idx / (QP / V), pl = (idx % (QP / V)) * V;
    const int cc = c0 + c;
    const long long p = p0 + pl;
    int8_t v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0;
    if (cc < channels && p < hw) {
      float f[V];
      if (vec) {
        if constexpr (V == 8) {
          const uint32_t w[4] = {raw[l].x, raw[l].y, raw[l].z, raw[l].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
          }
        } else {
          f[0] = __uint_as_float(raw[l].x), f[1] = __uint_as_float(raw[l].y);
          f[2] = __uint_as_float(raw[l].z), f[3] = __uint_as_float(raw[l].w);
        }
      } else {
        const T* src = xb + cc * hw + p;
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = p + i < hw ? to_float(src[i]) : 0.f;
      }
      if (div != nullptr) {
        const float d = div[cc];
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = __fdiv_rn(f[i], d);
      }
      quantize_n<V>(f, s, rs, v);  // pixels past H*W read as 0: quantized to 0
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(&tile[c][pl]) = make_uint2(pack4(v), pack4(v + 4));
    else
      *reinterpret_cast<uint32_t*>(&tile[c][pl]) = pack4(v);
  }
  __syncthreads();
  if (channels % 16 != 0) {  // bytes, lanes on consecutive channels of a pixel
    for (int idx = threadIdx.x; idx < QP * QC; idx += kThreads) {
      const int cl = idx % QC, pl = idx / QC;
      if (p0 + pl < hw && c0 + cl < channels)
        q[(static_cast<long long>(b) * hw + p0 + pl) * channels + c0 + cl] = tile[cl][pl];
    }
    return;
  }
  for (int idx = threadIdx.x; idx < QP * (QC / 32); idx += kThreads) {
    const int pl = idx % QP, cl = (idx / QP) * 32;  // lanes on consecutive pixels
    const long long p = p0 + pl;
    const int cb = c0 + cl;
    if (p >= hw || cb >= channels) continue;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = (uint32_t)tile[cl + 4 * i][pl] | ((uint32_t)tile[cl + 4 * i + 1][pl] << 8) |
             ((uint32_t)tile[cl + 4 * i + 2][pl] << 16) | ((uint32_t)tile[cl + 4 * i + 3][pl] << 24);
    int8_t* dst = q + (static_cast<long long>(b) * hw + p) * channels + cb;
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    if (cb + 16 < channels) *reinterpret_cast<uint4*>(dst + 16) = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// ---- Q2: int8 3x3 convolution on wgmma s8, fed by TMA ----------------------
// An implicit GEMM: M = the pixels of an image, N = O, K = 9 taps x C,
// ordered (tap, channel). Design (ops/qconv.py::conv3x3_plan lays it out):
// - a tile is a patch of PH x PW pixels of one image (M = 128 or 256; PW
//   16, or 64 for a bf16 output at least 64 wide: an m-block an image row)
//   by BN output channels (256 where O is a multiple of 256, else 128: MI,
//   the 64-row products a warpgroup issues per k-step, is 1 or 2, so both
//   hold 128 int32 accumulators a thread); a k-step is one tap's slice of
//   BK = 128 channels (K-major on both sides: NHWC activations and the
//   (O, 3, 3, C) weight rows), 128-byte swizzled, so no slice straddles two
//   taps and channels past C read as zeros;
// - one producer warp's one thread fetches each stage by TMA into a ring of
//   ST stages completing on mbarriers: the tap's shifted patch through a
//   4-D map over the NHWC activations (C, W, H, B) at (c0, w0 + ds, h0 +
//   dr, b), whose out-of-image coordinates read as zeros (the conv's
//   padding: no thread tests a border), and the weights through a 3-D map
//   (C, 9, O) at (c0, tap, n0); the two consumer warpgroups (each MI x 64
//   pixel rows, all BN channels) issue m64nBNk32 s8 products on it and free
//   the stage once their product has read it;
// - the grid is persistent (a block an SM walks units u, u + grid, ...), so
//   the producer fetches the next unit's stages under this one's epilogue;
// - where the tiles leave most SMs idle, K is split over `splits` blocks
//   (a unit is a tile's split; all units in one wave): each writes its int32 partial sums to a
//   workspace slab and counts itself done on the tile's counter; the last
//   to finish adds the other slabs to its own in int32 (exact in any
//   order: |acc| <= 127^2 * 9 * C < 2^31 on the paths) and runs the
//   epilogue, then resets the counter for the next launch (one counter
//   array a device, as Q1a's: the port's launches run one at a time on its
//   stream). One launch a conv, nothing zeroed;
// - epilogue: acc * (s_x[b] * s_w[o]) (+ bias[o]) with explicit _rn
//   operations (no FMA contraction: the plain version's fp32 operations),
//   cast. 64-pixel patches: each warpgroup stages its image rows by
//   stmatrix (transposed: a channel's 8 pixels a row) as 128-byte swizzled
//   rows and one thread writes them with a TMA store over (W, H, O, B),
//   clipped at the edges; the store drains under the next unit's products
//   (the staging is reused once it has been read). 16-pixel patches:
//   staged [channel][pixel] (padded: no bank conflicts; bf16 by stmatrix),
//   written NCHW along w in 16-byte stores (scalar where W is not a
//   multiple of 16 / element size), pixel coordinates from the tile's
//   corner (no per-element division); fp32 outputs take two passes of
//   half the channels, so the staging fits beside the ring.
// Bound by int8 operations at the decoder's and the UNet's widths.
namespace q2 {

using namespace pso;

constexpr int BK = 128;                      // channels (bytes) of one tap a k-step
constexpr int NC = 256, NTHREADS = NC + 32;  // two consumer warpgroups, one producer warp
constexpr int ST = 3;                        // stages of the ring
constexpr int kMaxSplitTiles = 1024;         // tiles of a launch that splits K, at most

__device__ unsigned int g_conv_done[kMaxSplitTiles];  // a split tile's units done

// PW: patch columns, 16 or (bf16 outputs on images at least 64 wide) 64
template <int MI, int BN, int PW>
struct Cfg {
  static constexpr int ROWS = 2 * MI * 64;  // pixels a tile
  static constexpr int PH = ROWS / PW;      // patch rows (16 or 8; 64 wide: 4 or 2)
  static constexpr int WG_ROWS = PH / 2;    // patch rows a warpgroup
  static constexpr int A_BYTES = ROWS * BK, STAGE = (ROWS + BN) * BK;
  static constexpr int ACC4 = MI * BN / 8;  // int4s of accumulators a thread
};

// The epilogue's staging of one warpgroup, 16-pixel patches: NP passes of
// CH channels, each channel's PIX pixels S elements apart (the pad puts the
// eight channels a stmatrix, or the four a store, writes on distinct banks).
// 64-pixel patches (bf16): MI blocks of BN rows (channels) of 128 bytes (an
// image row's 64 pixels), 128-byte swizzled, for the TMA store.
template <typename T, int MI, int BN>
struct Epi {
  static constexpr int NP = sizeof(T) / 2, CH = BN / NP, PIX = 64 * MI;
  static constexpr int S = PIX + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int WG_BYTES = CH * S * (int)sizeof(T);
};
constexpr int kStagingBytes = 2 * 36864;  // the largest two warpgroups' staging

template <int MI, int BN, int PW>
constexpr size_t conv_smem() {
  return 1024 + (size_t)ST * Cfg<MI, BN, PW>::STAGE + kStagingBytes + 16 * ST;
}

struct ConvArgs {
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  int* ws;  // split K: a slab of NC * ACC4 int4s a unit
  int batch, height, width, channels, outc;
  int tiles_h, tiles_w, tiles_n, cslices, k_total, splits, chunk, units;
};

// Four 8 x 8 b16 matrices held in the accumulator fragment layout (this
// thread's two values of row lane / 4 of each, packed), stored transposed:
// lane l gives the shared address of row l % 8 of matrix l / 8, which
// receives column l % 8 of the fragment (16 bytes).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

template <int BN>
__device__ __forceinline__ void mma(int (&c)[BN / 8][4], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_s8_n256(c, da, db);
  else
    wgmma_s8_n128(c, da, db);
}

// to: the output's map (64-pixel patches), else unused.
template <typename T, int MI, int BN, int PW>
__global__ void __launch_bounds__(NTHREADS, 1)
q8_conv3x3_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap to, ConvArgs a) {
  using C = Cfg<MI, BN, PW>;
  using E = Epi<T, MI, BN>;
  constexpr bool TMA_STORE = PW == 64;
  static_assert(!TMA_STORE || (sizeof(T) == 2 && 2 * MI * BN * 128 <= kStagingBytes), "staging");
  static_assert(TMA_STORE || (PW == 16 && 2 * E::WG_BYTES <= kStagingBytes), "staging");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_unit;  // split K: this block finishes the tile
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage i at base + i * STAGE
  const uint32_t bars = base + ST * C::STAGE + kStagingBytes;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (ST + i); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // unit u: tile u / splits (N fastest, then patches along w, h, images),
  // k-steps [split * chunk, min(split * chunk + chunk, k_total))
  int tile, b, h0, w0, n0, k0, k1;
  auto unit = [&](int u) {
    tile = u / a.splits;
    const int split = u - tile * a.splits;
    const int mt = tile / a.tiles_n, per_image = a.tiles_h * a.tiles_w;
    b = mt / per_image;
    const int rem = mt - b * per_image, th = rem / a.tiles_w;
    h0 = th * C::PH;
    w0 = (rem - th * a.tiles_w) * PW;
    n0 = (tile - mt * a.tiles_n) * BN;
    k0 = split * a.chunk;
    k1 = min(k0 + a.chunk, a.k_total);
  };

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC) {
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        unit(u);
        for (int k = k0; k < k1; ++k, ++it) {
          const int st = it % ST;
          mbar_wait(empty(st), ((it / ST) & 1) ^ 1);  // a fresh stage's wait passes at once
          mbar_expect_tx(full(st), C::STAGE);
          const int tap = k / a.cslices, c0 = (k - tap * a.cslices) * BK;
          const uint32_t A = base + st * C::STAGE;
          tma_load_4d(A, &tx, c0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b, full(st));
          tma_load_3d(A + C::A_BYTES, &tw, c0, tap, n0, full(st));
        }
      }
    }
    return;
  }

  const int ctid = threadIdx.x, wg = ctid >> 7, wtid = ctid & 127, warp = wtid >> 5;
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
  int acc[MI][BN / 8][4];
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    unit(u);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0;
    for (int k = k0; k < k1; ++k, ++it) {
      const int st = it % ST;
      mbar_wait(full(st), (it / ST) & 1);
      const uint32_t A = base + st * C::STAGE + wg * MI * 64 * BK, B = base + st * C::STAGE + C::A_BYTES;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
        const uint64_t db = sw128_desc(B, 16) + 2 * ks;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma<BN>(acc[mi], sw128_desc(A + mi * 64 * BK, 16) + 2 * ks, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products: its stage is free
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);
      if (k > k0) mbar_arrive(empty((it - 1) % ST));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);
    mbar_arrive(empty((it - 1) % ST));

    if (a.splits > 1) {  // split K: the last unit of the tile to finish sums the slabs
      int4* slab = reinterpret_cast<int4*>(a.ws) + static_cast<size_t>(u) * C::ACC4 * NC;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          slab[(mi * (BN / 8) + j) * NC + ctid] =
              make_int4(acc[mi][j][0], acc[mi][j][1], acc[mi][j][2], acc[mi][j][3]);
      __threadfence();  // the slab before the count
      named_sync(3, NC);
      if (ctid == 0) {
        last_unit = atomicAdd(&g_conv_done[tile], 1u) == static_cast<unsigned>(a.splits - 1);
        if (last_unit) g_conv_done[tile] = 0;  // every unit of the tile has counted
      }
      named_sync(3, NC);
      if (!last_unit) continue;
      __threadfence();
      const int own = u - tile * a.splits;
      for (int s = 0; s < a.splits; ++s) {
        if (s == own) continue;
        const int4* other =
            reinterpret_cast<const int4*>(a.ws) + static_cast<size_t>(tile * a.splits + s) * C::ACC4 * NC;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int4 v = __ldcg(other + (mi * (BN / 8) + j) * NC + ctid);
            acc[mi][j][0] += v.x, acc[mi][j][1] += v.y, acc[mi][j][2] += v.z, acc[mi][j][3] += v.w;
          }
      }
    }

    // epilogue, per warpgroup: its patch rows x BN channels
    const float s_x = a.sx[b];
    // the scales and biases of two n-tiles (n-tile j0, j0 + 1), for this
    // thread's channels 2t, 2t + 1 of each
    float sxw[2][2], bo[2][2];
    auto scales = [&](int j0) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + 8 * (j0 + q) + 2 * t + e;
          sxw[q][e] = bo[q][e] = 0.f;
          if (o < a.outc) {
            sxw[q][e] = __fmul_rn(s_x, a.sw[o]);
            if (a.bias != nullptr) bo[q][e] = a.bias[o];
          }
        }
    };
    // y of accumulator r = 2 * half + e of (mi, n-tile j0 + q): pixel g + 8 *
    // half of the warp's 16, channel 8 * (j0 + q) + 2 * t + e
    auto y_of = [&](int mi, int j0, int q, int r) {
      const float y = __fmul_rn(__int2float_rn(acc[mi][j0 + q][r]), sxw[q][r & 1]);
      return a.bias != nullptr ? __fadd_rn(y, bo[q][r & 1]) : y;
    };
    // bf16: the four 8 x 8 (pixel x channel) fragments of n-tiles j0, j0 + 1
    // (pixels g, g + 8) of m-block mi, packed for stmatrix_x4_trans
    auto packed = [&](int mi, int j0, uint32_t (&r)[4]) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        r[m] = pack_f32(y_of(mi, j0, m >> 1, 2 * (m & 1)), y_of(mi, j0, m >> 1, 2 * (m & 1) + 1));
    };
    const int mat = lane >> 3;  // stmatrix: lane l addresses row l % 8 of fragment l / 8
    if constexpr (TMA_STORE) {
      // m-block mi is image row h0 + wg * MI + mi, columns w0..w0+63: staged
      // as BN swizzled rows of 128 bytes (row o, 16-byte chunk 2 * warp +
      // half), then one TMA store (W, H, O, B) a block, clipped at the edges
      const uint32_t stg = base + ST * C::STAGE + wg * MI * BN * 128;
      if (wtid == 0) bulk_wait_read<0>();  // the last store has read the staging
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 2) {
        scales(j0);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t r[4];
          packed(mi, j0, r);
          stmatrix_x4_trans(stg + mi * BN * 128 + sw128(8 * (j0 + (mat >> 1)) + (lane & 7),
                                                         2 * warp + (mat & 1)),
                            r[0], r[1], r[2], r[3]);
        }
      }
      fence_proxy_async();  // the staging, visible to the TMA store
      named_sync(1 + wg, 128);
      if (wtid == 0) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          tma_store_4d(&to, stg + mi * BN * 128, w0, h0 + wg * MI + mi, n0, b);
        bulk_commit();
      }
    } else {
      T* stage = reinterpret_cast<T*>(smem_raw + (base - raw) + ST * C::STAGE + wg * E::WG_BYTES);
      T* out = static_cast<T*>(a.out);
      constexpr int V = 16 / sizeof(T), CPR = PW / V, R = C::WG_ROWS;
      const bool vec = a.width % V == 0;
#pragma unroll
      for (int p = 0; p < E::NP; ++p) {
        named_sync(1 + wg, 128);  // the staging's last readers are done
        // pass p: n-tiles p * CH / 8 .., staged as channels 0..CH-1
#pragma unroll
        for (int jj = 0; jj < E::CH / 8; jj += 2) {
          const int j0 = p * (E::CH / 8) + jj;
          scales(j0);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if constexpr (sizeof(T) == 2) {
              uint32_t r[4];
              packed(mi, j0, r);
              stmatrix_x4_trans(smem_u32(stage + (8 * (jj + (mat >> 1)) + (lane & 7)) * E::S +
                                         mi * 64 + warp * 16 + 8 * (mat & 1)),
                                r[0], r[1], r[2], r[3]);
            } else {
#pragma unroll
              for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  stage[(8 * (jj + q) + 2 * t + (r & 1)) * E::S + mi * 64 + warp * 16 + g +
                        8 * (r >> 1)] = y_of(mi, j0, q, r);
            }
          }
        }
        named_sync(1 + wg, 128);
        // 16-byte chunks along w: chunk ch of patch row r of channel ol
        for (int idx = wtid; idx < E::CH * R * CPR; idx += 128) {
          const int ch = idx % CPR, r = (idx / CPR) % R, ol = idx / (CPR * R);
          const int o = n0 + p * E::CH + ol, h = h0 + wg * R + r, w = w0 + ch * V;
          if (o >= a.outc || h >= a.height || w >= a.width) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage + ol * E::S + r * PW + ch * V);
          T* dst = out + ((static_cast<long long>(b) * a.outc + o) * a.height + h) * a.width + w;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const T* vs = reinterpret_cast<const T*>(&v);
#pragma unroll
            for (int i = 0; i < V; ++i)
              if (w + i < a.width) dst[i] = vs[i];
          }
        }
      }
    }
  }
  if constexpr (TMA_STORE) {
    if (wtid == 0) bulk_wait<0>();  // the last stores are done before the block exits
  }
}

template <typename T, int MI, int BN, int PW>
cudaError_t launch(const int8_t* xq, const int8_t* wq, const ConvArgs& a, int grid,
                   cudaStream_t stream) {
  constexpr size_t SMEM = conv_smem<MI, BN, PW>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_conv3x3_kernel<T, MI, BN, PW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tx, tw, to;
  const long long xd[4] = {a.channels, a.width, a.height, a.batch};
  const long long xs[3] = {a.channels, (long long)a.width * a.channels,
                           (long long)a.height * a.width * a.channels};
  const int xb[4] = {BK, PW, Cfg<MI, BN, PW>::PH, 1};
  const long long wd[3] = {a.channels, 9, a.outc};
  const long long wst[2] = {a.channels, 9LL * a.channels};
  const int wb[3] = {BK, 1, BN};
  cudaError_t e = sw128_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 4, xd, xs, xb);
  if (e == cudaSuccess) e = sw128_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 3, wd, wst, wb);
  if (e == cudaSuccess && PW == 64) {
    const long long od[4] = {a.width, a.height, a.outc, a.batch};
    const long long os[3] = {2LL * a.width, 2LL * a.height * a.width,
                             2LL * a.outc * a.height * a.width};
    const int ob[4] = {64, 1, BN, 1};
    e = sw128_map(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.out, 4, od, os, ob);
  } else {
    to = tx;  // unused
  }
  if (e != cudaSuccess) return e;
  q8_conv3x3_kernel<T, MI, BN, PW><<<grid, NTHREADS, SMEM, stream>>>(tx, tw, to, a);
  return cudaGetLastError();
}

// The plan's (mi, bn, pw, splits, chunk, grid) checked against the shape;
// the rest of the geometry derived as ops/qconv.py::conv3x3_plan derives it.
template <typename T>
cudaError_t dispatch(const int8_t* xq, const int8_t* wq, ConvArgs a, int mi, int bn, int pw,
                     int grid, cudaStream_t stream) {
  if ((mi != 1 && mi != 2) || (pw != 16 && pw != 64) || (pw == 64 && sizeof(T) != 2))
    return cudaErrorInvalidValue;
  const int ph = 2 * mi * 64 / pw;
  a.tiles_h = (a.height + ph - 1) / ph;
  a.tiles_w = (a.width + pw - 1) / pw;
  a.tiles_n = (a.outc + bn - 1) / bn;
  a.cslices = (a.channels + BK - 1) / BK;
  a.k_total = 9 * a.cslices;
  const long long tiles = (long long)a.batch * a.tiles_h * a.tiles_w * a.tiles_n;
  if (a.channels % 16 || a.splits < 1 || a.chunk < 1 ||
      (long long)(a.splits - 1) * a.chunk >= a.k_total || (long long)a.splits * a.chunk < a.k_total ||
      tiles * a.splits > 0x7fffffffLL || grid < 1 || (pw == 64 && a.width % 8) ||
      (a.splits > 1 && (tiles > kMaxSplitTiles || a.ws == nullptr)))
    return cudaErrorInvalidValue;
  a.units = static_cast<int>(tiles * a.splits);
#define PSO_CONV(MI, BN, PW)                                          \
  if (mi == MI && bn == BN && pw == PW) return launch<T, MI, BN, PW>(xq, wq, a, grid, stream)
  PSO_CONV(1, 256, 16);
  PSO_CONV(2, 128, 16);
  if constexpr (sizeof(T) == 2) {
    PSO_CONV(1, 256, 64);
    PSO_CONV(2, 128, 64);
  }
#undef PSO_CONV
  return cudaErrorInvalidValue;
}

}  // namespace q2

// ---- Q3: int8 matmul on wgmma s8, fed by TMA, dequantized in its epilogue ----
// int8 (M, K) x int8 (N, K)^T -> (M, N): y = acc * (s_x[m] * s_w[n]) (+
// bias[n]) in fp32 with explicit _rn operations (the chain of the plain
// version, ops/qconv.py::matmul_plain: torch._int_mm, then dequant_plain),
// cast to bf16 or fp32. The int32 sums are exact in any order (|acc| <=
// 127^2 * K < 2^31 on the paths). Design (ops/qconv.py::matmul_plan lays
// it out), Q2's without the taps:
// - a tile is BM = 128 rows (64 a consumer warpgroup) by BN = 128 or 256
//   columns (the plan's choice); a k-step is BK = 128 bytes of K, both
//   operands K-major (the rows of xq and wq) and 128-byte swizzled;
// - one producer thread fetches each stage, the A and B boxes through 2-D
//   maps (K, M) and (K, N), into a ring of ST stages on mbarriers; rows past
//   M or N and bytes past K read as zeros (TMA's fill), so ragged shapes and
//   M from 1 need no test in the loop. A map's row stride is a multiple of
//   16 bytes: the quantize (quantize_rows) writes its rows on a 16-byte
//   stride, padded past K where K % 16 != 0; the pad lies past the map's K
//   and is never read;
// - the grid is persistent (a block an SM walks units u, u + grid, ...), so
//   the producer fetches the next unit's stages under this one's epilogue;
// - where the tiles leave half the SMs idle, K is split over `splits` units
//   of a tile (all in one wave) with Q2's int32 slabs: the last unit of a
//   tile to finish adds the others' in int32 (exact) and runs the epilogue;
// - epilogue: the scales and bias read per column pair, y as above; bf16
//   staged by stmatrix, fp32 by 8-byte stores, as 128-byte swizzled blocks
//   of 64 rows x 128 bytes, two a warpgroup at a time (so the ring keeps 4
//   stages at BN = 256, 6 at 128), written by TMA stores over (N, M)
//   clipped at the edges; the last pass's stores drain under the next
//   unit's products. The int32
//   product never reaches device memory (torch._int_mm and a dequantize
//   pass would write it and read it back).
// Bound by int8 operations at the UNet's GEGLU widths, by bytes at narrow
// ones.
namespace q8mm {

using namespace pso;

constexpr int BM = 128, BK = 128;            // rows a tile; bytes of K a k-step
constexpr int NC = 256, NTHREADS = NC + 32;  // two consumer warpgroups, one producer warp
constexpr int kMaxSmem = 232448;             // the shared memory a block can take on the H100
constexpr int kMaxStages = 6;
constexpr int kMaxSplitTiles = 1024;         // tiles of a launch that splits K, at most

__device__ unsigned int g_mm_done[kMaxSplitTiles];  // a split tile's units done

template <typename T, int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * BK, STAGE = (BM + BN) * BK;
  static constexpr int ACC4 = BN / 8;                  // int4s of accumulators a thread
  static constexpr int COLS = 128 / (int)sizeof(T);    // output columns a 128-byte staging row
  // the epilogue stages a warpgroup's 64 rows in passes of PASS_BLOCKS
  // blocks of 64 rows x 128 bytes (PASS_TILES n-tiles), each written by TMA
  // stores before the next pass: the ring keeps the rest of the SM's memory
  static constexpr int PASS_BLOCKS = 2, PASS_TILES = PASS_BLOCKS * COLS / 8;
  static constexpr int PASSES = BN / 8 / PASS_TILES;
  static constexpr int WG_STG = PASS_BLOCKS * 64 * 128;  // one warpgroup's staging bytes
  static constexpr int FREE = kMaxSmem - 1024 - 2 * WG_STG - 16 * kMaxStages;
  static constexpr int ST = FREE / STAGE < kMaxStages ? FREE / STAGE : kMaxStages;
  static constexpr size_t SMEM = 1024 + (size_t)ST * STAGE + 2 * WG_STG + 16 * ST;
  static_assert(ST >= 2 && SMEM <= (size_t)kMaxSmem, "shared memory");
};

struct MmArgs {
  const float* sx;
  const float* sw;
  const float* bias;
  int* ws;  // split K: a slab of NC * ACC4 int4s a unit
  int m, n, k;
  int tiles_n, k_total, splits, chunk, units;
};

// Four 8 x 8 b16 matrices held in the accumulator fragment layout (this
// thread's two values of row lane / 4 of each, packed): lane l gives the
// shared address of row l % 8 of matrix l / 8 (16 bytes).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

template <typename T, int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
q8_matmul_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap to, MmArgs a) {
  using C = Cfg<T, BN>;
  constexpr int ST = C::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_unit;  // split K: this block finishes the tile
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage i at base + i * STAGE
  const uint32_t staging = base + ST * C::STAGE;
  const uint32_t bars = staging + 2 * C::WG_STG;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (ST + i); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), NC);
    }
    mbar_fence_init();
  } else if (threadIdx.x == NC) {  // the maps' descriptors fetched under the barriers' set-up
    prefetch_tensormap(&ta);
    prefetch_tensormap(&tb);
    prefetch_tensormap(&to);
  }
  __syncthreads();

  // unit u: tile u / splits (N tiles fastest), k-steps [split * chunk,
  // min(split * chunk + chunk, k_total))
  int tile, m0, n0, k0, k1;
  auto unit = [&](int u) {
    tile = u / a.splits;
    const int split = u - tile * a.splits, mt = tile / a.tiles_n;
    m0 = mt * BM;
    n0 = (tile - mt * a.tiles_n) * BN;
    k0 = split * a.chunk;
    k1 = min(k0 + a.chunk, a.k_total);
  };

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC) {
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        unit(u);
        for (int k = k0; k < k1; ++k, ++it) {
          const int st = it % ST;
          mbar_wait(empty(st), ((it / ST) & 1) ^ 1);  // a fresh stage's wait passes at once
          mbar_expect_tx(full(st), C::STAGE);
          const uint32_t A = base + st * C::STAGE;
          tma_load_2d(A, &ta, k * BK, m0, full(st));
          tma_load_2d(A + C::A_BYTES, &tb, k * BK, n0, full(st));
        }
      }
    }
    return;
  }

  const int ctid = threadIdx.x, wg = ctid >> 7, wtid = ctid & 127, warp = wtid >> 5;
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
  int acc[BN / 8][4];
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    unit(u);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k = k0; k < k1; ++k, ++it) {
      const int st = it % ST;
      mbar_wait(full(st), (it / ST) & 1);
      const uint32_t A = base + st * C::STAGE + wg * 64 * BK, B = base + st * C::STAGE + C::A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        q2::mma<BN>(acc, sw128_desc(A, 16) + 2 * ks, sw128_desc(B, 16) + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products: its stage is free
      fence_acc(acc);
      if (k > k0) mbar_arrive(empty((it - 1) % ST));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty((it - 1) % ST));

    if (a.splits > 1) {  // split K: the last unit of the tile to finish sums the slabs
      int4* slab = reinterpret_cast<int4*>(a.ws) + static_cast<size_t>(u) * C::ACC4 * NC;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        slab[j * NC + ctid] = make_int4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      __threadfence();  // the slab before the count
      named_sync(3, NC);
      if (ctid == 0) {
        last_unit = atomicAdd(&g_mm_done[tile], 1u) == static_cast<unsigned>(a.splits - 1);
        if (last_unit) g_mm_done[tile] = 0;  // every unit of the tile has counted
      }
      named_sync(3, NC);
      if (!last_unit) continue;
      __threadfence();
      const int own = u - tile * a.splits;
      for (int s = 0; s < a.splits; ++s) {
        if (s == own) continue;
        const int4* other = reinterpret_cast<const int4*>(a.ws) +
                            static_cast<size_t>(tile * a.splits + s) * C::ACC4 * NC;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int4 v = __ldcg(other + j * NC + ctid);
          acc[j][0] += v.x, acc[j][1] += v.y, acc[j][2] += v.z, acc[j][3] += v.w;
        }
      }
    }

    // epilogue, per warpgroup: rows m0 + 64 wg + 16 warp + g (+ 8), BN
    // columns; accumulator r of n-tile j is row + 8 * (r >> 1), column n0 +
    // 8 j + 2 t + (r & 1)
    const int row = m0 + wg * 64 + warp * 16 + g;
    const float s_x[2] = {row < a.m ? a.sx[row] : 0.f, row + 8 < a.m ? a.sx[row + 8] : 0.f};
    const uint32_t stg = staging + wg * C::WG_STG;
#pragma unroll
    for (int p = 0; p < C::PASSES; ++p) {  // a pass: PASS_BLOCKS staging blocks of columns
      if (wtid == 0) bulk_wait_read<0>();  // the last store has read the staging
      named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < C::PASS_TILES; jj += 2) {
        const int j0 = p * C::PASS_TILES + jj;  // n-tiles j0, j0 + 1 (q); jj, jj + 1 of the pass
        // the scale products and biases of this thread's rows (h) and
        // columns 2t, 2t + 1 (e) of n-tiles j0 + q
        float sc[2][2][2], bo[2][2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * (j0 + q) + 2 * t + e;
            const float w = col < a.n ? a.sw[col] : 0.f;
            bo[q][e] = a.bias != nullptr && col < a.n ? a.bias[col] : 0.f;
            sc[q][0][e] = __fmul_rn(s_x[0], w);
            sc[q][1][e] = __fmul_rn(s_x[1], w);
          }
        auto y = [&](int q, int r) {
          const float v = __fmul_rn(__int2float_rn(acc[j0 + q][r]), sc[q][r >> 1][r & 1]);
          return a.bias != nullptr ? __fadd_rn(v, bo[q][r & 1]) : v;
        };
        if constexpr (sizeof(T) == 2) {
          // matrix mt = 2 q + h: rows h * 8.. of n-tile j0 + q; lane l
          // addresses row l % 8 of matrix l / 8 (a 16-byte chunk: one n-tile)
          uint32_t r[4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            r[mt] = pack_f32(y(mt >> 1, 2 * (mt & 1)), y(mt >> 1, 2 * (mt & 1) + 1));
          const int j = jj + (lane >> 4), rr = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          stmatrix_x4(stg + (j / 8) * 8192 + sw128(rr, j % 8), r[0], r[1], r[2], r[3]);
        } else {
          // 8 bytes a row and column pair: the pass's n-tile j holds
          // columns 8 (j % 4) + 2 t of block j / 4
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = jj + q, rr = warp * 16 + h * 8 + g;
              st_shared_v2(stg + (j / 4) * 8192 + sw128(rr, 2 * (j % 4) + (t >> 1)) + (t & 1) * 8,
                           y(q, 2 * h), y(q, 2 * h + 1));
            }
        }
      }
      fence_proxy_async();  // the staging, visible to the TMA stores
      named_sync(1 + wg, 128);
      if (wtid == 0 && m0 + wg * 64 < a.m) {
#pragma unroll
        for (int blk = 0; blk < C::PASS_BLOCKS; ++blk) {
          const int col = n0 + (p * C::PASS_BLOCKS + blk) * C::COLS;
          if (col < a.n) tma_store_2d(&to, stg + blk * 8192, col, m0 + wg * 64);
        }
        bulk_commit();
      }
    }
  }
  if (wtid == 0) bulk_wait_read<0>();  // the last stores have read the staging before it goes
}

template <typename T, int BN>
cudaError_t launch(const int8_t* xq, const int8_t* wq, void* out, long long lda, long long ldb,
                   const MmArgs& a, int grid, cudaStream_t stream) {
  using C = Cfg<T, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_matmul_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tb, to;
  const long long ad[2] = {a.k, a.m}, bd[2] = {a.k, a.n}, od[2] = {a.n, a.m};
  const long long as[1] = {lda}, bs[1] = {ldb}, os[1] = {(long long)a.n * (long long)sizeof(T)};
  const int ab[2] = {BK, BM}, bb[2] = {BK, BN}, ob[2] = {C::COLS, 64};
  cudaError_t e = sw128_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 2, ad, as, ab);
  if (e == cudaSuccess) e = sw128_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 2, bd, bs, bb);
  const CUtensorMapDataType out_type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (e == cudaSuccess) e = sw128_map(&to, out_type, out, 2, od, os, ob);
  if (e != cudaSuccess) return e;
  q8_matmul_kernel<T, BN><<<grid, NTHREADS, C::SMEM, stream>>>(ta, tb, to, a);
  return cudaGetLastError();
}

// The plan's (bn, splits, chunk, grid) checked against the shape; the rest
// of the layout derived as ops/qconv.py::matmul_plan derives it.
template <typename T>
cudaError_t dispatch(const int8_t* xq, const int8_t* wq, void* out, long long lda, long long ldb,
                     MmArgs a, int bn, int grid, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (a.m < 1 || a.k < 1 || a.n < 1 || (a.n * (int)sizeof(T)) % 16 || lda < a.k || ldb < a.k ||
      lda % 16 || ldb % 16 || !aligned(xq) || !aligned(wq) || !aligned(out) ||
      (bn != 128 && bn != 256))
    return cudaErrorInvalidValue;
  a.tiles_n = (a.n + bn - 1) / bn;
  a.k_total = (a.k + BK - 1) / BK;
  const long long tiles = (long long)((a.m + BM - 1) / BM) * a.tiles_n;
  if (a.splits < 1 || a.chunk < 1 || (long long)(a.splits - 1) * a.chunk >= a.k_total ||
      (long long)a.splits * a.chunk < a.k_total || tiles * a.splits > 0x7fffffffLL || grid < 1 ||
      (a.splits > 1 && (tiles > kMaxSplitTiles || a.ws == nullptr)))
    return cudaErrorInvalidValue;
  a.units = static_cast<int>(tiles * a.splits);
  if (bn == 256) return launch<T, 256>(xq, wq, out, lda, ldb, a, grid, stream);
  return launch<T, 128>(xq, wq, out, lda, ldb, a, grid, stream);
}

}  // namespace q8mm

template <typename T, bool DIV>
cudaError_t absmax_launch(const void* x, const float* div, float* absmax, float* partial,
                          long long rows, long long row_stride, int n_seg, int seg_len,
                          long long seg_stride, int tpr, int splits, int chunk, cudaStream_t s) {
  const long long per_block = kThreads / tpr;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block * splits));
  const T* xt = static_cast<const T*>(x);
#define PSO_ABSMAX(TPR)                                                                       \
  q8_absmax_kernel<T, DIV, TPR><<<grid, kThreads, 0, s>>>(                                    \
      xt, div, absmax, partial, rows, row_stride, n_seg, seg_len, seg_stride, splits, chunk)
  switch (tpr) {
    case 32: PSO_ABSMAX(32); break;
    case 64: PSO_ABSMAX(64); break;
    case 128: PSO_ABSMAX(128); break;
    case 256: PSO_ABSMAX(256); break;
    default: return cudaErrorInvalidValue;
  }
#undef PSO_ABSMAX
  return cudaGetLastError();
}

cudaError_t absmax_dispatch(int dtype, const void* x, const float* div, float* absmax,
                            float* partial, long long rows, long long row_stride, int n_seg,
                            int seg_len, long long seg_stride, int tpr, int splits, int chunk,
                            cudaStream_t s) {
  if (dtype == 0)
    return div != nullptr
               ? absmax_launch<__nv_bfloat16, true>(x, div, absmax, partial, rows, row_stride,
                                                    n_seg, seg_len, seg_stride, tpr, splits, chunk,
                                                    s)
               : absmax_launch<__nv_bfloat16, false>(x, div, absmax, partial, rows, row_stride,
                                                     n_seg, seg_len, seg_stride, tpr, splits,
                                                     chunk, s);
  return div != nullptr ? absmax_launch<float, true>(x, div, absmax, partial, rows, row_stride,
                                                     n_seg, seg_len, seg_stride, tpr, splits,
                                                     chunk, s)
                        : absmax_launch<float, false>(x, div, absmax, partial, rows, row_stride,
                                                      n_seg, seg_len, seg_stride, tpr, splits,
                                                      chunk, s);
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 fp32 (the input's for Q1, the output's for Q2 and Q3)
int q8_absmax(int dtype, const void* x, const float* div, float* absmax, float* partial,
              long long rows, long long row_stride, int n_seg, int seg_len,
              long long seg_stride, int tpr, int splits, int chunk, void* stream) {
  return static_cast<int>(absmax_dispatch(dtype, x, div, absmax, partial, rows, row_stride, n_seg,
                                          seg_len, seg_stride, tpr, splits, chunk,
                                          static_cast<cudaStream_t>(stream)));
}

int q8_quantize_rows(int dtype, const void* x, const float* absmax, int8_t* q, float* scale,
                     long long rows, long long k, long long ldq, int tpr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = kThreads / (tpr > 0 ? tpr : 1);
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
  if (k >= (1LL << 31) || ldq < k) return static_cast<int>(cudaErrorInvalidValue);
#define PSO_QROWS(T, TPR)                                                                   \
  q8_quantize_rows_kernel<T, TPR><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), absmax, q, \
                                                            scale, rows, static_cast<int>(k), ldq)
#define PSO_QROWS_T(T)              \
  switch (tpr) {                    \
    case 32: PSO_QROWS(T, 32); break;   \
    case 64: PSO_QROWS(T, 64); break;   \
    case 128: PSO_QROWS(T, 128); break; \
    case 256: PSO_QROWS(T, 256); break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (dtype == 0) {
    PSO_QROWS_T(__nv_bfloat16)
  } else {
    PSO_QROWS_T(float)
  }
#undef PSO_QROWS_T
#undef PSO_QROWS
  return static_cast<int>(cudaGetLastError());
}

// tile_p: pixels a block's tile (32 or 128), ops/qconv.py::quantize_nhwc_plan
int q8_quantize_nhwc(int dtype, const void* x, const float* div, const float* absmax, int8_t* q,
                     float* scale, int batch, int channels, long long hw, int tile_p,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_p != 32 && tile_p != 128) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((hw + tile_p - 1) / tile_p), (channels + QC - 1) / QC,
                  batch);
#define PSO_QNHWC(T, QP)                                                                   \
  q8_quantize_nhwc_kernel<T, QP><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), div, absmax, \
                                                           q, scale, channels, hw)
  if (dtype == 0) {
    if (tile_p == 128) PSO_QNHWC(__nv_bfloat16, 128); else PSO_QNHWC(__nv_bfloat16, 32);
  } else {
    if (tile_p == 128) PSO_QNHWC(float, 128); else PSO_QNHWC(float, 32);
  }
#undef PSO_QNHWC
  return static_cast<int>(cudaGetLastError());
}

// (mi, bn, pw, splits, chunk, grid): ops/qconv.py::conv3x3_plan; ws: a slab
// of 128 KB a unit where splits > 1, else null.
int q8_conv3x3(int dtype, const int8_t* xq, const int8_t* wq, const float* sx, const float* sw,
               const float* bias, void* out, int* ws, int batch, int height, int width,
               int channels, int outc, int mi, int bn, int pw, int splits, int chunk, int grid,
               void* stream) {
  q2::ConvArgs a{};
  a.sx = sx, a.sw = sw, a.bias = bias, a.out = out, a.ws = ws;
  a.batch = batch, a.height = height, a.width = width, a.channels = channels, a.outc = outc;
  a.splits = splits, a.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0
                              ? q2::dispatch<__nv_bfloat16>(xq, wq, a, mi, bn, pw, grid, s)
                              : q2::dispatch<float>(xq, wq, a, mi, bn, pw, grid, s));
}

// (bn, splits, chunk, grid): ops/qconv.py::matmul_plan; lda, ldb: the int8
// rows' strides in bytes (multiples of 16); ws: a slab of 256 * bn / 2 int32
// a unit where splits > 1, else null.
int q8_matmul(int dtype, const int8_t* xq, const int8_t* wq, const float* sx, const float* sw,
              const float* bias, void* out, int* ws, int m, int n, int k, long long lda,
              long long ldb, int bn, int splits, int chunk, int grid, void* stream) {
  q8mm::MmArgs a{};
  a.sx = sx, a.sw = sw, a.bias = bias, a.ws = ws;
  a.m = m, a.n = n, a.k = k, a.splits = splits, a.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? q8mm::dispatch<__nv_bfloat16>(xq, wq, out, lda, ldb, a, bn, grid, s)
                 : q8mm::dispatch<float>(xq, wq, out, lda, ldb, a, bn, grid, s));
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
