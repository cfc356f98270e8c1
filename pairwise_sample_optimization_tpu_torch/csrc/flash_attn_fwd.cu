// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * scale) V with an online softmax, plus the per-row fp32
// logsumexp that the backward needs.
//
// Replaces the TPU kernel pairwise_sample_optimization_tpu/ops/
// flash_attention.py::_fwd_kernel (launched by _fwd). Semantics kept:
// fp32 running max / sum / accumulator; P is cast to V's dtype before the
// P.V product; keys at or past kv_len get the finite -1e30 so a masked
// column never makes a NaN; l == 0 is guarded.
//
// What bounds it on an H100: the least time is set by tensor-core
// operations (4*Sq*Skv*d per head) at the long sequences, the UNet's
// 1024-token self-attention and the VAE mid-block (d = 512, 4096 tokens),
// and by bytes (Q, K, V read once, O and the LSE written once) at the short
// ones, 256/257 tokens and the 77-token cross-attention. This simple design
// is far from both: it is held back by the S round trip through shared
// memory and by copies that are not overlapped with the products.
//
// Design, simple and right first:
// - one block per (batch*head, 16*WM query rows); the block loops over kv
//   tiles of BN keys, which takes the place of the TPU's sequential
//   "arbitrary" grid axis. No state is carried between blocks.
// - Q, K and V tiles are copied to shared memory with 16-byte loads
//   straight from the caller's (B, S, H, D) strides, so nothing is folded,
//   transposed or padded on the host. Rows past the sequence end are
//   zero-filled and their columns masked here, which covers the 77-token
//   cross-attention and the 257-token ViT without padding to 128.
// - S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 operands, fp32
//   accumulation). S goes through shared memory for the row softmax, which
//   keeps the softmax code independent of the mma fragment layout. The O
//   accumulator stays in registers, split across warps by rows (WM) and by
//   head-dim columns (WN): at d = 512 a 64 x 512 fp32 accumulator does not
//   fit one warp's registers, so 8 warps each hold 16 rows x 128 columns of
//   a 32-row tile.
// - fp32 inputs take the same structure with exact fp32 FMAs in place of
//   the tensor-core product (a correctness path, not a fast one).
// - wgmma, TMA and a pipelined copy ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int heads, sq, skv;
  float scale;
};

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

template <typename T, int D, int WM, int WN, int BN>
struct Tiling {
  static constexpr int BM = 16 * WM;
  static constexpr int NWARPS = WM * WN;
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDT = D + PAD;   // Q, K, V rows
  static constexpr int LDS = BN + 4;    // fp32 S rows
  static constexpr int LDP = BN + PAD;  // P rows
  static constexpr int TPR = NTHREADS / BM;  // threads per softmax row
  static constexpr size_t SMEM = sizeof(T) * (size_t)(BM * LDT + 2 * BN * LDT + BM * LDP) +
                                 sizeof(float) * (size_t)(BM * LDS + 3 * BM);
  static_assert(BN % (8 * WN) == 0 && BN % 16 == 0, "kv tile");
  static_assert(D % (8 * WN) == 0 && D % 16 == 0, "head dim split");
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "softmax row split");
};

template <typename T, int D, int WM, int WN, int BN>
__global__ void __launch_bounds__(Tiling<T, D, WM, WN, BN>::NTHREADS)
flash_fwd_kernel(Params p) {
  using TL = Tiling<T, D, WM, WN, BN>;
  constexpr int BM = TL::BM, LDT = TL::LDT, LDS = TL::LDS, LDP = TL::LDP, TPR = TL::TPR;
  constexpr int NT_S = BN / WN / 8;  // S n-tiles per warp
  constexpr int NT_O = D / WN / 8;   // O n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * LDT;
  T* Vs = Ks + BN * LDT;
  T* Ps = Vs + BN * LDT;
  float* Ss = reinterpret_cast<float*>(Ps + BM * LDP);
  float* row_m = Ss + BM * LDS;
  float* row_l = row_m + BM;
  float* row_alpha = row_l + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<T, D, TL::NTHREADS>(Qs, LDT, qb, p.q_ss, q0, BM, p.sq);
  for (int r = tid; r < BM; r += TL::NTHREADS) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }

  float oacc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  const int n_kv = (p.skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers of Ks / Vs / Ps are done
    load_tile<T, D, TL::NTHREADS>(Ks, LDT, kb, p.k_ss, k0, BN, p.skv);
    load_tile<T, D, TL::NTHREADS>(Vs, LDT, vb, p.v_ss, k0, BN, p.skv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN/WN columns
    float sacc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const int n0 = wn * (BN / WN) + j * 8;
        tile_mma<true>(sacc[j], Qs + (wm * 16) * LDT + kk, LDT, Ks + n0 * LDT + kk, LDT, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const int col = wn * (BN / WN) + j * 8 + 2 * t;
      const int row = wm * 16 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1), r = row + (e >> 1) * 8;
        Ss[r * LDS + c] = (k0 + c < p.skv) ? sacc[j][e] * p.scale : kMask;
      }
    }
    __syncthreads();

    // online softmax, TPR threads per row
    {
      const int r = tid / TPR, part = tid % TPR;
      float mloc = -INFINITY;
      for (int c = part; c < BN; c += TPR) mloc = fmaxf(mloc, Ss[r * LDS + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mloc);
      float sum = 0.f;
      for (int c = part; c < BN; c += TPR) {
        const float e = __expf(Ss[r * LDS + c] - m_new);
        Ps[r * LDP + c] = from_float<T>(e);
        sum += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (part == 0) {
        const float alpha = __expf(m_prev - m_new);  // 0 on the first tile
        row_m[r] = m_new;
        row_l[r] = alpha * row_l[r] + sum;
        row_alpha[r] = alpha;
      }
    }
    __syncthreads();

    // O = alpha * O + P V for this warp's 16 rows x D/WN columns
    {
      const float a_lo = row_alpha[wm * 16 + g], a_hi = row_alpha[wm * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        oacc[j][0] *= a_lo;
        oacc[j][1] *= a_lo;
        oacc[j][2] *= a_hi;
        oacc[j][3] *= a_hi;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < BN; kk += 16) {
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const int d0 = wn * (D / WN) + j * 8;
        tile_mma<false>(oacc[j], Ps + (wm * 16) * LDP + kk, LDP, Vs + kk * LDT + d0, LDT, lane);
      }
    }
  }
  __syncthreads();

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wm * 16 + g + half * 8;
    const int qrow = q0 + r;
    if (qrow >= p.sq) continue;
    const float l = row_l[r];
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const int c = wn * (D / WN) + j * 8 + 2 * t;
      T* dst = ob + (long long)qrow * p.o_ss + c;
      dst[0] = from_float<T>(oacc[j][half * 2] * inv);
      dst[1] = from_float<T>(oacc[j][half * 2 + 1] * inv);
    }
  }
  for (int r = tid; r < BM; r += TL::NTHREADS) {
    if (q0 + r < p.sq) {
      const float l = row_l[r];
      p.lse[(long long)bh * p.sq + q0 + r] = row_m[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

template <typename T, int D, int WM, int WN, int BN>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using TL = Tiling<T, D, WM, WN, BN>;
  auto kernel = flash_fwd_kernel<T, D, WM, WN, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + TL::BM - 1) / TL::BM, batch * p.heads);
  kernel<<<grid, TL::NTHREADS, TL::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements; the last dim
// is contiguous. q/k/v/o are (B, S, H, D) views; lse is (B*H, Sq) fp32.
int flash_attn_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                   float* lse, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh, int batch, int heads, int sq,
                   int skv, float scale, void* stream) {
  Params p{q,    k,    v,    o,    lse,  q_sb,  q_ss, q_sh, k_sb, k_ss,
           k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, heads, sq,  skv, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (d == 64) return launch<__nv_bfloat16, 64, 4, 1, 64>(p, batch, s);
    if (d == 80) return launch<__nv_bfloat16, 80, 4, 1, 64>(p, batch, s);
    if (d == 512) return launch<__nv_bfloat16, 512, 2, 4, 64>(p, batch, s);
  } else if (dtype == 1) {
    if (d == 64) return launch<float, 64, 4, 1, 64>(p, batch, s);
    if (d == 80) return launch<float, 80, 4, 1, 64>(p, batch, s);
    if (d == 512) return launch<float, 512, 2, 4, 32>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
