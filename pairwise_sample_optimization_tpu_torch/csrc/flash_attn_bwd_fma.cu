// Flash-attention backward for Hopper (sm_90a), the two-kernel route: the
// gradients dQ, dK and dV of softmax(Q K^T * scale) V from the forward's
// per-row fp32 logsumexp (LSE) and the pre kernel's Di (flash_attn_bwd.cu),
// at head dims 40, 80 and 160 (the SD1.5 UNet's 8 fixed heads over 320, 640
// and 1280 channels) in bf16 or fp32, and at 64 in fp32.
//
// Replaces the TPU kernels pairwise_sample_optimization_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel (K2) and ::_bwd_dq_kernel (K3), as
// two kernels as there. Semantics kept:
//   S  = Q K^T * scale, columns at or past kv_len set to the finite -1e30
//   P  = exp(S - LSE)                   (masked columns give exactly 0)
//   dP = dO V^T
//   dS = P * (dP - Di) * scale,          Di = rowsum(O * dO) in fp32
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
// P and dS are rounded to the input dtype before their products, which
// accumulate in fp32; outputs are written in the input dtype.
//
// What bounds it on an H100: tensor-core operations at the SD1.5 UNet's
// 4096- and 1024-token self-attention (seven products of 2*Sq*Skv*d per
// head, S and dP computed in both kernels as in the TPU design) and bytes
// at the 77-token cross-attention and the 256- and 64-token shapes. This
// design is the simple, right one: its products run as exact fp32 FMAs on
// the CUDA cores, far from either bound (the one-kernel wgmma design of
// flash_attn_bwd.cu at these head dims is later work).
//
// The design (flash_bwd_dkv_kernel<T, D> then flash_bwd_dq_kernel<T, D>):
// - 64x64 tiles, 4 x WN warps (WN = 2 above d = 64, so that the dK / dV
//   accumulators fit the registers); warp w owns 16 rows of S / dP (64 / WN
//   columns) and, in the dK/dV kernel, 16 kv rows of the dK / dV
//   accumulators (D / WN columns), in the dQ kernel 16 q rows of dQ,
//   computed with exact fp32 FMAs in the m16n8 fragment layout.
// - tiles are copied to shared memory as fp32 (bf16 widened on the way) with
//   16-byte loads from the caller's (B, S, H, D) strides; rows past either
//   sequence end are zero-filled and their probabilities set to 0, which
//   covers the 77-token kv without padding on the host. Rows that do not
//   exist are never written. d = 40 runs S and dP over a depth of 48, the 8
//   pad columns zero.
// - in bf16, P and dS are rounded to bf16 before their products, as in the
//   one-kernel route and the TPU kernels; the outputs are written in the
//   input dtype.
// - the dK/dV kernel stores P^T and dS^T in shared memory so the transposed
//   products read a row-major A operand; the dQ kernel stores dS row-major.
// - shared memory (fp32 tiles): up to 198 KB at d = 160, one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using pso::from_float;
using pso::tile_mma;

constexpr float kMask = -1e30f;
constexpr int BM = 64, BN = 64;  // q and kv tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B*H, Sq)
  const float* di;   // (B*H, Sq)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int heads, sq, skv;
  float scale;
};

namespace fma {

// x rounded to T and back: P and dS enter their products in the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int HD>
struct Cfg {
  static constexpr int DK = (HD + 15) / 16 * 16;  // S's and dP's depth: d = 40 zero-padded to 48
  static constexpr int WN = HD > 64 ? 2 : 1;      // warps sharing a 16-row group's columns
  static constexpr int THREADS = 128 * WN;        // 4 row groups of 16
  static constexpr int NTS = BN / 8 / WN;         // S and dP n-tiles a warp (of BN columns)
  static constexpr int NTD = HD / 8 / WN;         // dK, dV or dQ n-tiles a warp (of d columns)
  // fp32 in shared memory whatever the input dtype
  static constexpr int LDT = DK + 4;  // Q, K, V, dO rows
  static constexpr int LDX = BM + 4;  // dK/dV kernel: P^T / dS^T rows (BN of them, BM wide)
  static constexpr int LDS = BN + 4;  // dQ kernel: dS rows (BM of them, BN wide)
  static constexpr size_t SMEM_DKV = sizeof(float) * ((size_t)(2 * BN * LDT + 2 * BM * LDT +
                                                               2 * BN * LDX) + 2 * BM);
  static constexpr size_t SMEM_DQ = sizeof(float) * ((size_t)(2 * BM * LDT + 2 * BN * LDT +
                                                              BM * LDS) + 2 * BM);
  static_assert(HD % (8 * WN) == 0, "head dim split");
};

// Copy rows [row0, row0 + rows) of one head (HD values of T each) into
// fp32 rows of shared memory (leading dim ld), zero-filling rows at or
// past n. 16-byte loads; the wrapper guarantees 16-byte aligned rows.
template <typename T, int HD, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const T* src,
                                              long long row_stride, int row0, int rows, int n) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = HD / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    float* out = dst + r * ld + c;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) u = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(out) = u;
    } else {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
      const float2 c2 = __bfloat1622float2(h2[2]), d2 = __bfloat1622float2(h2[3]);
      reinterpret_cast<float4*>(out)[0] = make_float4(a.x, a.y, b.x, b.y);
      reinterpret_cast<float4*>(out)[1] = make_float4(c2.x, c2.y, d2.x, d2.y);
    }
  }
}

// Zero columns HD..DK of n_rows rows from each of the given tiles: the
// padded depth of S and dP (d = 40), which no copy writes.
template <int HD, int THREADS>
__device__ __forceinline__ void zero_pad(float* a, float* b, float* c, float* d, int n_rows) {
  constexpr int PADC = Cfg<HD>::DK - HD, LDT = Cfg<HD>::LDT;
  if constexpr (PADC > 0) {
    float* const tiles[4] = {a, b, c, d};
    for (int i = threadIdx.x; i < 4 * n_rows * PADC; i += THREADS) {
      const int tile = i / (n_rows * PADC), r = (i / PADC) % n_rows, c = HD + i % PADC;
      tiles[tile][r * LDT + c] = 0.f;
    }
  }
}

// S = Q K^T and dP = dO V^T for this warp's 16 rows from row0 and NTS
// n-tiles of columns from col0.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[Cfg<HD>::NTS][4],
                                       float (&dp)[Cfg<HD>::NTS][4], const float* Qs,
                                       const float* dOs, const float* Ks, const float* Vs,
                                       int row0, int col0, int lane) {
  using C = Cfg<HD>;
  constexpr int LDT = C::LDT;
#pragma unroll
  for (int j = 0; j < C::NTS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  // the k-steps are not unrolled (each one is NTS x 2 unrolled 16-deep tile
  // products already): fourteen instances stay a build of seconds each
#pragma unroll 1
  for (int kk = 0; kk < C::DK; kk += 16) {
#pragma unroll
    for (int j = 0; j < C::NTS; ++j) {
      const int n0 = col0 + j * 8;
      tile_mma<true>(s[j], Qs + row0 * LDT + kk, LDT, Ks + n0 * LDT + kk, LDT, lane);
      tile_mma<true>(dp[j], dOs + row0 * LDT + kk, LDT, Vs + n0 * LDT + kk, LDT, lane);
    }
  }
}

// Rows [row0, row0 + BM) of lse and Di for head bh into shared memory; 0
// past the end (those rows get P = 0 anyway).
__device__ __forceinline__ void load_rows(float* lse_s, float* di_s, const Params& p, int bh,
                                          int row0) {
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const bool ok = row0 + r < p.sq;
    lse_s[r] = ok ? p.lse[(long long)bh * p.sq + row0 + r] : 0.f;
    di_s[r] = ok ? p.di[(long long)bh * p.sq + row0 + r] : 0.f;
  }
}

// Write a warp's 16 x (8 N) fp32 accumulator (rows row0.., columns col0..,
// fragment layout) to dst rows < n in T.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride, const float (&acc)[N][4],
                                           int row0, int col0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T* out = dst + (long long)r * row_stride + col0 + j * 8 + 2 * t;
      out[0] = from_float<T>(acc[j][half * 2]);
      out[1] = from_float<T>(acc[j][half * 2 + 1]);
    }
  }
}

// K2: one block per (kv tile of BN rows, batch*head); loops over q tiles.
// Warp w owns rows 16 (w % 4).. of S / dP (columns 64 / WN (w / 4)..) and
// kv rows 16 (w % 4).. of dK / dV (columns HD / WN (w / 4)..).
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS) flash_bwd_dkv_kernel(Params p) {
  using C = Cfg<HD>;
  constexpr int LDT = C::LDT, LDX = C::LDX, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BN * LDT;
  float* Qs = Vs + BN * LDT;
  float* dOs = Qs + BM * LDT;
  float* Pt = dOs + BM * LDT;  // P^T:  BN x BM
  float* dSt = Pt + BN * LDX;  // dS^T: BN x BM
  float* lse_s = dSt + BN * LDX;
  float* di_s = lse_s + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * BN;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  zero_pad<HD, THREADS>(Ks, Vs, Qs, dOs, 64);
  load_tile_f32<T, HD, THREADS>(Ks, LDT, kb, p.k_ss, k0, BN, p.skv);
  load_tile_f32<T, HD, THREADS>(Vs, LDT, vb, p.v_ss, k0, BN, p.skv);

  float dk[C::NTD][4], dv[C::NTD][4];
#pragma unroll
  for (int j = 0; j < C::NTD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_q = (p.sq + BM - 1) / BM;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // the previous tile's readers of Qs / dOs / Pt / dSt are done
    load_tile_f32<T, HD, THREADS>(Qs, LDT, qb, p.q_ss, q0, BM, p.sq);
    load_tile_f32<T, HD, THREADS>(dOs, LDT, dob, p.do_ss, q0, BM, p.sq);
    load_rows(lse_s, di_s, p, bh, q0);
    __syncthreads();

    float s[C::NTS][4], dp[C::NTS][4];
    scores<HD>(s, dp, Qs, dOs, Ks, Vs, wm * 16, wn * (BN / C::WN), lane);
#pragma unroll
    for (int j = 0; j < C::NTS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = wn * (BN / C::WN) + j * 8 + 2 * t + (e & 1);
        const int r = wm * 16 + g + (e >> 1) * 8;
        float pr = 0.f, ds = 0.f;
        if (q0 + r < p.sq) {
          const float sv = (k0 + c < p.skv) ? s[j][e] * p.scale : kMask;
          pr = __expf(sv - lse_s[r]);
          ds = pr * (dp[j][e] - di_s[r]) * p.scale;
        }
        Pt[c * LDX + r] = round_to<T>(pr);
        dSt[c * LDX + r] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for this warp's 16 kv rows and its columns
#pragma unroll 1
    for (int kk = 0; kk < BM; kk += 16) {
#pragma unroll
      for (int j = 0; j < C::NTD; ++j) {
        const int d0 = wn * (HD / C::WN) + j * 8;
        tile_mma<false>(dv[j], Pt + (wm * 16) * LDX + kk, LDX, dOs + kk * LDT + d0, LDT, lane);
        tile_mma<false>(dk[j], dSt + (wm * 16) * LDX + kk, LDX, Qs + kk * LDT + d0, LDT, lane);
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T, C::NTD>(dkb, p.dk_ss, dk, k0 + wm * 16, wn * (HD / C::WN), p.skv, lane);
  store_rows<T, C::NTD>(dvb, p.dv_ss, dv, k0 + wm * 16, wn * (HD / C::WN), p.skv, lane);
}

// K3: one block per (q tile of BM rows, batch*head); loops over kv tiles.
// Warp w owns rows 16 (w % 4).. of S / dP (columns 64 / WN (w / 4)..) and
// q rows 16 (w % 4).. of dQ (columns HD / WN (w / 4)..).
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS) flash_bwd_dq_kernel(Params p) {
  using C = Cfg<HD>;
  constexpr int LDT = C::LDT, LDS = C::LDS, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BM * LDT;
  float* Ks = dOs + BM * LDT;
  float* Vs = Ks + BN * LDT;
  float* dSs = Vs + BN * LDT;  // dS: BM x BN
  float* lse_s = dSs + BM * LDS;
  float* di_s = lse_s + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  zero_pad<HD, THREADS>(Qs, dOs, Ks, Vs, 64);
  load_tile_f32<T, HD, THREADS>(Qs, LDT, qb, p.q_ss, q0, BM, p.sq);
  load_tile_f32<T, HD, THREADS>(dOs, LDT, dob, p.do_ss, q0, BM, p.sq);
  load_rows(lse_s, di_s, p, bh, q0);

  float dq[C::NTD][4];
#pragma unroll
  for (int j = 0; j < C::NTD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int n_kv = (p.skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers of Ks / Vs / dSs are done
    load_tile_f32<T, HD, THREADS>(Ks, LDT, kb, p.k_ss, k0, BN, p.skv);
    load_tile_f32<T, HD, THREADS>(Vs, LDT, vb, p.v_ss, k0, BN, p.skv);
    __syncthreads();

    float s[C::NTS][4], dp[C::NTS][4];
    scores<HD>(s, dp, Qs, dOs, Ks, Vs, wm * 16, wn * (BN / C::WN), lane);
#pragma unroll
    for (int j = 0; j < C::NTS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = wn * (BN / C::WN) + j * 8 + 2 * t + (e & 1);
        const int r = wm * 16 + g + (e >> 1) * 8;
        float ds = 0.f;
        if (q0 + r < p.sq) {
          const float sv = (k0 + c < p.skv) ? s[j][e] * p.scale : kMask;
          ds = __expf(sv - lse_s[r]) * (dp[j][e] - di_s[r]) * p.scale;
        }
        dSs[r * LDS + c] = round_to<T>(ds);
      }
    }
    __syncthreads();  // a dS row's columns come from the WN warps of its row group

    // dQ += dS K for this warp's 16 q rows and its columns
#pragma unroll 1
    for (int kk = 0; kk < BN; kk += 16) {
#pragma unroll
      for (int j = 0; j < C::NTD; ++j) {
        const int d0 = wn * (HD / C::WN) + j * 8;
        tile_mma<false>(dq[j], dSs + (wm * 16) * LDS + kk, LDS, Ks + kk * LDT + d0, LDT, lane);
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<T, C::NTD>(dqb, p.dq_ss, dq, q0 + wm * 16, wn * (HD / C::WN), p.sq, lane);
}

// K2 then K3 on the stream.
template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<HD>;
  // once per instantiation: the host's launch rate bounds the update
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_DKV);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_DQ);
  if (attr_dkv != cudaSuccess) return attr_dkv;
  if (attr_dq != cudaSuccess) return attr_dq;
  const unsigned bh = (unsigned)(batch * p.heads);
  flash_bwd_dkv_kernel<T, HD>
      <<<dim3((p.skv + BN - 1) / BN, bh), C::THREADS, C::SMEM_DKV, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, HD><<<dim3((p.sq + BM - 1) / BM, bh), C::THREADS, C::SMEM_DQ, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fma

}  // namespace

extern "C" {

// dtype: 0 = bfloat16 (d = 40, 80 or 160), 1 = float32 (d = 40, 64, 80 or
// 160); any other is refused. The signature of flash_attn_bwd.cu's entry
// of the same name: acc and q_chunk are unused here (dq, dk and dv are
// written, no accumulator). q, k, v, dout, dq, dk, dv are (B, S, H, d)
// views (strides in elements, last dim contiguous); lse and di (B*H, Sq)
// fp32.
int flash_attn_bwd(int dtype, int d, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di, void* dq, void* dk,
                   void* dv, float* acc, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, long long do_sb, long long do_ss, long long do_sh,
                   long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
                   long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
                   long long dv_sh, int batch, int heads, int sq, int skv, int q_chunk,
                   float scale, void* stream) {
  (void)acc, (void)q_chunk;
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.lse = lse, p.di = di, p.dq = dq, p.dk = dk,
  p.dv = dv;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh, p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh, p.do_sb = do_sb, p.do_ss = do_ss, p.do_sh = do_sh;
  p.dq_sb = dq_sb, p.dq_ss = dq_ss, p.dq_sh = dq_sh, p.dk_sb = dk_sb, p.dk_ss = dk_ss,
  p.dk_sh = dk_sh;
  p.dv_sb = dv_sb, p.dv_ss = dv_ss, p.dv_sh = dv_sh;
  p.heads = heads, p.sq = sq, p.skv = skv, p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (d == 40) return fma::launch<__nv_bfloat16, 40>(p, batch, s);
    if (d == 80) return fma::launch<__nv_bfloat16, 80>(p, batch, s);
    if (d == 160) return fma::launch<__nv_bfloat16, 160>(p, batch, s);
  } else if (dtype == 1) {
    if (d == 40) return fma::launch<float, 40>(p, batch, s);
    if (d == 64) return fma::launch<float, 64>(p, batch, s);
    if (d == 80) return fma::launch<float, 80>(p, batch, s);
    if (d == 160) return fma::launch<float, 160>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
