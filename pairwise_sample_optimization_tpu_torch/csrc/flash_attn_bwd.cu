// Flash-attention backward for Hopper (sm_90a), head dim 64: two kernels
// that recompute the probabilities from the forward's per-row fp32
// logsumexp (LSE) and share no state, as the TPU design does.
//
// Replaces the TPU kernels pairwise_sample_optimization_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel (K2) and ::_bwd_dq_kernel (K3),
// both launched by _bwd. Semantics kept:
//   S  = Q K^T * scale, columns at or past kv_len set to the finite -1e30
//   P  = exp(S - LSE)                   (masked columns give exactly 0)
//   dP = dO V^T
//   dS = P * (dP - Di) * scale,          Di = rowsum(O * dO), given in fp32
//   K2: dV = P^T dO,  dK = dS^T Q        (one block per kv tile, loops over q)
//   K3: dQ = dS K                        (one block per q tile, loops over kv)
// The products take their operands in the input dtype (P and dS are cast
// to it first) and accumulate in fp32; outputs are written in the input
// dtype. Each block owns its output rows and sums over the other sequence
// in a loop inside the block, so there are no atomics and the result does
// not depend on the order blocks run in.
//
// What bounds it on an H100: tensor-core operations at the UNet's
// 1024-token self-attention (K2 does four and K3 three products of
// 2*Sq*Skv*64 per head) and bytes at the 256-token and the 77-token
// cross-attention shapes, where a block's few tiles make latency and waves
// matter as much as either rate.
//
// K2 in bf16 (flash_bwd_dkv_kernel_d64, all of the update's K2 launches)
// computes the scores transposed, so nothing is transposed in memory:
// - one block of 4 warps per (64 kv rows, batch*head), looping over q tiles
//   of 64; warp w owns kv rows 16w..16w+15. Their K and V rows are A
//   fragments in registers, loaded once (ldmatrix), and their dK and dV
//   accumulators stay in registers.
// - S^T = K Q^T and dP^T = V dO^T: Q and dO rows are the n of the B
//   operand, read with ldmatrix as they lie. LSE and Di are indexed by
//   column (q), staged per q tile.
// - P^T and dS^T come out of the accumulators already in the m16n8
//   fragment layout whose bf16 packing is the A fragment of dV += P^T dO
//   and dK += dS^T Q (pso::acc_to_a): no shared-memory round trip, no
//   transposed store. In those products dO's and Q's k (the q row) runs
//   along their rows, so their B fragments come through ldmatrix.trans.
// - Q, dO, LSE and Di stream through a 2-stage cp.async ring (one
//   __syncthreads a q tile). Pad q rows (past sq) are zero-filled by the
//   copy, never copies of a real row: with zero Q and dO a pad column adds
//   nothing to dK or dV whatever its P, and LSE = Di = 0 keeps that P
//   finite. kv rows past skv get S = -1e30 (P = 0) and are never stored.
// - dK and dV are staged in the warp's own rows of the K / V buffers and
//   stored as 16-byte rows.
//
// K3 in bf16 (flash_bwd_dq_kernel_d64, all of the update's K3 launches) has
// the forward's shape and runs on Hopper's warpgroup products
// (csrc/wgmma.cuh):
// - one block of one warpgroup per (64 q rows, batch*head), looping over
//   kv tiles of 64; warp w owns q rows 16w..16w+15. Q and dO stay resident
//   in shared memory in the 128-byte swizzle; each thread loads the LSE
//   and Di of its two rows once.
// - K and V tiles stream through a 2-stage cp.async ring in the same
//   swizzle; keys past skv are zero-filled and masked to -1e30 (P = 0).
// - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands
//   K-major from descriptors; P = exp2(S scale log2 e - LSE log2 e) and
//   dS = P (dP - Di) scale in registers.
// - dQ += dS K is a wgmma with dS, rounded to bf16, as the register A
//   operand (pso::acc_to_a) and the same K tile read MN-major, as the
//   forward reads V. dQ is staged in the warp's own rows of the Q tile and
//   stored as 16-byte rows.
// - 50 KB of shared memory and 124 registers: 4 blocks an SM, 3-9%
//   faster than 3 at every main-path shape on the H100 (PERF.md).
//
// fp32 inputs (a correctness path, not a fast one) keep the first, simple
// design (flash_bwd_dkv_kernel, flash_bwd_dq_kernel):
// - 4 warps, 64x64 tiles; each warp owns 16 rows of S / dP (all 64 columns)
//   and, in K2, 16 kv rows of the dK / dV accumulators, in K3 16 q rows of
//   dQ, computed with exact fp32 FMAs in the m16n8 fragment layout.
// - tiles are copied to shared memory with 16-byte loads from the caller's
//   (B, S, H, D) strides; rows past either sequence end are zero-filled and
//   their probabilities set to 0, which covers the 77-token kv without
//   padding on the host. Rows that do not exist are never written.
// - K2 stores P^T and dS^T in shared memory so the transposed products read
//   a row-major A operand; K3 stores dS row-major (each warp its own rows).
// - TMA copies are later work for all of them, and K2 on wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

using pso::from_float;
using pso::load_tile;
using pso::tile_mma;

constexpr float kMask = -1e30f;
constexpr int D = 64, BM = 64, BN = 64, NWARPS = 4, NTHREADS = 32 * NWARPS;
constexpr int NT = 8;  // 8-column n-tiles across a 64-wide tile

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

template <typename T>
struct Layout {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDT = D + PAD;   // Q, K, V, dO rows
  static constexpr int LDX = BM + PAD;  // K2: P^T / dS^T rows (BN of them, BM wide)
  static constexpr int LDS = BN + PAD;  // K3: dS rows (BM of them, BN wide)
  static constexpr size_t SMEM_DKV =
      sizeof(T) * (size_t)(2 * BN * LDT + 2 * BM * LDT + 2 * BN * LDX) + sizeof(float) * 2 * BM;
  static constexpr size_t SMEM_DQ =
      sizeof(T) * (size_t)(2 * BM * LDT + 2 * BN * LDT + BM * LDS) + sizeof(float) * 2 * BM;
};

// S = Q K^T and dP = dO V^T for this warp's 16 rows, all BN columns.
template <typename T>
__device__ __forceinline__ void scores(float (&s)[NT][4], float (&dp)[NT][4], const T* Qs,
                                       const T* dOs, const T* Ks, const T* Vs, int row0,
                                       int lane) {
  constexpr int LDT = Layout<T>::LDT;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tile_mma<true>(s[j], Qs + row0 * LDT + kk, LDT, Ks + (j * 8) * LDT + kk, LDT, lane);
      tile_mma<true>(dp[j], dOs + row0 * LDT + kk, LDT, Vs + (j * 8) * LDT + kk, LDT, lane);
    }
  }
}

// Rows [row0, row0 + BM) of lse and Di for head bh into shared memory; 0
// past the end (those rows get P = 0 anyway).
__device__ __forceinline__ void load_rows(float* lse_s, float* di_s, const Params& p, int bh,
                                          int row0) {
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    const bool ok = row0 + r < p.sq;
    lse_s[r] = ok ? p.lse[(long long)bh * p.sq + row0 + r] : 0.f;
    di_s[r] = ok ? p.di[(long long)bh * p.sq + row0 + r] : 0.f;
  }
}

// Write a warp's 16 x 64 fp32 accumulator (rows row0.., fragment layout) to
// dst rows < n in T.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride, const float (&acc)[NT][4],
                                           int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      T* out = dst + (long long)r * row_stride + j * 8 + 2 * t;
      out[0] = from_float<T>(acc[j][half * 2]);
      out[1] = from_float<T>(acc[j][half * 2 + 1]);
    }
  }
}

// K2: one block per (kv tile of BN rows, batch*head); loops over q tiles.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Params p) {
  using L = Layout<T>;
  constexpr int LDT = L::LDT, LDX = L::LDX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BN * LDT;
  T* Qs = Vs + BN * LDT;
  T* dOs = Qs + BM * LDT;
  T* Pt = dOs + BM * LDT;   // P^T:  BN x BM
  T* dSt = Pt + BN * LDX;   // dS^T: BN x BM
  float* lse_s = reinterpret_cast<float*>(dSt + BN * LDX);
  float* di_s = lse_s + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * BN;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile<T, D, NTHREADS>(Ks, LDT, kb, p.k_ss, k0, BN, p.skv);
  load_tile<T, D, NTHREADS>(Vs, LDT, vb, p.v_ss, k0, BN, p.skv);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_q = (p.sq + BM - 1) / BM;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // the previous tile's readers of Qs / dOs / Pt / dSt are done
    load_tile<T, D, NTHREADS>(Qs, LDT, qb, p.q_ss, q0, BM, p.sq);
    load_tile<T, D, NTHREADS>(dOs, LDT, dob, p.do_ss, q0, BM, p.sq);
    load_rows(lse_s, di_s, p, bh, q0);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    scores<T>(s, dp, Qs, dOs, Ks, Vs, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), r = warp * 16 + g + (e >> 1) * 8;
        float pr = 0.f, ds = 0.f;
        if (q0 + r < p.sq) {
          const float sv = (k0 + c < p.skv) ? s[j][e] * p.scale : kMask;
          pr = __expf(sv - lse_s[r]);
          ds = pr * (dp[j][e] - di_s[r]) * p.scale;
        }
        Pt[c * LDX + r] = from_float<T>(pr);
        dSt[c * LDX + r] = from_float<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for this warp's 16 kv rows
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tile_mma<false>(dv[j], Pt + (warp * 16) * LDX + kk, LDX, dOs + kk * LDT + j * 8, LDT, lane);
        tile_mma<false>(dk[j], dSt + (warp * 16) * LDX + kk, LDX, Qs + kk * LDT + j * 8, LDT, lane);
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T>(dkb, p.dk_ss, dk, k0 + warp * 16, p.skv, lane);
  store_rows<T>(dvb, p.dv_ss, dv, k0 + warp * 16, p.skv, lane);
}

// K3: one block per (q tile of BM rows, batch*head); loops over kv tiles.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Params p) {
  using L = Layout<T>;
  constexpr int LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BM * LDT;
  T* Ks = dOs + BM * LDT;
  T* Vs = Ks + BN * LDT;
  T* dSs = Vs + BN * LDT;  // dS: BM x BN, each warp its own 16 rows
  float* lse_s = reinterpret_cast<float*>(dSs + BM * LDS);
  float* di_s = lse_s + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile<T, D, NTHREADS>(Qs, LDT, qb, p.q_ss, q0, BM, p.sq);
  load_tile<T, D, NTHREADS>(dOs, LDT, dob, p.do_ss, q0, BM, p.sq);
  load_rows(lse_s, di_s, p, bh, q0);

  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int n_kv = (p.skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers of Ks / Vs are done
    load_tile<T, D, NTHREADS>(Ks, LDT, kb, p.k_ss, k0, BN, p.skv);
    load_tile<T, D, NTHREADS>(Vs, LDT, vb, p.v_ss, k0, BN, p.skv);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    scores<T>(s, dp, Qs, dOs, Ks, Vs, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), r = warp * 16 + g + (e >> 1) * 8;
        float ds = 0.f;
        if (q0 + r < p.sq) {
          const float sv = (k0 + c < p.skv) ? s[j][e] * p.scale : kMask;
          ds = __expf(sv - lse_s[r]) * (dp[j][e] - di_s[r]) * p.scale;
        }
        dSs[r * LDS + c] = from_float<T>(ds);
      }
    }
    __syncwarp();  // a warp reads back only the dS rows it wrote

    // dQ += dS K for this warp's 16 q rows
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tile_mma<false>(dq[j], dSs + (warp * 16) * LDS + kk, LDS, Ks + kk * LDT + j * 8, LDT, lane);
    }
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<T>(dqb, p.dq_ss, dq, q0 + warp * 16, p.sq, lane);
}

template <typename T, bool kDkv>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T>;
  void (*kernel)(Params);
  if constexpr (kDkv)
    kernel = flash_bwd_dkv_kernel<T>;
  else
    kernel = flash_bwd_dq_kernel<T>;
  const size_t smem = kDkv ? L::SMEM_DKV : L::SMEM_DQ;
  // once per instantiation: the host's launch rate bounds the update
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int rows = kDkv ? p.skv : p.sq;
  dim3 grid((rows + (kDkv ? BN : BM) - 1) / (kDkv ? BN : BM), batch * p.heads);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- K2 in bf16: the transposed-score design --------------------------------
namespace dkv_bf16 {

using bf16 = __nv_bfloat16;
using namespace pso;

constexpr int LD = D + 8;      // padded rows of 144 bytes: ldmatrix reads without bank conflicts
constexpr int TILE = 64 * LD;  // one 64-row tile in shared memory
constexpr int STAGES = 2;      // the Q / dO / LSE / Di copy ring
// K and V (the block's kv rows), then per stage Q and dO, then per stage LSE and Di
constexpr size_t SMEM = sizeof(bf16) * (size_t)(2 * TILE + STAGES * 2 * TILE) +
                        sizeof(float) * (size_t)(STAGES * 2 * BM);  // 56,320 bytes
constexpr float kLog2e = 1.4426950408889634f;
static_assert(NTHREADS == 2 * BM, "one LSE or Di value per thread");

// Start copying q tile [q0, q0 + BM): Q and dO rows (zero-filled past sq,
// so pad columns add nothing to dK or dV whatever their P), LSE and Di
// (zero past sq, which keeps those P finite).
__device__ __forceinline__ void copy_q_tile(bf16* Qs, bf16* dOs, float* rows_s, const bf16* qb,
                                            const bf16* dob, const Params& p, int bh, int q0) {
  copy_rows_async<BM, NTHREADS>(Qs, LD, qb, p.q_ss, q0, p.sq);
  copy_rows_async<BM, NTHREADS>(dOs, LD, dob, p.do_ss, q0, p.sq);
  const int r = threadIdx.x % BM, row = q0 + r;
  const float* src = (threadIdx.x < BM ? p.lse : p.di) + (long long)bh * p.sq;
  cp_async_4(smem_u32(rows_s + threadIdx.x), src + (row < p.sq ? row : p.sq - 1), row < p.sq);
}

// One block per (64 kv rows, batch*head), looping over q tiles; warp w owns
// kv rows 16w..16w+15, their K and V as A fragments in registers, and their
// dK and dV accumulators. It computes the scores transposed, S^T = K Q^T and
// dP^T = V dO^T, so that P^T and dS^T come out of the accumulators already
// as the A operands of dV += P^T dO and dK += dS^T Q.
__global__ void __launch_bounds__(NTHREADS, 2) flash_bwd_dkv_kernel_d64(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;  // stage s: Q at Qs + 2 s TILE, dO right after it
  float* rows_s = reinterpret_cast<float*>(Qs + STAGES * 2 * TILE);  // stage s: LSE, Di at + 2 s BM

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * BN;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float sl2 = p.scale * kLog2e;
  // this lane's kv rows (g and g + 8 of the warp's 16): those at or past skv
  // get S = -1e30, so P = 0
  const bool kv_ok[2] = {k0 + warp * 16 + g < p.skv, k0 + warp * 16 + g + 8 < p.skv};

  copy_rows_async<BN, NTHREADS>(Ks, LD, kb, p.k_ss, k0, p.skv);
  copy_rows_async<BN, NTHREADS>(Vs, LD, vb, p.v_ss, k0, p.skv);
  copy_q_tile(Qs, Qs + TILE, rows_s, qb, dob, p, bh, 0);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_q = (p.sq + BM - 1) / BM;
  for (int qt = 0; qt < n_q; ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // q tile qt has landed, and every warp is done with tile qt - 1
    if (qt + 1 < n_q) {  // the next tile's copy overlaps this tile's products
      const int st = (qt + 1) % STAGES;
      copy_q_tile(Qs + 2 * st * TILE, Qs + (2 * st + 1) * TILE, rows_s + 2 * st * BM, qb, dob, p,
                  bh, (qt + 1) * BM);
      cp_async_commit();
    }
    if (qt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (warp * 16 + a_row(lane)) * LD + kk * 16 + a_col(lane);
        ldmatrix_x4(kf[kk], smem_u32(Ks + off));
        ldmatrix_x4(vf[kk], smem_u32(Vs + off));
      }
    }
    const bf16* Qt = Qs + 2 * (qt % STAGES) * TILE;
    const bf16* dOt = Qt + TILE;
    const float* lse_t = rows_s + 2 * (qt % STAGES) * BM;
    const float* di_t = lse_t + BM;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 64 q columns; Q and dO
    // rows are the n of the B operand, read by ldmatrix as they lie
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BM / 16; ++jp) {
        const int off = (jp * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane);
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, smem_u32(Qt + off));
        ldmatrix_x4(bo, smem_u32(dOt + off));
        mma_bf16(s[2 * jp], kf[kk], bq[0], bq[1]);
        mma_bf16(s[2 * jp + 1], kf[kk], bq[2], bq[3]);
        mma_bf16(dp[2 * jp], vf[kk], bo[0], bo[1]);
        mma_bf16(dp[2 * jp + 1], vf[kk], bo[2], bo[3]);
      }
    }
    // P^T = exp(S^T scale - LSE[q]) and dS^T = P^T (dP^T - Di[q]) scale, in
    // fp32; LSE and Di are indexed by column
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float x = kv_ok[e >> 1] ? s[j][e] * sl2 : kMask * kLog2e;
        const float pr = ex2(x - lse_t[c] * kLog2e);
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - di_t[c]) * p.scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 straight
    // from the accumulators; dO's and Q's k (the q row) runs along their
    // rows, so their B fragments come through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s, kk);
      acc_to_a(da, dp, kk);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        const int off = (kk * 16 + bk_row(lane)) * LD + np * 16 + bk_col(lane);
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, smem_u32(dOt + off));
        ldmatrix_x4_trans(bq, smem_u32(Qt + off));
        mma_bf16(dv[2 * np], pa, bo[0], bo[1]);
        mma_bf16(dv[2 * np + 1], pa, bo[2], bo[3]);
        mma_bf16(dk[2 * np], da, bq[0], bq[1]);
        mma_bf16(dk[2 * np + 1], da, bq[2], bq[3]);
      }
    }
  }

  // stage this warp's 16 rows of dK and dV in its own rows of the K and V
  // buffers (only this warp read them), then write rows < skv as 16-byte rows
  bf16* Kw = Ks + warp * 16 * LD;
  bf16* Vw = Vs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (g + 8 * i) * LD + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(Kw + off) = pack_f32(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(Vw + off) = pack_f32(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
  __syncwarp();
  bf16* dkb = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvb = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int it = 0; it < 16 * (D / 8) / 32; ++it) {
    const int idx = lane + 32 * it, r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = k0 + warp * 16 + r;
    if (row < p.skv) {
      *reinterpret_cast<uint4*>(dkb + (long long)row * p.dk_ss + c) =
          *reinterpret_cast<const uint4*>(Kw + r * LD + c);
      *reinterpret_cast<uint4*>(dvb + (long long)row * p.dv_ss + c) =
          *reinterpret_cast<const uint4*>(Vw + r * LD + c);
    }
  }
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_d64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.skv + BN - 1) / BN, batch * p.heads);
  flash_bwd_dkv_kernel_d64<<<grid, NTHREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dkv_bf16

// ---- K3 in bf16: the forward's shape on wgmma ------------------------------
namespace dq_bf16 {

using bf16 = __nv_bfloat16;
using namespace pso;

constexpr int TILE = 64 * 128;  // one 64-row tile of Q, dO, K or V: 8 KB
constexpr int STAGES = 2;       // the K / V copy ring
// 1 KB of slack to align the tiles to the 1024-byte swizzle period
constexpr size_t SMEM = 1024 + (size_t)TILE * (2 + 2 * STAGES);  // 50,176 bytes
constexpr float kLog2e = 1.4426950408889634f;

// One block (one warpgroup) per (64 q rows, batch*head), looping over kv
// tiles; warp w owns q rows 16w..16w+15 of the wgmma products.
__global__ void __launch_bounds__(NTHREADS, 4) flash_bwd_dq_kernel_d64(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qa = base, dOa = Qa + TILE;
  const uint32_t Ka = dOa + TILE;           // stage s at Ka + s * TILE
  const uint32_t Va = Ka + STAGES * TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float sl2 = p.scale * kLog2e;

  copy_rows_swz<D, BM, NTHREADS>(Qa, qb, p.q_ss, q0, p.sq);
  copy_rows_swz<D, BM, NTHREADS>(dOa, dob, p.do_ss, q0, p.sq);
  copy_rows_swz<D, BN, NTHREADS>(Ka, kb, p.k_ss, 0, p.skv);
  copy_rows_swz<D, BN, NTHREADS>(Va, vb, p.v_ss, 0, p.skv);
  cp_async_commit();
  // LSE (in log2 units) and Di of this thread's rows g and g + 8; 0 past sq,
  // where Q and dO are zero rows: P stays finite and dS = 0
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const bool ok = row < p.sq;
    lse2[i] = ok ? p.lse[(long long)bh * p.sq + row] * kLog2e : 0.f;
    di[i] = ok ? p.di[(long long)bh * p.sq + row] : 0.f;
  }

  const uint64_t dq_desc = sw128_desc(Qa, 16), ddo = sw128_desc(dOa, 16);
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  const int n_kv = (p.skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kv; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();  // this thread's copies, visible to wgmma
    __syncthreads();
    if (kt + 1 < n_kv) {  // the next tile's copy overlaps this tile's products
      const int st = (kt + 1) % STAGES;
      copy_rows_swz<D, BN, NTHREADS>(Ka + st * TILE, kb, p.k_ss, (kt + 1) * BN, p.skv);
      copy_rows_swz<D, BN, NTHREADS>(Va + st * TILE, vb, p.v_ss, (kt + 1) * BN, p.skv);
      cp_async_commit();
    }
    const uint32_t Kt = Ka + (kt % STAGES) * TILE, Vt = Va + (kt % STAGES) * TILE;
    const uint64_t dk = sw128_desc(Kt, 16), dv = sw128_desc(Vt, 16);
    // K read MN-major for dS K: one 64-wide block of n, 8-row groups 1024 apart
    const uint64_t dk_mn = sw128_desc(Kt, 1024);

    // S = Q K^T and dP = dO V^T, all four operands K-major in shared memory
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq_desc + 2 * kk, dk + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp, ddo + 2 * kk, dv + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);
    fence_acc(dp);

    // P = exp2(S scale log2 e - LSE log2 e), keys at or past skv masked;
    // dS = P (dP - Di) scale, in place of S
    const int k0 = kt * BN;
    const bool last = k0 + BN > p.skv;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool masked = last && k0 + j * 8 + 2 * t + (e & 1) >= p.skv;
        const float x = masked ? kMask * kLog2e : s[j][e] * sl2;
        const float pr = ex2(x - lse2[e >> 1]);
        s[j][e] = pr * (dp[j][e] - di[e >> 1]) * p.scale;
      }
    }

    // dQ += dS K: dS rounded to bf16 straight from the accumulators
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(da[kk], s, kk);
    fence_acc(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys = 2048 bytes of K a step
      wgmma_rs_mn(dq, da[kk], dk_mn + kk * (2048 >> 4));
    wgmma_commit();
    wgmma_wait0();
    fence_acc(dq);
    fence_a(da);
  }

  __syncthreads();  // the last product has read all of Q
  // dQ staged in this warp's own (swizzled) rows of the Q tile, then
  // written as 16-byte rows
  unsigned char* Qw = smem_raw + (Qa - raw) + warp * 16 * 128;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(Qw + sw128(g + 8 * i, j) + 4 * t) =
          pack_f32(dq[j][2 * i], dq[j][2 * i + 1]);
  __syncwarp();
  bf16* dqb = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int it = 0; it < 16 * 8 / 32; ++it) {
    const int idx = lane + 32 * it, r = idx >> 3, ch = idx & 7;
    const int row = q0 + warp * 16 + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(dqb + (long long)row * p.dq_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(Qw + sw128(r, ch));
  }
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_d64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.sq + BM - 1) / BM, batch * p.heads);
  flash_bwd_dq_kernel_d64<<<grid, NTHREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dq_bf16

template <bool kDkv>
int dispatch(int dtype, int d, const Params& p, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != D) return (int)cudaErrorInvalidValue;
  if constexpr (kDkv) {
    if (dtype == 0) return dkv_bf16::launch(p, batch, s);
  } else {
    if (dtype == 0) return dq_bf16::launch(p, batch, s);
  }
  if (dtype == 1) return launch<float, kDkv>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32; d must be 64. Strides are in elements;
// the last dim is contiguous. q/k/v/dout/dk/dv are (B, S, H, D) views; lse
// and di are (B*H, Sq) fp32. Writes dk and dv (kv rows < skv).
int flash_attn_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di, void* dk, void* dv,
                       long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long do_sb, long long do_ss, long long do_sh,
                       long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,
                       long long dv_ss, long long dv_sh, int batch, int heads, int sq, int skv,
                       float scale, void* stream) {
  Params p{q,     k,     v,     dout,  lse,   di,    nullptr, dk,    dv,    q_sb,  q_ss,
           q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,    do_sb, do_ss, do_sh, 0,
           0,     0,     dk_sb, dk_ss, dk_sh, dv_sb, dv_ss,   dv_sh, heads, sq,    skv,
           scale};
  return dispatch<true>(dtype, d, p, batch, stream);
}

// The same inputs; writes dq (q rows < sq).
int flash_attn_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di, void* dq,
                      long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh, long long do_sb, long long do_ss, long long do_sh,
                      long long dq_sb, long long dq_ss, long long dq_sh, int batch, int heads,
                      int sq, int skv, float scale, void* stream) {
  Params p{q,     k,     v,     dout,  lse,  di,   dq,    nullptr, nullptr, q_sb,  q_ss,
           q_sh,  k_sb,  k_ss,  k_sh,  v_sb, v_ss, v_sh,  do_sb,   do_ss,   do_sh, dq_sb,
           dq_ss, dq_sh, 0,     0,     0,    0,    0,     0,       heads,   sq,    skv,
           scale};
  return dispatch<false>(dtype, d, p, batch, stream);
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
