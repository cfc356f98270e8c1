// Flash-attention backward for Hopper (sm_90a), head dim 64: the
// gradients dQ, dK and dV of softmax(Q K^T * scale) V, recomputing the
// probabilities from the forward's per-row fp32 logsumexp (LSE).
//
// Replaces the TPU kernels pairwise_sample_optimization_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel (K2) and ::_bwd_dq_kernel (K3), both
// launched by _bwd, and _bwd's Di = rowsum(O * dO). Semantics kept:
//   S  = Q K^T * scale, columns at or past kv_len set to the finite -1e30
//   P  = exp(S - LSE)                   (masked columns give exactly 0)
//   dP = dO V^T
//   dS = P * (dP - Di) * scale,          Di = rowsum(O * dO) in fp32
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
// The products take their operands in the input dtype (P and dS are cast
// to it first) and accumulate in fp32; outputs are written in the input
// dtype.
//
// What bounds it on an H100: tensor-core operations at the UNet's 1024-
// and 4096-token self-attention (five products of 2*Sq*Skv*64 per head)
// and bytes at the 77-token cross-attention and the 256-token shapes,
// where a block's few tiles make latency and waves matter as much as
// either rate.
//
// bf16 (the whole backward of the update) takes two or three launches:
// - flash_bwd_pre_kernel: Di of every q row (8 threads a row, 16-byte
//   loads of O and dO), and zeroes the fp32 accumulators below.
// - flash_bwd_kernel_d64: one block of two warpgroups per (128 kv rows,
//   chunk of q tiles, batch*head), looping over the chunk's q tiles of 64;
//   warpgroup wg owns kv rows 64 wg..64 wg + 63, its warp w 16 of those.
//   The TPU design recomputes S and dP in both of its kernels (seven
//   products); here each tile pair computes them once (five products):
//   - S^T = K Q^T and dP^T = V dO^T on wgmma (m64n64k16, both operands
//     K-major in shared memory), so that each warp holds its kv rows; P^T
//     and dS^T in registers (LSE and Di indexed by column, staged per q
//     tile; the exponent in base 2 on the SFU);
//   - dV += P^T dO and dK += dS^T Q on wgmma with P^T and dS^T, rounded to
//     bf16, as register A operands (pso::acc_to_a) and dO / Q read
//     MN-major; dK and dV stay in registers across the q loop;
//   - dS^T is stored (bf16, 128-byte swizzle, kv rows) and dQ = dS K over
//     the block's 128 kv rows is a wgmma with both operands read MN-major
//     (dS^T and K transposed by the descriptors), taken by the warpgroups
//     in turns, one q tile each. The fp32 64 x 64 tile goes to a staging
//     tile in shared memory and one thread adds it to dQ's fp32
//     accumulator with a bulk reduction (cp.reduce.async.bulk .add.f32,
//     16 KB in one instruction) while the next q tile runs. Where one
//     block holds every key (skv <= 128) dQ is written as it is, in bf16;
//   - Q, dO, LSE and Di stream through a 3-stage cp.async ring in the
//     swizzled layout that both warpgroups read (tile it + 2 is copied
//     while tile it runs); K and V stay resident; dS^T alternates between
//     two buffers. So one __syncthreads a q tile is enough (after dS^T is
//     stored), and the warpgroup that does not take the tile's dQ goes on
//     to the next tile's products while the other runs dQ.
//   Two warpgroups on 128 kv rows, not one on 64, halve what goes through
//   L2 for the same products: the Q / dO tiles each block reads and the
//   dQ each block adds (at kv 4096 each would be 1.3 GB with 64 rows a
//   block).
//   Where one block per (128 kv rows, batch*head) would leave the card
//   under one wave (the 77-key cross-attention), the wrapper splits the q
//   loop into chunks (grid y); each chunk's dK and dV then go to fp32
//   accumulators by the same bulk reduction, else straight to bf16.
//   184 registers a thread (no spills) and 147 KB of shared memory: one
//   block of 8 warps an SM. Each warpgroup waits for every product of a
//   tile within its iteration: issuing the next tile's S^T / dP^T across
//   the loop's back edge was slower on the H100, since accumulators in
//   flight across the back edge make ptxas serialize the wgmma pipeline
//   (C7515).
// - flash_bwd_post_kernel: the fp32 accumulators (dQ where it has one; dK
//   and dV where q is split) to the input dtype in the caller's strides;
//   not launched where no gradient has an accumulator.
// Sums taken by the bulk reductions (dQ over blocks of kv rows; dK and dV
// over q chunks) are added in the order the blocks finish, which changes
// from run to run: each element is an fp32 sum of 2 to 32 partial tiles
// whose rounding (~1e-7 relative each) is far under the bf16 rounding of
// P and dS and of the output (~4e-3), so the result moves by a bf16 ulp
// or so between runs and bwd_tolerance (5% of the gradient's rms) holds it
// as it holds the rounding of P and dS.
// Pad rows: q rows past sq are zero-filled Q and dO with LSE = Di = 0, so
// P stays finite and a pad column adds nothing to dK or dV, and dS = 0 adds
// nothing to dQ (whose pad rows are in the accumulator, never written
// out); kv rows past skv are zero-filled and get S = -1e30 (P = 0) and are
// never stored.
//
// fp32 inputs (a correctness path, not a fast one) keep the first, simple
// two-kernel design (flash_bwd_dkv_kernel then flash_bwd_dq_kernel, after
// the same pre kernel's Di):
// - 4 warps, 64x64 tiles; each warp owns 16 rows of S / dP (all 64 columns)
//   and, in the dK/dV kernel, 16 kv rows of the dK / dV accumulators, in the
//   dQ kernel 16 q rows of dQ, computed with exact fp32 FMAs in the m16n8
//   fragment layout.
// - tiles are copied to shared memory with 16-byte loads from the caller's
//   (B, S, H, D) strides; rows past either sequence end are zero-filled and
//   their probabilities set to 0, which covers the 77-token kv without
//   padding on the host. Rows that do not exist are never written.
// - the dK/dV kernel stores P^T and dS^T in shared memory so the transposed
//   products read a row-major A operand; the dQ kernel stores dS row-major
//   (each warp its own rows).

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
  // the bf16 kernel: fp32 accumulators (dQ; dK and dV where q is split) and
  // the q tiles a block walks
  float* acc;
  int q_chunk;
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


// ---- Di, and the accumulators zeroed ----------------------------------------
namespace pre {

struct Params {
  const void* o;
  const void* dout;
  float* di;           // (B*H, Sq)
  float4* acc;         // the fp32 accumulators to zero (n_acc4 float4s)
  long long n_acc4;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int heads, sq;
  long long rows;      // B * Sq * H
};

__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

constexpr int THREADS = 256;

// Eight threads a (b, q, h) row, eight values each, summed over the eight
// by shuffles; every thread also zeroes a share of the accumulators.
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_pre_kernel(Params p) {
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = gid; i < p.n_acc4; i += stride) p.acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long row = gid >> 3;
  const int c = (int)(gid & 7);
  const bool ok = row < p.rows;
  const long long r = ok ? row : 0;
  const int h = (int)(r % p.heads), q = (int)((r / p.heads) % p.sq);
  const int b = (int)(r / ((long long)p.heads * p.sq));
  float sum = 0.f;
  if (ok) {
    float o[8], d[8];
    load8(o, static_cast<const T*>(p.o) + b * p.o_sb + q * p.o_ss + h * p.o_sh + c * 8);
    load8(d, static_cast<const T*>(p.dout) + b * p.do_sb + q * p.do_ss + h * p.do_sh + c * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum = fmaf(o[i], d[i], sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (ok && c == 0) p.di[((long long)b * p.heads + h) * p.sq + q] = sum;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // a thread a row's eighth, and at least one for every two float4s to zero
  const long long threads = p.rows * 8 > p.n_acc4 / 2 ? p.rows * 8 : p.n_acc4 / 2;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  flash_bwd_pre_kernel<T><<<(unsigned)(blocks > 0 ? blocks : 1), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace pre

// ---- the fp32 accumulator tiles (bf16 kernel and post kernel) ---------------
// A 64 x 64 fp32 tile of 256-byte rows, the 16-byte chunk ch (0..15) of row
// r at chunk ch ^ 2 (r % 8): the m16n8 fragments (row g or g + 8, columns
// 8 j + 2 t, +1) are stored as 8-byte pairs with no bank conflict, and the
// post kernel reads a row's 8 columns as two 16-byte loads. A tile is 16 KB
// in one piece, in shared memory and in the accumulator alike.
__device__ __forceinline__ uint32_t acc_off(int r, int ch) {
  return (uint32_t)(r * 256 + ((ch ^ ((r & 7) << 1)) << 4));
}

// ---- the bf16 backward: dQ, dK and dV in one kernel -------------------------
namespace bwd_bf16 {

using bf16 = __nv_bfloat16;
using namespace pso;

constexpr int NWG = 2;             // warpgroups a block, 64 kv rows each
constexpr int KV_ROWS = 64 * NWG;  // kv rows a block
constexpr int THREADS = 128 * NWG;
constexpr int TILE = 64 * 128;    // one 64-row bf16 tile of 128-byte rows: 8 KB
constexpr int ACC = 64 * 64 * 4;  // one 64 x 64 fp32 accumulator tile: 16 KB
constexpr int STAGES = 3;         // the Q / dO / LSE / Di copy ring
// 1 KB of slack to align the tiles to the 1024-byte swizzle period; K and V
// (NWG tiles each), STAGES x (Q, dO), two dS^T buffers (NWG tiles each);
// two fp32 staging tiles; STAGES x (LSE, Di): 150,016 bytes
constexpr size_t SMEM = 1024 + (size_t)TILE * (4 * NWG + 2 * STAGES) + 2 * (size_t)ACC +
                        STAGES * 2 * BM * sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;
static_assert(NTHREADS == 2 * BM, "one LSE or Di value per thread of the first warpgroup");
static_assert(2 * ACC <= 2 * STAGES * TILE, "the Q / dO ring holds two fp32 tiles");

// Start copying q tile [q0, q0 + BM): Q and dO rows (zero-filled past sq)
// into the swizzled tiles, LSE and Di (zero past sq) into rows.
__device__ __forceinline__ void copy_q_tile(uint32_t Qt, uint32_t dOt, uint32_t rows,
                                            const bf16* qb, const bf16* dob, const Params& p,
                                            int bh, int q0) {
  copy_rows_swz<D, BM, THREADS>(Qt, qb, p.q_ss, q0, p.sq);
  copy_rows_swz<D, BM, THREADS>(dOt, dob, p.do_ss, q0, p.sq);
  if (threadIdx.x < 2 * BM) {
    const int row = q0 + (int)(threadIdx.x % BM);
    const float* src = (threadIdx.x < BM ? p.lse : p.di) + (long long)bh * p.sq;
    cp_async_4(rows + threadIdx.x * 4, src + (row < p.sq ? row : p.sq - 1), row < p.sq);
  }
}

// This warp's 16 rows of a 64 x 64 fp32 accumulator (m16n8 fragments) into
// the staging tile at dst, laid out as acc_off says.
__device__ __forceinline__ void stage_acc(unsigned char* dst, const float (&c)[NT][4], int warp,
                                          int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(dst + acc_off(warp * 16 + g + 8 * i, 2 * j + (t >> 1)) +
                                 (t & 1) * 8) = make_float2(c[j][2 * i], c[j][2 * i + 1]);
}

// A warp's 16 rows of a 64 x 64 fp32 accumulator (m16n8 fragments) in
// bf16: staged in its own 16 swizzled 128-byte rows at stage, then rows
// row0.. (those < n) written to dst (row stride ss) as 16-byte rows.
__device__ __forceinline__ void store_rows_bf16(unsigned char* stage, const float (&c)[NT][4],
                                                bf16* dst, long long ss, int row0, int n,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(stage + sw128(g + 8 * i, j) + 4 * t) =
          pack_f32(c[j][2 * i], c[j][2 * i + 1]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * 8 / 32; ++it) {
    const int idx = lane + 32 * it, r = idx >> 3, ch = idx & 7;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ss + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + sw128(r, ch));
  }
  __syncwarp();
}

// One block per (KV_ROWS kv rows, chunk of q tiles, batch*head); warpgroup
// wg owns kv rows 64 wg..64 wg + 63 of the block, its warp w rows 16 w..
// 16 w + 15 of those.
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_kernel_d64(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);  // generic address of base
  const uint32_t Ka = base, Va = Ka + NWG * TILE;  // warpgroup wg's rows at + wg TILE
  const uint32_t Qa = Va + NWG * TILE;       // stage s: Q at Qa + 2 s TILE, dO right after it
  // dS^T of q tile it in buffer it % 2: kv rows (warpgroup wg's at + wg TILE) x q
  const uint32_t dSa = Qa + 2 * STAGES * TILE;
  const uint32_t Sa = dSa + 2 * NWG * TILE;  // two fp32 staging tiles
  const uint32_t Ra = Sa + 2 * ACC;          // stage s: LSE at Ra + 2 s BM floats, Di after it

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.z, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * KV_ROWS, kw = k0 + 64 * wg;  // kw: this warpgroup's first kv row
  const int n_q = (p.sq + BM - 1) / BM, n_kv = (p.skv + BN - 1) / BN;
  const int qt0 = blockIdx.y * p.q_chunk;
  const int qt1 = min(n_q, qt0 + p.q_chunk);
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float sl2 = p.scale * kLog2e;
  // this lane's kv rows (g and g + 8 of the warp's 16): those at or past skv
  // get S = -1e30, so P = 0
  const bool kv_ok[2] = {kw + warp * 16 + g < p.skv, kw + warp * 16 + g + 8 < p.skv};
  // with one block of kv rows (skv <= KV_ROWS) dQ is written as it is;
  // else added into its accumulator, for this head q tile qt at + qt BM D
  const bool dq_direct = gridDim.x == 1;
  float* const dq_acc = p.acc + (long long)bh * n_q * BM * D;

  copy_rows_swz<D, KV_ROWS, THREADS>(Ka, kb, p.k_ss, k0, p.skv);
  copy_rows_swz<D, KV_ROWS, THREADS>(Va, vb, p.v_ss, k0, p.skv);
  copy_q_tile(Qa, Qa + TILE, Ra, qb, dob, p, bh, qt0 * BM);
  cp_async_commit();
  if (qt0 + 1 < qt1) copy_q_tile(Qa + 2 * TILE, Qa + 3 * TILE, Ra + 2 * BM * 4, qb, dob, p, bh,
                                 (qt0 + 1) * BM);
  cp_async_commit();

  // this warpgroup's K and V rows K-major as the A of S^T = K Q^T and
  // dP^T = V dO^T; all KV_ROWS rows of K and dS^T MN-major (one 64-wide
  // block, 8-row groups 1024 bytes apart) as the B and A of dQ = dS K
  const uint64_t dk_desc = sw128_desc(Ka + wg * TILE, 16), dv_desc = sw128_desc(Va + wg * TILE, 16);
  const uint64_t dk_mn = sw128_desc(Ka, 1024), ds_mn = sw128_desc(dSa, 1024);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  cp_async_wait<1>();  // K, V and the first q tile
  fence_proxy_async();
  __syncthreads();
  for (int qt = qt0; qt < qt1; ++qt) {
    const int it = qt - qt0, st = it % STAGES;
    const uint32_t Qt = Qa + 2 * st * TILE, dOt = Qt + TILE;
    const float* lse_t = reinterpret_cast<const float*>(sbase + (Ra - base) + st * 2 * BM * 4);
    const float* di_t = lse_t + BM;

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 kv rows x 64 q columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    const uint64_t dq_k = sw128_desc(Qt, 16), ddo_k = sw128_desc(dOt, 16);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dk_desc + 2 * kk, dq_k + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp, dv_desc + 2 * kk, ddo_k + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);

    // P^T = exp2(S^T scale log2 e - LSE[q] log2 e) while dP^T is computed,
    // then dS^T = P^T (dP^T - Di[q]) scale; LSE and Di are indexed by column
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
      const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = kv_ok[e >> 1] ? s[j][e] * sl2 : kMask * kLog2e;
        s[j][e] = ex2(x - ((e & 1) ? l1 : l0));
      }
    }
    uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) acc_to_a(pa[kk], s, kk);
    const uint64_t ddo_mn = sw128_desc(dOt, 1024), dq_mn = sw128_desc(Qt, 1024);
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 di = *reinterpret_cast<const float2*>(di_t + 8 * j + 2 * t);
      const float d0 = di.x * p.scale, d1 = di.y * p.scale;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * fmaf(dp[j][e], p.scale, (e & 1) ? -d1 : -d0);
    }
    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 straight
    // from the accumulators; dO's and Q's k (the q row) runs down their rows
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) acc_to_a(da[kk], dp, kk);
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)  // 16 q rows = 2048 bytes of dO or Q a step
      wgmma_rs_mn(dv, pa[kk], ddo_mn + kk * (2048 >> 4));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs_mn(dk, da[kk], dq_mn + kk * (2048 >> 4));
    wgmma_commit();

    // dS^T (bf16) into shared memory while those run: this lane's kv rows
    // g and g + 8, q columns 16 kk + 8 (i / 2) + 2 t
    unsigned char* const dSw =
        sbase + (dSa - base) + ((it & 1) * NWG + wg) * TILE + warp * 16 * 128;
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(dSw + sw128(g + 8 * (i & 1), 2 * kk + (i >> 1)) + 4 * t) =
            da[kk][i];
    cp_async_wait<0>();  // tile it + 1 has landed
    fence_proxy_async();  // dS^T and this thread's copies, visible to wgmma
    if (tid == 0) bulk_wait_read<0>();  // tile it - 2's reduction is done with its staging tile
    __syncthreads();  // dS^T, tile it + 1 and tile it - 1's staged dQ are in place
    if (tid == 0 && it > 0 && !dq_direct) {  // add tile it - 1's dQ into the accumulator
      bulk_reduce_add_f32(dq_acc + (long long)(qt - 1) * BM * D, Sa + ((it - 1) & 1) * ACC, ACC);
      bulk_commit();
    }
    if (qt + 2 < qt1) {  // tile it + 2 into the stage tile it - 1 had
      const int nx = (it + 2) % STAGES;
      copy_q_tile(Qa + 2 * nx * TILE, Qa + (2 * nx + 1) * TILE, Ra + nx * 2 * BM * 4, qb, dob, p,
                  bh, (qt + 2) * BM);
    }
    cp_async_commit();

    if (wg == it % NWG) {
      // this tile's share of dQ = dS K: 64 q rows x 64 columns over the
      // block's KV_ROWS kv rows; the warpgroups take turns
      float dq[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
      fence_acc(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_ROWS / 16; ++kk)  // 16 kv rows = 2048 bytes of dS^T and of K a step
        wgmma_ss_tt(dq, ds_mn + (it & 1) * (NWG * TILE >> 4) + kk * (2048 >> 4),
                    dk_mn + kk * (2048 >> 4), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      unsigned char* const stage = sbase + (Sa - base) + (it & 1) * ACC;
      if (dq_direct) {
        // bf16, staged in this warp's own (swizzled) rows, written as 16-byte rows
        store_rows_bf16(stage + warp * 16 * 128, dq, static_cast<bf16*>(p.dq) + b * p.dq_sb +
                        h * p.dq_sh, p.dq_ss, qt * BM + warp * 16, p.sq, lane);
      } else {
        stage_acc(stage, dq, warp, g, t);
        fence_proxy_async();  // the staged tile, visible to the bulk reduction
      }
    } else {
      wgmma_wait<0>();
    }
    fence_acc(dk);
    fence_acc(dv);
    fence_a(pa);
    fence_a(da);
  }

  __syncthreads();  // the last tile's dQ is staged and every product is done with K and V
  if (tid == 0 && !dq_direct) {
    bulk_reduce_add_f32(dq_acc + (long long)(qt1 - 1) * BM * D, Sa + ((qt1 - 1 - qt0) & 1) * ACC,
                        ACC);
    bulk_commit();
  }
  if (gridDim.y == 1) {
    // every q tile is this block's: dK and dV in bf16, staged in this warp's
    // own rows of the K and V tiles
    store_rows_bf16(sbase + (Ka - base) + wg * TILE + warp * 16 * 128, dk,
                    static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_ss,
                    kw + warp * 16, p.skv, lane);
    store_rows_bf16(sbase + (Va - base) + wg * TILE + warp * 16 * 128, dv,
                    static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_ss,
                    kw + warp * 16, p.skv, lane);
  } else {
    // this chunk's dK and dV go to their fp32 accumulators (after dQ's, per
    // head n_kv * BN rows each): warpgroup 0's through the two staging
    // tiles, warpgroup 1's through the Q / dO ring
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();  // the staging tiles are free
    const uint32_t mine = wg == 0 ? Sa : Qa;
    stage_acc(sbase + (mine - base), dk, warp, g, t);
    stage_acc(sbase + (mine - base) + ACC, dv, warp, g, t);
    fence_proxy_async();
    __syncthreads();
    if ((tid & 127) == 0 && kw < p.skv) {
      const long long kv_rows = (long long)gridDim.z * n_kv * BN;
      float* const dk_acc = p.acc + (dq_direct ? 0 : (long long)gridDim.z * n_q * BM * D) +
                            ((long long)bh * n_kv * BN + kw) * D;
      bulk_reduce_add_f32(dk_acc, mine, ACC);
      bulk_reduce_add_f32(dk_acc + kv_rows * D, mine + ACC, ACC);
      bulk_commit();
    }
  }
  if ((tid & 127) == 0) bulk_wait<0>();  // the reductions are done with shared memory
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_kernel_d64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  const int n_q = (p.sq + BM - 1) / BM;
  if (p.q_chunk < 1) return cudaErrorInvalidValue;
  dim3 grid((p.skv + KV_ROWS - 1) / KV_ROWS, (n_q + p.q_chunk - 1) / p.q_chunk, batch * p.heads);
  flash_bwd_kernel_d64<<<grid, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bwd_bf16

// ---- the fp32 accumulators to bf16 ------------------------------------------
namespace post {

using bf16 = __nv_bfloat16;

struct Params {
  const float* acc;  // dQ's accumulator (with_q), then dK's and dV's (with_kv)
  void* dq;
  void* dk;
  void* dv;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int heads, sq, skv, with_q, with_kv;
};

// One block per (64-row tile, batch*head): blockIdx.x runs over dQ's q
// tiles (with_q), then dK's and dV's kv tiles (with_kv). A thread writes 8 columns
// of a row (16 bytes) from two 16-byte loads.
__global__ void __launch_bounds__(NTHREADS) flash_bwd_post_kernel(Params p) {
  const int n_q = (p.sq + BM - 1) / BM, n_kv = (p.skv + BN - 1) / BN;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads, heads_all = gridDim.y;
  const int nq = p.with_q ? n_q : 0;  // dQ's tiles here
  int tile = blockIdx.x, n;
  const float* src;
  bf16* dst;
  long long ss;
  if (tile < nq) {
    src = p.acc + ((long long)bh * n_q + tile) * BM * D;
    dst = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    ss = p.dq_ss;
    n = p.sq;
  } else {
    tile -= nq;
    const bool is_v = tile >= n_kv;
    if (is_v) tile -= n_kv;
    src = p.acc + (long long)heads_all * nq * BM * D +
          ((is_v ? (long long)heads_all : 0) * n_kv + (long long)bh * n_kv + tile) * BN * D;
    dst = is_v ? static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh
               : static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
    ss = is_v ? p.dv_ss : p.dk_ss;
    n = p.skv;
  }
  const unsigned char* tile_src = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
  for (int it = 0; it < BM * 8 / NTHREADS; ++it) {
    const int idx = threadIdx.x + NTHREADS * it, r = idx >> 3, m = idx & 7;
    const int row = tile * BM + r;
    if (row >= n) continue;
    const float4 a = *reinterpret_cast<const float4*>(tile_src + acc_off(r, 2 * m));
    const float4 c = *reinterpret_cast<const float4*>(tile_src + acc_off(r, 2 * m + 1));
    uint4 out;
    out.x = pso::pack_f32(a.x, a.y);
    out.y = pso::pack_f32(a.z, a.w);
    out.z = pso::pack_f32(c.x, c.y);
    out.w = pso::pack_f32(c.z, c.w);
    *reinterpret_cast<uint4*>(dst + (long long)row * ss + m * 8) = out;
  }
}

}  // namespace post

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32. o and dout are (B, Sq, H, 64) views
// (strides in elements, last dim contiguous); writes di (B*H, Sq) fp32 and
// zeroes acc[0, n_acc) (n_acc a multiple of 4; 0 for fp32).
int flash_attn_bwd_pre(int dtype, const void* o, const void* dout, float* di, float* acc,
                       long long n_acc, long long o_sb, long long o_ss, long long o_sh,
                       long long do_sb, long long do_ss, long long do_sh, int batch, int heads,
                       int sq, void* stream) {
  pre::Params p{};
  p.o = o, p.dout = dout, p.di = di, p.acc = reinterpret_cast<float4*>(acc), p.n_acc4 = n_acc / 4;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh, p.do_sb = do_sb, p.do_ss = do_ss, p.do_sh = do_sh;
  p.heads = heads, p.sq = sq, p.rows = (long long)batch * sq * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_acc % 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return pre::launch<__nv_bfloat16>(p, s);
  if (dtype == 1) return pre::launch<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

// dtype 0 (bf16): the one-kernel backward. With skv <= 128 dq is written;
// else dQ is added into acc (zeroed by flash_attn_bwd_pre; per head
// ceil(sq / 64) * 64 rows of 64 in the tiled layout above) and dq left to
// flash_attn_bwd_post. With q_chunk < ceil(sq / 64) q tiles the q loop is
// split and dK, dV are added into acc after dQ's accumulator, if any (per
// head ceil(skv / 64) * 64 rows each), else written to dk / dv. dtype 1
// (fp32): the two-kernel correctness path, writing dq, dk and dv; acc and
// q_chunk unused. d must be 64. q, k, v, dout, dq, dk, dv are (B, S, H, D)
// views; lse and di (B*H, Sq) fp32.
int flash_attn_bwd(int dtype, int d, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di, void* dq, void* dk,
                   void* dv, float* acc, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, long long do_sb, long long do_ss, long long do_sh,
                   long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
                   long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
                   long long dv_sh, int batch, int heads, int sq, int skv, int q_chunk,
                   float scale, void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.lse = lse, p.di = di, p.dq = dq, p.dk = dk,
  p.dv = dv;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh, p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh, p.do_sb = do_sb, p.do_ss = do_ss, p.do_sh = do_sh;
  p.dq_sb = dq_sb, p.dq_ss = dq_ss, p.dq_sh = dq_sh, p.dk_sb = dk_sb, p.dk_ss = dk_ss,
  p.dk_sh = dk_sh;
  p.dv_sb = dv_sb, p.dv_ss = dv_ss, p.dv_sh = dv_sh;
  p.heads = heads, p.sq = sq, p.skv = skv, p.scale = scale, p.acc = acc, p.q_chunk = q_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != D) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return bwd_bf16::launch(p, batch, s);
  if (dtype == 1) {
    const cudaError_t e = launch<float, true>(p, batch, s);
    return e != cudaSuccess ? (int)e : (int)launch<float, false>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 only: dq (with_q) and dk and dv (with_kv) from acc as flash_attn_bwd
// left it.
int flash_attn_bwd_post(const float* acc, void* dq, void* dk, void* dv, long long dq_sb,
                        long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
                        long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
                        int batch, int heads, int sq, int skv, int with_q, int with_kv,
                        void* stream) {
  post::Params p{};
  p.acc = acc, p.dq = dq, p.dk = dk, p.dv = dv;
  p.dq_sb = dq_sb, p.dq_ss = dq_ss, p.dq_sh = dq_sh, p.dk_sb = dk_sb, p.dk_ss = dk_ss,
  p.dk_sh = dk_sh, p.dv_sb = dv_sb, p.dv_ss = dv_ss, p.dv_sh = dv_sh;
  p.heads = heads, p.sq = sq, p.skv = skv, p.with_q = with_q, p.with_kv = with_kv;
  const int n_q = (sq + BM - 1) / BM, n_kv = (skv + BN - 1) / BN;
  dim3 grid((with_q ? n_q : 0) + (with_kv ? 2 * n_kv : 0), batch * heads);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  post::flash_bwd_post_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
