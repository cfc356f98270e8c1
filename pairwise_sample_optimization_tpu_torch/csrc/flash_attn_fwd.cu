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
// 1024- and 4096-token self-attention and the VAE mid-block (d = 512),
// and by bytes (Q, K, V read once, O and the LSE written once) at the short
// ones, 256/257 tokens and the 77-token cross-attention. At the short ones a
// block's work is a few kv tiles, so latency (copy, product, softmax, copy)
// and the number of waves over 132 SMs set the time, not either rate.
//
// Every bf16 head dim runs on Hopper's warpgroup products (pso::wgmma_*,
// csrc/wgmma.cuh), with the same steps a kv tile:
// - S = Q K^T is a wgmma with both operands read from shared memory through
//   descriptors, K-major; O += P V a wgmma with P from registers and V read
//   MN-major (transposed by the descriptor). Accumulation in fp32.
// - S stays in registers: the online softmax reduces a row over the 4 lanes
//   of a quad (__shfl_xor_sync 1, 2), and the accumulator fragments of S,
//   exponentiated and rounded to bf16, are P's A fragments as they are
//   (pso::acc_to_a). No shared-memory round trip.
// - K / V tiles of 64 keys are copied with cp.async in the swizzled layouts
//   wgmma reads. Keys past kv_len are zero-filled by the copy (src-size 0,
//   address clamped to a real row) and masked to -1e30 as well: a zero key
//   gives S = 0, which unmasked would add exp(-m) to the row sum.
// - exponentials in base 2 on the SFU (S scaled by scale*log2 e); each lane
//   keeps its part of the row sum and the quad adds them once at the end;
//   O is normalised once, staged in shared memory and stored as 16-byte
//   rows.
//
// d = 64 (the SDXL UNet, 7280 of the online loop's 7412 launches per epoch),
// d = 80 (PickScore's ViT-H/14, 128; the SD1.5 UNet's 640-channel level)
// and d = 160 (the SD1.5 UNet's 8 fixed heads over 1280 channels) share
// flash_fwd_kernel_wgmma<D>: one warpgroup (4 warps) per (64 query rows,
// batch*head), warp w owning rows 16w..16w+15; a 2-stage K / V ring, so the
// next tile's copy overlaps this tile's products, one __syncthreads a tile.
// A row is stored as blocks of 64 columns in the 128-byte swizzle, then
// blocks of 16 in the 32-byte one (pso::RowBlocks): d = 64 one 128-byte
// block; 80 one and one 16-column block (S takes a fifth k-step from it and
// P V a second product of n = 16); 160 two and two. d = 64: 41 KB of shared
// memory and 114 registers, 4 blocks an SM; on the H100 this ran 1-9%
// faster at every main-path shape than two warpgroups sharing 128 rows, and
// 1.3-1.4x faster than the same structure on mma.sync with ldmatrix
// operands (PERF.md). d = 80: 51 KB and 146 registers, 3 blocks an SM (4,
// capped at 128 registers, ran no faster). d = 160: 101 KB (O is 80 fp32
// registers a thread), 2 blocks an SM.
//
// d = 40 (the SD1.5 UNet's 320-channel level) has kernels of its own,
// flash_fwd_kernel_d40 and flash_fwd_kernel_d40_short (namespace d40
// below): the row as three 32-byte-swizzled 16-column blocks, the last
// holding columns 32..39 and 8 zero-filled ones, S over a depth of 48.
//
// d = 512 (the VAE mid-block, 4096 tokens, one head) takes
// flash_fwd_kernel_d512: a 64 x 512 fp32 O is 256 registers a thread in one
// warpgroup, so two warpgroups share the block's 64 query rows, each owning
// 256 of O's columns (128 registers). Each computes S over its half of d;
// the two fp32 partial S tiles are swapped through shared memory and each
// warpgroup adds the other's to its own (a + b = b + a in IEEE, so both
// hold the same S and run the same online softmax), then runs P V on its
// half of V. Q (64 KB), one 64-key K and V tile (64 KB each) and the
// partial S (32 KB) take 225 KB, one block an SM; with one buffer each, the
// next K tile's copy overlaps this tile's softmax and P V, the next V
// tile's the next S. 226 registers a thread, no spills.
//
// fp32 inputs (a correctness path, not a fast one) keep the first, simple
// design (flash_fwd_kernel; d = 40 zero-padded to a depth of 48 for S):
// - one block per (batch*head, 16*WM query rows); the block loops over kv
//   tiles of BN keys, which takes the place of the TPU's sequential
//   "arbitrary" grid axis. No state is carried between blocks.
// - Q, K and V tiles are copied to shared memory with 16-byte loads
//   straight from the caller's (B, S, H, D) strides; rows past the
//   sequence end are zero-filled and their columns masked here.
// - S = Q K^T and O += P V with exact fp32 FMAs in the m16n8 fragment
//   layout; S goes through shared memory for the row softmax. The O
//   accumulator is split across warps by rows (WM) and by head-dim columns
//   (WN).
// - TMA copies and a producer warp are later work for all of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using pso::from_float;
using pso::load_tile;
using pso::tile_mma;

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

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

template <typename T, int D, int WM, int WN, int BN>
struct Tiling {
  static constexpr int BM = 16 * WM;
  static constexpr int NWARPS = WM * WN;
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int DK = (D + 15) / 16 * 16;  // S's depth: d = 40 zero-padded to 48
  static constexpr int LDT = DK + PAD;  // Q, K, V rows
  static constexpr int LDS = BN + 4;    // fp32 S rows
  static constexpr int LDP = BN + PAD;  // P rows
  static constexpr int TPR = NTHREADS / BM;  // threads per softmax row
  static constexpr size_t SMEM = sizeof(T) * (size_t)(BM * LDT + 2 * BN * LDT + BM * LDP) +
                                 sizeof(float) * (size_t)(BM * LDS + 3 * BM);
  static_assert(BN % (8 * WN) == 0 && BN % 16 == 0, "kv tile");
  static_assert(D % (8 * WN) == 0, "head dim split");
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
  if constexpr (TL::DK > D) {  // the pad columns of Q and K, which no copy writes
    for (int i = tid; i < (BM + BN) * (TL::DK - D); i += TL::NTHREADS) {
      const int r = i / (TL::DK - D), c = D + i % (TL::DK - D);
      (r < BM ? Qs + r * LDT : Ks + (r - BM) * LDT)[c] = from_float<T>(0.f);
    }
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
    for (int kk = 0; kk < TL::DK; kk += 16) {
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
  // once per instantiation: the host's launch rate bounds the update
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.sq + TL::BM - 1) / TL::BM, batch * p.heads);
  kernel<<<grid, TL::NTHREADS, TL::SMEM, stream>>>(p);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;
constexpr int BM = 64, BN = 64;  // query rows a block, keys a kv tile (the wgmma kernels)

// 2^x on the FMA pipe, for x <= 0 (the softmax's exponents): x rounded to
// the nearest integer n by adding 1.5 * 2^23, 2^(x - n) by a degree-5
// polynomial on [-0.5, 0.5] (relative error 2.3e-7 in fp32, as ex2.approx's
// 2^-22), n added to its exponent. x is clamped at -126, so a masked key
// gives 2^-126 (~1e-38) where ex2.approx.ftz gives 0.
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  float p = fmaf(0.0013276457f, f, 0.0096755410f);
  p = fmaf(p, f, 0.0555071346f);
  p = fmaf(p, f, 0.2402212024f);
  p = fmaf(p, f, 0.6931469440f);
  p = fmaf(p, f, 1.0000001192f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(r) << 23));
}

// The online softmax of one kv tile on S (64 x 8N fp32 over the warpgroup,
// this thread's rows g and g+8 of its warp's 16): scale to log2 units, mask
// keys at or past skv (the tile at k0 is the last when k0 + 8N > skv),
// update the running max m and row sum l (this lane's part of it), replace
// S by P = exp2(S - m) and return the factors alpha that rescale O.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2, int k0, int skv,
                                             int t) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
  if (k0 + 8 * N > skv) {  // the last tile: zero-filled keys get the finite mask
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= skv) s[j][e] = kMask * kLog2e;
  }
  // a row lives in the 4 lanes of a quad, and each lane keeps its part of
  // the row sum
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = pso::ex2(m[i] - mx[i]);  // 0 on the first tile
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = pso::ex2(s[j][e] - m[e >> 1]);
    rs[0] += s[j][0] + s[j][1];
    rs[1] += s[j][2] + s[j][3];
  }
  l[0] = alpha[0] * l[0] + rs[0];  // from the fp32 P
  l[1] = alpha[1] * l[1] + rs[1];
}

// d = 40's softmax of a tile: as softmax_tile, with the row max taken on the
// raw S and the scale folded into one FFMA before each exponential
// (FlashAttention-3's), an operation an element fewer; one rounding of
// S * scale * log2 e - m where softmax_tile rounds twice. The last PN of the
// N n-tiles take their exponentials on the FMA pipe (ex2_fma), the others
// on the SFU, whose 16 a clock an SM bound d = 40. A scale <= 0 (the row
// max is then the raw minimum) takes softmax_tile.
template <int N, int PN>
__device__ __forceinline__ void softmax_tile_ffma(float (&s)[N][4], float (&m)[2], float (&l)[2],
                                                  float (&alpha)[2], float sl2, int k0, int skv,
                                                  int t) {
  if (!(sl2 > 0.f)) {
    softmax_tile(s, m, l, alpha, sl2, k0, skv, t);
    return;
  }
  if (k0 + 8 * N > skv) {  // the last tile: zero-filled keys give exp2(-inf) = 0
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= skv) s[j][e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float nm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * sl2);  // the max of S * sl2: sl2 > 0
    alpha[i] = pso::ex2(m[i] - m_new);  // 0 on the first tile
    m[i] = m_new;
    nm[i] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[j][e], sl2, nm[e >> 1]);
      s[j][e] = j < N - PN ? pso::ex2(x) : ex2_fma(x);
    }
    rs[0] += s[j][0] + s[j][1];
    rs[1] += s[j][2] + s[j][3];
  }
  l[0] = alpha[0] * l[0] + rs[0];  // from the fp32 P
  l[1] = alpha[1] * l[1] + rs[1];
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// The quad's row sums, added; 1 / l (1 where l == 0).
__device__ __forceinline__ void finish_rows(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
  }
}

// The LSE of this thread's two rows (lanes with t == 0), rows 16w..16w+15
// of the block's 64 from q0.
__device__ __forceinline__ void store_lse(const Params& p, int bh, int row0, const float (&m)[2],
                                          const float (&l)[2], int g, int t) {
  if (t != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row < p.sq)
      p.lse[(long long)bh * p.sq + row] = m[i] * kLn2 + logf(l[i] == 0.f ? 1.f : l[i]);
  }
}

// ---- bf16 at head dims 64, 80 and 160: one warpgroup --------------------
namespace wg {

using namespace pso;

constexpr int NTHREADS = 128, STAGES = 2;
constexpr int BLK = 64 * 128;  // one 64-row block of 64 columns, 128-byte swizzle
constexpr int TBLK = 64 * 32;  // one 64-row block of 16 columns, 32-byte swizzle

template <int D>
struct Shape {
  static_assert(D == 64 || D == 80 || D == 160, "head dim");
  using RB = RowBlocks<D>;
  static constexpr int FULL = RB::FULL;    // 64-column blocks: 1, 1, 2
  static constexpr int TAILS = RB::TAILS;  // 16-column blocks after them: 0, 1, 2
  static constexpr int MAIN = FULL * BLK;  // where a tile's 16-column blocks start
  static constexpr int TILE = RB::TILE;    // one Q, K or V tile of 64 rows: 8, 10 or 20 KB
  static constexpr int CHUNKS = RB::CHUNKS;  // real 16-byte chunks of a row
  // 1 KB of slack to align the tiles to the 1024-byte swizzle period
  static constexpr size_t SMEM = 1024 + (size_t)TILE * (1 + 2 * STAGES);
  static constexpr int MIN_BLOCKS = D == 160 ? 2 : (D == 80 ? 3 : 4);  // blocks an SM
  // O's accumulators: a 64-column block's and a 16-column block's (at least
  // one of each, so that no array is empty; the unused ones are never touched)
  static constexpr int NO = FULL > 0 ? FULL : 1, NT = TAILS > 0 ? TAILS : 1;
};

// One block (one warpgroup) per (64 query rows, batch*head); warp w owns
// query rows 16w..16w+15 of the wgmma products.
template <int D>
__global__ void __launch_bounds__(NTHREADS, Shape<D>::MIN_BLOCKS)
flash_fwd_kernel_wgmma(Params p) {
  using SH = Shape<D>;
  constexpr int TILE = SH::TILE, MAIN = SH::MAIN, FULL = SH::FULL, TAILS = SH::TAILS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qa = base;                // BM rows
  const uint32_t Ka = Qa + TILE;           // stage s at Ka + s * TILE
  const uint32_t Va = Ka + STAGES * TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float sl2 = p.scale * kLog2e;

  copy_rows_swz<D, BM, NTHREADS>(Qa, qb, p.q_ss, q0, p.sq);
  copy_rows_swz<D, BN, NTHREADS>(Ka, kb, p.k_ss, 0, p.skv);
  copy_rows_swz<D, BN, NTHREADS>(Va, vb, p.v_ss, 0, p.skv);
  cp_async_commit();

  // block c's descriptor is the first one's plus c * BLK bytes
  const uint64_t dq = sw128_desc(Qa, 16);
  float o[SH::NO][8][4], ot[SH::NT][2][4];  // O's 64-column and 16-column blocks
#pragma unroll
  for (int c = 0; c < SH::NO; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[c][j][0] = o[c][j][1] = o[c][j][2] = o[c][j][3] = 0.f;
#pragma unroll
  for (int c = 0; c < SH::NT; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) ot[c][j][0] = ot[c][j][1] = ot[c][j][2] = ot[c][j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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
    const uint64_t dk = sw128_desc(Kt, 16);
    // V is read MN-major: its 8-row groups are 1024 bytes apart whichever of
    // the two offsets the hardware takes for them (one 64-wide block of n)
    const uint64_t dv = sw128_desc(Vt, 1024);

    // S = Q K^T, both K-major in shared memory: 4 k-steps a 64-column block
    // (32 bytes of each swizzled row a step), 1 a 16-column block
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < FULL; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, dq + c * (BLK >> 4) + 2 * kk, dk + c * (BLK >> 4) + 2 * kk, c | kk);
#pragma unroll
    for (int c = 0; c < TAILS; ++c)
      wgmma_ss(s, sw32_desc(Qa + MAIN + c * TBLK), sw32_desc(Kt + MAIN + c * TBLK),
               FULL > 0 || c > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    float alpha[2];
    softmax_tile(s, m, l, alpha, sl2, kt * BN, p.skv, t);
#pragma unroll
    for (int c = 0; c < FULL; ++c) rescale(o[c], alpha);
#pragma unroll
    for (int c = 0; c < TAILS; ++c) rescale(ot[c], alpha);

    // O += P V: P rounded to bf16 straight from the S accumulators
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s, kk);
#pragma unroll
    for (int c = 0; c < FULL; ++c) fence_acc(o[c]);
#pragma unroll
    for (int c = 0; c < TAILS; ++c) fence_acc(ot[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {  // 16 keys a step: 2048 bytes of a 64-column block, 512 of a 16-column one
#pragma unroll
      for (int c = 0; c < FULL; ++c)
        wgmma_rs_mn(o[c], pa[kk], dv + c * (BLK >> 4) + kk * (2048 >> 4));
#pragma unroll
      for (int c = 0; c < TAILS; ++c)
        wgmma_rs_mn_n16(ot[c], pa[kk], sw32_desc(Vt + MAIN + c * TBLK) + kk * (512 >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < FULL; ++c) fence_acc(o[c]);
#pragma unroll
    for (int c = 0; c < TAILS; ++c) fence_acc(ot[c]);
    fence_a(pa);
  }

  float inv[2];
  finish_rows(l, inv);
  __syncthreads();  // the last product has read all of Q
  // O, normalised once, staged in this warp's own (swizzled) rows of the Q
  // tile's blocks, then written as 16-byte rows
  unsigned char* Ow = smem_raw + (Qa - raw) + warp * 16 * 128;
  unsigned char* Ot = smem_raw + (Qa - raw) + MAIN + warp * 16 * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
#pragma unroll
    for (int c = 0; c < FULL; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(Ow + c * BLK + sw128(r, j) + 4 * t) =
            pack_f32(o[c][j][2 * i] * inv[i], o[c][j][2 * i + 1] * inv[i]);
#pragma unroll
    for (int c = 0; c < TAILS; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(Ot + c * TBLK + sw32(r, j) + 4 * t) =
            pack_f32(ot[c][j][2 * i] * inv[i], ot[c][j][2 * i + 1] * inv[i]);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  constexpr int CH = SH::CHUNKS;
#pragma unroll
  for (int it = 0; it < (16 * CH + 31) / 32; ++it) {
    const unsigned idx = lane + 32 * it;
    const int r = idx / CH, ch = idx % CH;
    const int row = q0 + warp * 16 + r;
    const unsigned char* src = ch < 8 * FULL
                                   ? Ow + (ch >> 3) * BLK + sw128(r, ch & 7)
                                   : Ot + ((ch - 8 * FULL) >> 1) * TBLK + sw32(r, ch & 1);
    if ((16 * CH) % 32 == 0 || idx < 16 * CH)
      if (row < p.sq)
        *reinterpret_cast<uint4*>(ob + (long long)row * p.o_ss + ch * 8) =
            *reinterpret_cast<const uint4*>(src);
  }
  store_lse(p, bh, q0 + warp * 16, m, l, g, t);
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel_wgmma<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Shape<D>::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.sq + BM - 1) / BM, batch * p.heads);
  kernel<<<grid, NTHREADS, Shape<D>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

// ---- bf16 at head dim 40: its own kernels ---------------------------------
// d = 40 (the SD1.5 UNet's 320-channel level: 4096 tokens at 512^2, 8
// heads) does per (q, kv) pair the elementwise work of d = 64 (max, one
// exponential, the row sum, the bf16 cast) for 60% of its products. On the
// H100 (PERF.md) the one-warpgroup kernel above took 0.53 ms at
// (4,4096,8,40) kv 4096: its products and softmax took turns, and each
// 64-row block read all of K and V again. Two kernels replace it:
//
// flash_fwd_kernel_d40 (kv longer than KN keys, or none):
// - a block is two consumer warpgroups of 64 query rows sharing each K / V
//   tile, and one producer warp whose one thread fetches Q once and every
//   K and V tile of BN = 128 keys by TMA (tensor maps built per call,
//   pso::bshd_map: three 16-column boxes a tile, 32-byte swizzled, keys
//   past kv_len and columns 40..47 zero-filled) into rings of ST stages;
//   a tile completes a "full" mbarrier, and each consumer thread frees its
//   stage through an "empty" one once its product has read it. No barrier
//   joins the warpgroups in the loop.
// - in a warpgroup, an iteration issues S for tile j+1 (3 k-steps of
//   m64n128k16, depth 48) and O += P_j V_j (8 of m64n48k16: one descriptor
//   whose leading offset spans V's three 16-column blocks; O is 24
//   registers, its 8 pad columns never stored), and runs the softmax of
//   tile j+1 while the second product runs; both are drained before the
//   back edge, so no product's accumulators are in flight across it.
// - the two warpgroups take turns at issuing (named barriers 1 and 2,
//   FlashAttention-3's ping-pong), so one's softmax runs under the other's
//   products.
// - the softmax takes the row max on the raw S and folds the scale into
//   one FFMA before each exponential (softmax_tile_ffma); PN of the 16
//   n-tiles take their exponentials on the FMA pipe (ex2_fma).
//   168 registers, one block an SM (Q 12 KB, 4 stages of K and V 96 KB).
//   On the H100 it ran 1.5-1.7x as fast as the one-warpgroup kernel, about
//   as fast as SDPA's forward (PERF.md). Probes on the card with
//   parts taken out showed both the SFU and the copies (the L2 -> SM
//   traffic of 80-byte rows) near its time. Tried there and no faster:
//   cp.async with a __syncthreads a tile, three or four consumer
//   warpgroups, 64- or 96-key tiles, one 128-byte box a row, a 2-CTA
//   cluster sharing K and V by TMA multicast (much slower), P rounded by
//   integer operations.
//
// flash_fwd_kernel_d40_short (kv_len <= KN = 80: the 77-token
// cross-attention): K and V are one tile, read once a block; the block
// walks q tiles of 64 rows (each SM's blocks in one wave), the next q
// tile's copy (cp.async) running under this one's products, softmax and
// stores. S is one m64n80k16 product a k-step, so no key past 80 takes an
// exponential. 123 registers, 4 blocks an SM.
namespace d40 {

using namespace pso;

constexpr int D = 40;
constexpr int BN = 128, NWG = 2, ST = 4, PN = 2;  // the long kernel (measured, PERF.md)
constexpr int NC = 128 * NWG, NTHREADS = NC + 32, QROWS = 64 * NWG;
constexpr int QT = QROWS * 96, KT = BN * 96;  // a tile: three 32-byte-swizzled 16-column blocks
// 1 KB of alignment slack, Q, the K and V rings, then the mbarriers: Q's,
// and the full and empty ones of each K and V stage
constexpr size_t SMEM = 1024 + QT + 2 * ST * (size_t)KT + 8 * (1 + 4 * ST);
constexpr int KN = 80, SHORT_BLOCKS = 4;  // the short kernel: keys, blocks an SM

// S = Q K^T over a depth of 48 (Q's and K's columns 40..47 zero-filled):
// one K-major product of n = N a 16-column block; Qw is the warpgroup's
// first row of Q's blocks of qrows rows.
template <int N>
__device__ __forceinline__ void s_product(float (&s)[N / 8][4], uint32_t Qw, uint32_t Kt,
                                          int qrows) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint64_t dq = sw32_desc(Qw + c * qrows * 32), dk = sw32_desc(Kt + c * N * 32);
    if constexpr (N == 128)
      wgmma_ss_n128(s, dq, dk, c);
    else
      wgmma_ss_n80(s, dq, dk, c);
  }
}

// O += P V over N keys: one n = 48 product a 16-key step, V read MN-major
// over its three 16-column blocks (N rows of 32 bytes each apart).
template <int N>
__device__ __forceinline__ void pv_product(float (&o)[6][4], const uint32_t (&pa)[N / 16][4],
                                           uint32_t Vt) {
  const uint64_t dv = sw32_desc(Vt, N * 32);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs_mn_n48(o, pa[kk], dv + kk * (512 >> 4));
}

// O (6 n-tiles of this thread's rows g and g + 8), normalised by inv,
// staged in the warp's own 16 (swizzled) rows of a Q tile of qrows rows at
// Ow, then written as 16-byte rows (5 of the 6 chunks a row) from query row
// row0; the LSE beside it.
__device__ __forceinline__ void store_o(const Params& p, unsigned char* Ow, int qrows,
                                        const float (&o)[6][4], const float (&inv)[2], bf16* ob,
                                        int row0, int bh, const float (&m)[2],
                                        const float (&l)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj)
      *reinterpret_cast<uint32_t*>(Ow + (jj >> 1) * qrows * 32 + sw32(r, jj & 1) + 4 * t) =
          pack_f32(o[jj][2 * i] * inv[i], o[jj][2 * i + 1] * inv[i]);
  }
  __syncwarp();
  constexpr int CH = RowBlocks<D>::CHUNKS;
#pragma unroll
  for (int it = 0; it < (16 * CH + 31) / 32; ++it) {
    const unsigned idx = lane + 32 * it;
    const int r = idx / CH, ch = idx % CH;
    const int row = row0 + r;
    if (idx < 16 * CH && row < p.sq)
      *reinterpret_cast<uint4*>(ob + (long long)row * p.o_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(Ow + (ch >> 1) * qrows * 32 + sw32(r, ch & 1));
  }
  store_lse(p, bh, row0, m, l, g, t);
}

// One block per (QROWS query rows, batch*head): warpgroup w owns query rows
// 64w..64w+63 (warp i of it 16i..16i+15), the last warp is the producer.
// hs: each map's order of the head and row dims (pso::bshd_map).
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel_d40(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, int3 hs, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qa = base, Ka = Qa + QT, Va = Ka + ST * KT;  // stage i at + i * KT
  const uint32_t bars = Va + ST * KT, full_q = bars;
  auto full_k = [&](int i) { return bars + 8 * (1 + i); };
  auto empty_k = [&](int i) { return bars + 8 * (1 + ST + i); };
  auto full_v = [&](int i) { return bars + 8 * (1 + 2 * ST + i); };
  auto empty_v = [&](int i) { return bars + 8 * (1 + 3 * ST + i); };

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * QROWS;
  const int n_kv = (p.skv + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_k(i), 1);
      mbar_init(empty_k(i), NC);
      mbar_init(full_v(i), 1);
      mbar_init(empty_v(i), NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC && n_kv > 0) {
      mbar_expect_tx(full_q, QT);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        tma_load_bshd(Qa + c * QROWS * 32, &tq, hs.x, 16 * c, q0, h, b, full_q);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % ST;
        const uint32_t ph = ((j / ST) & 1) ^ 1;  // a fresh stage's wait passes at once
        mbar_wait(empty_k(st), ph);
        mbar_expect_tx(full_k(st), KT);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          tma_load_bshd(Ka + st * KT + c * BN * 32, &tk, hs.y, 16 * c, j * BN, h, b, full_k(st));
        mbar_wait(empty_v(st), ph);
        mbar_expect_tx(full_v(st), KT);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          tma_load_bshd(Va + st * KT + c * BN * 32, &tv, hs.z, 16 * c, j * BN, h, b, full_v(st));
      }
    }
    return;
  }

  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t = lane & 3;
  const float sl2 = p.scale * kLog2e;
  const uint32_t Qw = Qa + wgi * 64 * 32;
  // ping-pong: barrier 1 + w opens warpgroup w's product issue; the other
  // warpgroup opens it once it has issued its own (warpgroup 0 first; the
  // counts match: each warpgroup issues n_kv + 1 times)
  auto issue_begin = [&] { named_sync(1 + wgi, 256); };
  auto issue_end = [&](bool more) {
    if (more || wgi == 0) named_arrive(2 - wgi, 256);
  };

  float s[BN / 8][4], o[6][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  if (n_kv > 0) {  // (no keys: O = 0 and the LSE -inf, as the plain version's)
    if (wgi == 1) named_arrive(1, 256);
    mbar_wait(full_q, 0);
    mbar_wait(full_k(0), 0);
    issue_begin();
    fence_acc(s);
    wgmma_fence();
    s_product<BN>(s, Qw, Ka, QROWS);
    wgmma_commit();
    issue_end(true);
    wgmma_wait<0>();
    fence_acc(s);
    mbar_arrive(empty_k(0));
    softmax_tile_ffma<BN / 8, PN>(s, m, l, alpha, sl2, 0, p.skv, t);
    uint32_t pa[BN / 16][4];  // P of the tile whose P V comes next, bf16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s, kk);

    for (int j = 0; j + 1 < n_kv; ++j) {
      const int sk = (j + 1) % ST, sv = j % ST;
      mbar_wait(full_k(sk), ((j + 1) / ST) & 1);
      mbar_wait(full_v(sv), (j / ST) & 1);
      issue_begin();
      fence_acc(s);
      fence_acc(o);
      wgmma_fence();
      s_product<BN>(s, Qw, Ka + sk * KT, QROWS);  // S_{j+1}
      wgmma_commit();
      pv_product<BN>(o, pa, Va + sv * KT);  // O += P_j V_j
      wgmma_commit();
      issue_end(true);
      wgmma_wait<1>();  // S_{j+1}; the softmax runs under P_j V_j
      fence_acc(s);
      mbar_arrive(empty_k(sk));
      softmax_tile_ffma<BN / 8, PN>(s, m, l, alpha, sl2, (j + 1) * BN, p.skv, t);
      wgmma_wait<0>();
      fence_acc(o);
      fence_a(pa);
      mbar_arrive(empty_v(sv));
      rescale(o, alpha);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s, kk);
    }
    const int sv = (n_kv - 1) % ST;
    mbar_wait(full_v(sv), ((n_kv - 1) / ST) & 1);
    issue_begin();
    fence_acc(o);
    wgmma_fence();
    pv_product<BN>(o, pa, Va + sv * KT);
    wgmma_commit();
    issue_end(false);
    wgmma_wait<0>();
    fence_acc(o);
    fence_a(pa);
  }
  float inv[2];
  finish_rows(l, inv);
  // O staged in this warp's own rows of Q (its products are done with them)
  store_o(p, smem_raw + (Qa - raw) + (wgi * 64 + warp * 16) * 32, QROWS, o, inv,
          static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh, q0 + wgi * 64 + warp * 16, bh, m, l,
          lane);
}

// kv_len <= KN: one block of one warpgroup per (chunk of q tiles,
// batch*head), walking q tiles blockIdx.x, blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(128, SHORT_BLOCKS) flash_fwd_kernel_d40_short(Params p) {
  constexpr int QT1 = 64 * 96, KT1 = KN * 96;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 255) & ~255u;
  const uint32_t Ka = base, Va = Ka + KT1, Qa = Va + KT1;  // Q buffer i at Qa + i * QT1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float sl2 = p.scale * kLog2e;
  const int n_q = (p.sq + 63) / 64;

  copy_rows_swz<D, KN, 128>(Ka, kb, p.k_ss, 0, p.skv);
  copy_rows_swz<D, KN, 128>(Va, vb, p.v_ss, 0, p.skv);
  copy_rows_swz<D, 64, 128>(Qa, qb, p.q_ss, blockIdx.x * 64, p.sq);
  cp_async_commit();
  for (int i = blockIdx.x, it = 0; i < n_q; i += gridDim.x, ++it) {
    const uint32_t Qt = Qa + (it & 1) * QT1;
    cp_async_wait<0>();  // q tile i (and K, V)
    fence_proxy_async();
    __syncthreads();  // ... visible to all; the other buffer's last readers done
    if (i + gridDim.x < n_q)
      copy_rows_swz<D, 64, 128>(Qa + ((it + 1) & 1) * QT1, qb, p.q_ss, (i + gridDim.x) * 64,
                                p.sq);
    cp_async_commit();

    float s[KN / 8][4], o[6][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    fence_acc(s);
    wgmma_fence();
    s_product<KN>(s, Qt, Ka, 64);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    softmax_tile_ffma<KN / 8, 0>(s, m, l, alpha, sl2, 0, p.skv, t);
    uint32_t pa[KN / 16][4];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) acc_to_a(pa[kk], s, kk);
    fence_acc(o);
    wgmma_fence();
    pv_product<KN>(o, pa, Va);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_a(pa);

    float inv[2];
    finish_rows(l, inv);
    __syncthreads();  // every warp's S has read the q tile
    store_o(p, smem_raw + (Qt - raw) + warp * 16 * 32, 64, o, inv, ob, i * 64 + warp * 16, bh,
            m, l, lane);
  }
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  if (p.skv > 0 && p.skv <= KN) {
    constexpr size_t SMEM1 = 256 + 2 * (size_t)KN * 96 + 2 * 64 * 96;
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_kernel_d40_short, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM1);
    if (attr != cudaSuccess) return attr;
    static const int sms = [] {
      int dev = 0, n = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      return n;
    }();
    const int n_q = (p.sq + 63) / 64, bh = batch * p.heads;
    const int per_bh = (sms * SHORT_BLOCKS + bh - 1) / bh;  // each SM's blocks, one wave
    dim3 grid(per_bh < n_q ? per_bh : n_q, bh);
    flash_fwd_kernel_d40_short<<<grid, 128, SMEM1, stream>>>(p);
    return cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_d40, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  int3 hs;
  cudaError_t e = bshd_map(&tq, &hs.x, p.q, D, p.sq, p.heads, batch, p.q_ss, p.q_sh, p.q_sb, QROWS);
  if (e == cudaSuccess)
    e = bshd_map(&tk, &hs.y, p.k, D, p.skv, p.heads, batch, p.k_ss, p.k_sh, p.k_sb, BN);
  if (e == cudaSuccess)
    e = bshd_map(&tv, &hs.z, p.v, D, p.skv, p.heads, batch, p.v_ss, p.v_sh, p.v_sb, BN);
  if (e != cudaSuccess) return e;
  dim3 grid((p.sq + QROWS - 1) / QROWS, batch * p.heads);
  flash_fwd_kernel_d40<<<grid, NTHREADS, SMEM, stream>>>(tq, tk, tv, hs, p);
  return cudaGetLastError();
}

}  // namespace d40

// ---- bf16 at head dim 512: two warpgroups split d -------------------------
namespace d512 {

using namespace pso;

constexpr int D = 512, NTHREADS = 256;
constexpr int BLK = 64 * 128;        // 64 rows of one 64-column block: 8 KB
constexpr int TILE = (D / 64) * BLK; // a 64 x 512 tile: 64 KB
constexpr int HALF = D / 64 / 2;     // column blocks a warpgroup owns
// 1 KB of alignment slack, Q, K and V tiles, then both warpgroups' partial S
constexpr size_t SMEM = 1024 + 3 * (size_t)TILE + 2 * 64 * 64 * 4;  // 230,400 bytes

// One block (two warpgroups) per (64 query rows, batch*head). Warpgroup w
// owns head-dim columns 256w..256w+255: its S over them, and O's columns
// there; in both, warp i of the warpgroup owns query rows 16i..16i+15.
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_kernel_d512(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qa = base, Ka = Qa + TILE, Va = Ka + TILE;
  // the partial S tiles, [warpgroup][n-tile][thread of the warpgroup]
  float4* xchg = reinterpret_cast<float4*>(smem_raw + (Va + TILE - raw));

  const int wgi = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = wt >> 5;  // warp within the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float sl2 = p.scale * kLog2e;
  // this warpgroup's column blocks of Q, K and V; block c's descriptor is
  // the first one's plus c * BLK bytes
  const uint32_t Qh = Qa + wgi * HALF * BLK;
  const uint64_t dq = sw128_desc(Qh, 16), dk = sw128_desc(Ka + wgi * HALF * BLK, 16);
  const uint64_t dv = sw128_desc(Va + wgi * HALF * BLK, 1024);

  // two copy groups a tile, K then V; wait_group 1 lets the younger one run on
  copy_rows_swz<D, BM, NTHREADS>(Qa, qb, p.q_ss, q0, p.sq);
  copy_rows_swz<D, BN, NTHREADS>(Ka, kb, p.k_ss, 0, p.skv);
  cp_async_commit();
  copy_rows_swz<D, BN, NTHREADS>(Va, vb, p.v_ss, 0, p.skv);
  cp_async_commit();

  float o[HALF][8][4];
#pragma unroll
  for (int c = 0; c < HALF; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[c][j][0] = o[c][j][1] = o[c][j][2] = o[c][j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_kv = (p.skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kv; ++kt) {
    cp_async_wait<1>();  // K tile kt has landed
    fence_proxy_async();
    __syncthreads();

    // this warpgroup's partial S = Q K^T over its 256 columns of d
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < HALF; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, dq + c * (BLK >> 4) + 2 * kk, dk + c * (BLK >> 4) + 2 * kk, c | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      xchg[(wgi * 8 + j) * 128 + wt] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    __syncthreads();  // both partial S written; every read of the K tile done
    if (kt + 1 < n_kv) copy_rows_swz<D, BN, NTHREADS>(Ka, kb, p.k_ss, (kt + 1) * BN, p.skv);
    cp_async_commit();  // empty after the last tile: keeps two groups a tile
    // the full S: the other warpgroup's thread wt holds the same elements
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float4 x = xchg[((1 - wgi) * 8 + j) * 128 + wt];
      s[j][0] += x.x;
      s[j][1] += x.y;
      s[j][2] += x.z;
      s[j][3] += x.w;
    }

    float alpha[2];
    softmax_tile(s, m, l, alpha, sl2, kt * BN, p.skv, t);
#pragma unroll
    for (int c = 0; c < HALF; ++c) rescale(o[c], alpha);
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s, kk);

    cp_async_wait<1>();  // V tile kt has landed
    fence_proxy_async();
    __syncthreads();
    // O += P V over this warpgroup's 256 columns: one 64-column block of V,
    // read MN-major, a product
#pragma unroll
    for (int c = 0; c < HALF; ++c) fence_acc(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < HALF; ++c)
        wgmma_rs_mn(o[c], pa[kk], dv + c * (BLK >> 4) + kk * (2048 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < HALF; ++c) fence_acc(o[c]);
    fence_a(pa);
    __syncthreads();  // every read of the V tile and of the partial S done
    if (kt + 1 < n_kv) copy_rows_swz<D, BN, NTHREADS>(Va, vb, p.v_ss, (kt + 1) * BN, p.skv);
    cp_async_commit();
  }

  float inv[2];
  finish_rows(l, inv);
  // O, normalised once, staged in this warp's rows of the warpgroup's own Q
  // blocks (the last S read them before the loop's last barriers), then
  // written as 16-byte rows
  unsigned char* Ow = smem_raw + (Qh - raw) + warp * 16 * 128;
#pragma unroll
  for (int c = 0; c < HALF; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(Ow + c * BLK + sw128(g + 8 * i, j) + 4 * t) =
            pack_f32(o[c][j][2 * i] * inv[i], o[c][j][2 * i + 1] * inv[i]);
  __syncwarp();
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + wgi * HALF * 64;
#pragma unroll
  for (int it = 0; it < 16 * HALF * 8 / 32; ++it) {
    const unsigned idx = lane + 32 * it;
    const int r = idx / (HALF * 8), cc = idx % (HALF * 8);
    const int row = q0 + warp * 16 + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(ob + (long long)row * p.o_ss + cc * 8) =
          *reinterpret_cast<const uint4*>(Ow + (cc >> 3) * BLK + sw128(r, cc & 7));
  }
  if (wgi == 0) store_lse(p, bh, q0 + warp * 16, m, l, g, t);
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_d512, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.sq + BM - 1) / BM, batch * p.heads);
  flash_fwd_kernel_d512<<<grid, NTHREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace d512

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
    if (d == 40) return d40::launch(p, batch, s);
    if (d == 64) return wg::launch<64>(p, batch, s);
    if (d == 80) return wg::launch<80>(p, batch, s);
    if (d == 160) return wg::launch<160>(p, batch, s);
    if (d == 512) return d512::launch(p, batch, s);
  } else if (dtype == 1) {
    if (d == 40) return launch<float, 40, 4, 1, 64>(p, batch, s);
    if (d == 64) return launch<float, 64, 4, 1, 64>(p, batch, s);
    if (d == 80) return launch<float, 80, 4, 1, 64>(p, batch, s);
    if (d == 160) return launch<float, 160, 4, 2, 64>(p, batch, s);
    if (d == 512) return launch<float, 512, 2, 4, 32>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
