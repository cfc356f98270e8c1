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
// d = 64 (the UNet, 7280 of the online loop's 7412 launches per epoch) and
// d = 80 (PickScore's ViT-H/14, 128) share flash_fwd_kernel_wgmma<D>: one
// warpgroup (4 warps) per (64 query rows, batch*head), warp w owning rows
// 16w..16w+15; a 2-stage K / V ring, so the next tile's copy overlaps this
// tile's products, one __syncthreads a tile. A row of 64 values is one
// 128-byte swizzle row; at d = 80 a row (160 bytes) is split into 64
// columns in the 128-byte swizzle and 16 in the 32-byte one, so S takes a
// fifth k-step from the 32-byte blocks and P V a second product of n = 16.
// d = 64: 41 KB of shared memory and 114 registers, 4 blocks an SM; on the
// H100 this ran 1-9% faster at every main-path shape than two warpgroups
// sharing 128 rows, and 1.3-1.4x faster than the same structure on
// mma.sync with ldmatrix operands (PERF.md). d = 80: 51 KB and 146
// registers, 3 blocks an SM (4, capped at 128 registers, ran no faster).
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
// design (flash_fwd_kernel):
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

// The online softmax of one kv tile on S (64 x 64 fp32 over the warpgroup,
// this thread's rows g and g+8 of its warp's 16): scale to log2 units, mask
// keys at or past skv (the tile at k0 is the last when k0 + BN > skv),
// update the running max m and row sum l (this lane's part of it), replace
// S by P = exp2(S - m) and return the factors alpha that rescale O.
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2, int k0, int skv,
                                             int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
  if (k0 + BN > skv) {  // the last tile: zero-filled keys get the finite mask
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= skv) s[j][e] = kMask * kLog2e;
  }
  // a row lives in the 4 lanes of a quad, and each lane keeps its part of
  // the row sum
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
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
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = pso::ex2(s[j][e] - m[e >> 1]);
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

// ---- bf16 at head dims 64 and 80: one warpgroup ---------------------------
namespace wg {

using namespace pso;

constexpr int NTHREADS = 128, STAGES = 2;

template <int D>
struct Shape {
  static_assert(D == 64 || D == 80, "head dim");
  static constexpr bool TAIL = D == 80;          // columns 64..79, a 32-byte-swizzled block
  static constexpr int MAIN = 64 * 128;          // a tile's first 64 columns; the tail follows
  static constexpr int TILE = 64 * 2 * D;        // one Q, K or V tile of 64 rows: 8 or 10 KB
  static constexpr int CHUNKS = D / 8;           // 16-byte chunks of a row
  // 1 KB of slack to align the tiles to the 1024-byte swizzle period
  static constexpr size_t SMEM = 1024 + (size_t)TILE * (1 + 2 * STAGES);  // 41,984 / 52,224
  static constexpr int MIN_BLOCKS = D == 64 ? 4 : 3;  // blocks an SM
};

// One block (one warpgroup) per (64 query rows, batch*head); warp w owns
// query rows 16w..16w+15 of the wgmma products.
template <int D>
__global__ void __launch_bounds__(NTHREADS, Shape<D>::MIN_BLOCKS)
flash_fwd_kernel_wgmma(Params p) {
  using SH = Shape<D>;
  constexpr int TILE = SH::TILE, MAIN = SH::MAIN;
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

  const uint64_t dq = sw128_desc(Qa, 16), dq_tail = sw32_desc(Qa + MAIN);
  float o[8][4], ot[2][4];  // O's columns 0..63 and, at d = 80, 64..79
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) ot[j][0] = ot[j][1] = ot[j][2] = ot[j][3] = 0.f;
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

    // S = Q K^T, both K-major in shared memory
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 32 bytes of each swizzled row a step
      wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
    if constexpr (SH::TAIL) wgmma_ss(s, dq_tail, sw32_desc(Kt + MAIN), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);

    float alpha[2];
    softmax_tile(s, m, l, alpha, sl2, kt * BN, p.skv, t);
    rescale(o, alpha);
    if constexpr (SH::TAIL) rescale(ot, alpha);

    // O += P V: P rounded to bf16 straight from the S accumulators
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s, kk);
    fence_acc(o);
    if constexpr (SH::TAIL) fence_acc(ot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {  // 16 keys a step: 2048 bytes of V, 512 of its tail
      wgmma_rs_mn(o, pa[kk], dv + kk * (2048 >> 4));
      if constexpr (SH::TAIL) wgmma_rs_mn_n16(ot, pa[kk], sw32_desc(Vt + MAIN) + kk * (512 >> 4));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(o);
    if constexpr (SH::TAIL) fence_acc(ot);
    fence_a(pa);
  }

  float inv[2];
  finish_rows(l, inv);
  __syncthreads();  // the last product has read all of Q
  // O, normalised once, staged in this warp's own (swizzled) rows of the Q
  // tile, then written as 16-byte rows
  unsigned char* Ow = smem_raw + (Qa - raw) + warp * 16 * 128;
  unsigned char* Ot = smem_raw + (Qa - raw) + MAIN + warp * 16 * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(Ow + sw128(r, j) + 4 * t) =
          pack_f32(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    if constexpr (SH::TAIL) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(Ot + sw32(r, j) + 4 * t) =
            pack_f32(ot[j][2 * i] * inv[i], ot[j][2 * i + 1] * inv[i]);
    }
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int it = 0; it < 16 * SH::CHUNKS / 32; ++it) {
    const unsigned idx = lane + 32 * it;
    const int r = idx / SH::CHUNKS, ch = idx % SH::CHUNKS;
    const int row = q0 + warp * 16 + r;
    const unsigned char* src = ch < 8 ? Ow + sw128(r, ch) : Ot + sw32(r, ch - 8);
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
    wgmma_wait0();
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
    wgmma_wait0();
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
    if (d == 64) return wg::launch<64>(p, batch, s);
    if (d == 80) return wg::launch<80>(p, batch, s);
    if (d == 512) return d512::launch(p, batch, s);
  } else if (dtype == 1) {
    if (d == 64) return launch<float, 64, 4, 1, 64>(p, batch, s);
    if (d == 80) return launch<float, 80, 4, 1, 64>(p, batch, s);
    if (d == 512) return launch<float, 512, 2, 4, 32>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
