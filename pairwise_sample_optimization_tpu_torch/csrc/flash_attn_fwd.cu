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
// bf16 at d = 64 (the UNet, 7280 of the online loop's 7412 launches per
// epoch) takes its own kernel, flash_fwd_kernel_d64, built on Hopper's
// warpgroup products:
// - one block of one warpgroup (4 warps) per (64 query rows, batch*head);
//   warp w owns rows 16w..16w+15 of the products.
// - S = Q K^T is a wgmma m64n64k16 with both operands read from shared
//   memory through descriptors (Q and K rows are 128 bytes, so each tile is
//   a 128-byte-swizzled K-major operand); O += P V is a wgmma with P from
//   registers and V from shared memory read MN-major (transposed by the
//   descriptor). Accumulation in fp32.
// - S stays in registers: the online softmax reduces a row over the 4 lanes
//   of a quad (__shfl_xor_sync 1, 2), and the accumulator fragments of S,
//   exponentiated and rounded to bf16, are P's A fragments as they are
//   (pso::acc_to_a). No shared-memory round trip, one __syncthreads a tile.
// - K / V tiles of 64 keys stream through a 2-stage cp.async ring written in
//   the 128-byte swizzle, so the next tile's copy overlaps this tile's
//   products. Keys past kv_len are zero-filled by the copy (src-size 0,
//   address clamped to a real row) and masked to -1e30 as well: a zero key
//   gives S = 0, which unmasked would add exp(-m) to the row sum.
// - exponentials in base 2 on the SFU (S scaled by scale*log2 e); each lane
//   keeps its part of the row sum and the quad adds them once at the end;
//   O is normalised once, staged in the warp's own rows of the Q tile and
//   stored as 16-byte rows.
// - 41 KB of shared memory and 114 registers a thread: 4 blocks (16
//   warps) an SM. On the H100 this ran 1-9% faster at every main-path shape
//   than two warpgroups sharing 128 rows; the same structure on mma.sync
//   with ldmatrix operands (the first Hopper design, PERF.md) ran 1.3-1.4x
//   slower.
// - TMA copies and a producer warp are later work.
//
// Other dtypes and head dims (fp32; d = 80 PickScore, d = 512 VAE) keep the
// first, simple design (flash_fwd_kernel):
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
// - wgmma and TMA are later work here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using pso::from_float;
using pso::load_tile;
using pso::tile_mma;

constexpr float kMask = -1e30f;

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

// ---- bf16 at head dim 64: the UNet's attention ----------------------------
namespace d64 {

using bf16 = __nv_bfloat16;
using namespace pso;

constexpr int D = 64, BM = 64, BN = 64, NTHREADS = 128;  // one warpgroup
constexpr int ROW_BYTES = D * 2;             // 128: one swizzle row
constexpr int TILE_BYTES = BN * ROW_BYTES;   // one K or V tile, 8 KB
constexpr int STAGES = 2;                    // the K / V copy ring
// 1 KB of slack to align the tiles to the 1024-byte swizzle period
constexpr size_t SMEM = 1024 + (size_t)BM * ROW_BYTES + 2 * STAGES * TILE_BYTES;  // 41,984 bytes
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Byte offset of 16-byte chunk ch of row r in a tile of 128-byte rows with
// the 128-byte swizzle wgmma reads (chunk index XOR row mod 8).
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return (uint32_t)(r * ROW_BYTES + ((ch ^ (r & 7)) << 4));
}

// Start copying rows [row0, row0 + ROWS) of one head into a swizzled tile at
// shared address dst; rows at or past n are zero-filled, source clamped.
template <int ROWS>
__device__ __forceinline__ void copy_rows_sw128(uint32_t dst, const bf16* src,
                                                long long row_stride, int row0, int n) {
  static_assert((ROWS * 8) % NTHREADS == 0, "copy split");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / NTHREADS; ++it) {
    const int i = threadIdx.x + it * NTHREADS, r = i >> 3, ch = i & 7;
    const int row = row0 + r, src_row = row < n ? row : n - 1;
    cp_async_16(dst + sw128(r, ch), src + (long long)src_row * row_stride + ch * 8, row < n);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), swizzle mode 1 (128 B).
// 8-row groups are 1024 bytes apart (the stride offset); for K-major
// operands the leading offset is not used.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define PSO_ACC32(c)                                                                       \
  "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]), "+f"(c[1][1]), \
      "+f"(c[1][2]), "+f"(c[1][3]), "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]),            \
      "+f"(c[2][3]), "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),            \
      "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]), "+f"(c[5][0]),            \
      "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]), "+f"(c[6][0]), "+f"(c[6][1]),            \
      "+f"(c[6][2]), "+f"(c[6][3]), "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])

// c (64x64 fp32 over the warpgroup; this warp's 16 rows as 8 m16n8
// fragments) = [c +] A B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&c)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : PSO_ACC32(c)
      : "l"(da), "l"(db), "r"(accumulate));
}

// c += A B with A (this warp's 16x16 slice) in registers and B MN-major
// (its n runs along the rows of the shared tile) in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&c)[8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : PSO_ACC32(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_acc(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}
#undef PSO_ACC32

// One block (one warpgroup) per (64 query rows, batch*head); warp w owns
// query rows 16w..16w+15 of the wgmma products.
__global__ void __launch_bounds__(NTHREADS, 4) flash_fwd_kernel_d64(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qa = base;                             // BM rows
  const uint32_t Ka = Qa + BM * ROW_BYTES;              // stage s at Ka + s * TILE_BYTES
  const uint32_t Va = Ka + STAGES * TILE_BYTES;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float sl2 = p.scale * kLog2e, mask = kMask * kLog2e;

  copy_rows_sw128<BM>(Qa, qb, p.q_ss, q0, p.sq);
  copy_rows_sw128<BN>(Ka, kb, p.k_ss, 0, p.skv);
  copy_rows_sw128<BN>(Va, vb, p.v_ss, 0, p.skv);
  cp_async_commit();

  const uint64_t dq = sw128_desc(Qa, 16);
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_kv = (p.skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kv; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();  // this thread's copies, visible to wgmma
    __syncthreads();
    if (kt + 1 < n_kv) {  // the next tile's copy overlaps this tile's products
      const int st = (kt + 1) % STAGES;
      copy_rows_sw128<BN>(Ka + st * TILE_BYTES, kb, p.k_ss, (kt + 1) * BN, p.skv);
      copy_rows_sw128<BN>(Va + st * TILE_BYTES, vb, p.v_ss, (kt + 1) * BN, p.skv);
      cp_async_commit();
    }
    const uint64_t dk = sw128_desc(Ka + (kt % STAGES) * TILE_BYTES, 16);
    // V is read MN-major: its 8-row groups are 1024 bytes apart whichever of
    // the two offsets the hardware takes for them (one 64-wide block of n)
    const uint64_t dv = sw128_desc(Va + (kt % STAGES) * TILE_BYTES, 1024);

    // S = Q K^T, both K-major in shared memory
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // 32 bytes of each swizzled row a step
      wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);

    // scores in log2 units: exp2(S * scale * log2 e - m) = exp(S * scale - m ln 2)
    const int k0 = kt * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    if (k0 + BN > p.skv) {  // the last tile: zero-filled keys get the finite mask
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= p.skv) s[j][e] = mask;
    }
    // online softmax in registers; a row lives in the 4 lanes of a quad, and
    // each lane keeps its part of the row sum
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2(m[i] - mx[i]);  // 0 on the first tile
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ex2(s[j][e] - m[e >> 1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    l[0] = alpha[0] * l[0] + rs[0];  // from the fp32 P
    l[1] = alpha[1] * l[1] + rs[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P rounded to bf16 straight from the S accumulators
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s, kk);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys = 2048 bytes of V a step
      wgmma_rs_mn(o, pa[kk], dv + kk * (2048 >> 4));
    wgmma_commit();
    wgmma_wait0();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // P stays in its registers until read
      asm volatile("" ::"r"(pa[kk][0]), "r"(pa[kk][1]), "r"(pa[kk][2]), "r"(pa[kk][3]));
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
  }
  __syncthreads();  // the last product has read all of Q
  // O, normalised once, staged in this warp's own (swizzled) rows of the Q
  // tile, then written as 16-byte rows
  unsigned char* Ow = smem_raw + (Qa - raw) + warp * 16 * ROW_BYTES;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      *reinterpret_cast<uint32_t*>(Ow + sw128(r, j) + 4 * t) =
          pack_f32(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    }
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int it = 0; it < 16 * 8 / 32; ++it) {
    const int idx = lane + 32 * it, r = idx >> 3, ch = idx & 7;
    const int row = q0 + warp * 16 + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(ob + (long long)row * p.o_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(Ow + sw128(r, ch));
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + g + 8 * i;
      if (row < p.sq)
        p.lse[(long long)bh * p.sq + row] = m[i] * kLn2 + logf(l[i] == 0.f ? 1.f : l[i]);
    }
  }
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_d64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.sq + BM - 1) / BM, batch * p.heads);
  flash_fwd_kernel_d64<<<grid, NTHREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace d64

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
    if (d == 64) return d64::launch(p, batch, s);
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
