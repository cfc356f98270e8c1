// Flash-attention backward for Hopper (sm_90a), bf16 at head dims 40, 64,
// 80 and 160, and the Di kernel of every route: the gradients dQ, dK and dV
// of softmax(Q K^T * scale) V, recomputing the probabilities from the
// forward's per-row fp32 logsumexp (LSE).
//
// Replaces the TPU kernels pairwise_sample_optimization_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel (K2) and ::_bwd_dq_kernel (K3), both
// launched by _bwd, and _bwd's Di = rowsum(O * dO). Semantics kept:
//   S  = Q K^T * scale, columns at or past kv_len set to the finite -1e30
//   P  = exp(S - LSE)                   (masked columns give exactly 0)
//   dP = dO V^T
//   dS = P * (dP - Di) * scale,          Di = rowsum(O * dO) in fp32
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
// The products take their operands in bf16 (P and dS are rounded to it
// first) and accumulate in fp32; outputs are written in bf16.
//
// What bounds it on an H100: tensor-core operations at the UNets' 1024-
// and 4096-token self-attention (five products of 2*Sq*Skv*d per head)
// and bytes at the 77-token cross-attention and the 64- and 256-token
// shapes, where a block's few tiles make latency and waves matter as much
// as either rate.
//
// The bf16 backward takes two or three launches:
// - flash_bwd_pre_kernel: Di of every q row (8 threads a row, 16-byte
//   loads of O and dO; any d that is a multiple of 8), and zeroes the fp32
//   accumulators below (the pre kernel runs before every route).
// - flash_bwd_kernel<D>: one block of two warpgroups per (kv rows, chunk of
//   q tiles, batch*head), looping over the chunk's q tiles of 64. At
//   d = 40, 64 and 80 warpgroup wg owns kv rows 64 wg..64 wg + 63 of the
//   block's 128 and every column of dK, dV and dQ; at d = 160 (dK and dV of
//   64 rows would be 160 fp32 registers a thread) both warpgroups compute
//   S^T and dP^T of the block's 64 kv rows, and each owns half the columns
//   of dK, dV and dQ: the 64-column block wg and the 16-column block wg
//   (seven products' work for five, at the SD1.x shapes of 64-256 tokens).
//   Warp w holds 16 of its warpgroup's kv rows. The TPU design recomputes S
//   and dP in both of its kernels (seven products); here each tile pair
//   computes them once (five products):
//   - S^T = K Q^T and dP^T = V dO^T on wgmma (m64n64k16, both operands
//     K-major in shared memory), so that each warp holds its kv rows; P^T
//     and dS^T in registers (LSE and Di indexed by column, staged per q
//     tile; the exponent in base 2 on the SFU);
//   - dV += P^T dO and dK += dS^T Q on wgmma with P^T and dS^T, rounded to
//     bf16, as register A operands (pso::acc_to_a) and dO / Q read
//     MN-major; dK and dV stay in registers across the q loop;
//   - dS^T is stored (bf16, 128-byte swizzle, kv rows) and dQ = dS K over
//     the block's kv rows is a wgmma with both operands read MN-major (dS^T
//     and K transposed by the descriptors); at d = 40 / 64 / 80 the
//     warpgroups take it in turns, one q tile each, at 160 each takes its
//     columns of every tile. The fp32 tile goes to a staging tile in shared
//     memory and one thread adds it to dQ's fp32 accumulator with a bulk
//     reduction (cp.reduce.async.bulk .add.f32, 64 x d x 4 bytes in one
//     instruction) while the next q tile runs. Where one block holds every
//     key (skv <= its kv rows) dQ is written as it is, in bf16;
//   - a row of d values is stored as pso::RowBlocks says (wgmma.cuh): blocks
//     of 64 columns in the 128-byte swizzle, then blocks of 16 in the
//     32-byte one. Each block is its own k-steps of S^T and dP^T (4 or 1)
//     and its own products for dV, dK and dQ (n = 64 or 16); d = 40 is
//     three 16-column blocks, the last with 8 columns the copy zero-fills,
//     so S^T and dP^T run over a depth of 48, dV, dK and dQ are one n = 48
//     product each over the three blocks (one descriptor, the blocks'
//     distance its leading offset; a third of the instructions of three
//     n = 16 products, and faster on the H100), and the pad columns are
//     computed as 0 and never stored;
//   - Q, dO, LSE and Di stream through a 3-stage cp.async ring in the
//     swizzled layout that both warpgroups read (tile it + 2 is copied
//     while tile it runs); K and V stay resident; dS^T alternates between
//     two buffers. So one __syncthreads a q tile is enough (after dS^T is
//     stored; d = 160, with one staging tile, takes a second one before
//     its dQ tile is added), and at d = 40 / 64 / 80 the warpgroup that
//     does not take the tile's dQ goes on to the next tile's products.
//   Two warpgroups on 128 kv rows, not one on 64, halve what goes through
//   L2 for the same products: the Q / dO tiles each block reads and the
//   dQ each block adds (at kv 4096 each would be 1.3 GB with 64 rows a
//   block at d = 64).
//   Where one block per (kv rows, batch*head) would leave the card under
//   one wave (the 77-key cross-attention), the wrapper splits the q loop
//   into chunks (grid y); each chunk's dK and dV then go to fp32
//   accumulators by the same bulk reduction, else straight to bf16.
//   Registers a thread (no spills; ptxas -v): d = 40 188, 64 186, 80 231,
//   160 227. Shared memory: 117,248 / 150,016 / 178,688 / 223,744 bytes,
//   one block of 8 warps an SM. Each warpgroup waits for every product of a
//   tile within its iteration: issuing the next tile's S^T / dP^T across
//   the loop's back edge was slower on the H100, since accumulators in
//   flight across the back edge make ptxas serialize the wgmma pipeline
//   (C7515).
// - flash_bwd_post_kernel<D>: the fp32 accumulators (dQ where it has one;
//   dK and dV where q is split) to bf16 in the caller's strides; not
//   launched where no gradient has an accumulator.
// Sums taken by the bulk reductions (dQ over blocks of kv rows; dK and dV
// over q chunks) are added in the order the blocks finish, which changes
// from run to run: each element is an fp32 sum of 2 to 64 partial tiles
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
// fp32 inputs take the two-kernel backward of flash_attn_bwd_fma.cu (its
// own library, built in parallel with this one), after the same pre
// kernel's Di.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr int BM = 64, BN = 64, NWARPS = 4, NTHREADS = 32 * NWARPS;
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
  int chunks;          // 8-value chunks a row: d / 8
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

// Eight threads a (b, q, h) row, eight values at a time each (one chunk at
// d = 64; d = 40: threads 5-7 idle; 160: 2-3 chunks a thread), summed over
// the eight by shuffles; every thread also zeroes a share of the
// accumulators.
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
    for (int cc = c; cc < p.chunks; cc += 8) {
      float o[8], d[8];
      load8(o, static_cast<const T*>(p.o) + b * p.o_sb + q * p.o_ss + h * p.o_sh + cc * 8);
      load8(d, static_cast<const T*>(p.dout) + b * p.do_sb + q * p.do_ss + h * p.do_sh + cc * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = fmaf(o[i], d[i], sum);
    }
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

// ---- the fp32 accumulator tiles (bf16 kernels and post kernel) --------------
// A 64-row fp32 tile of D columns, as 8-column groups (one m16n8 n-tile
// each): first its 64-column blocks, each 64 rows of 256 bytes with group j
// of row r at group j ^ (r % 8), then its remaining groups (d = 40: five;
// 80: one block and two; 160: two blocks and four), each 64 rows of 32
// bytes. The m16n8 fragments (row g or g + 8, columns 2 t, 2 t + 1 of a
// group) are stored as 8-byte pairs with no bank conflict, and the post
// kernel reads a row's group as two 16-byte loads. A tile is 256 D bytes in
// one piece, in shared memory and in the accumulator alike.
template <int D>
__device__ __forceinline__ uint32_t acc_off(int r, int j) {
  constexpr int FULL = D / 64;
  return j < 8 * FULL ? (uint32_t)((j >> 3) * 64 * 256 + r * 256 + (((j & 7) ^ (r & 7)) << 5))
                      : (uint32_t)(FULL * 64 * 256 + (j - 8 * FULL) * 64 * 32 + r * 32);
}

// ---- the bf16 backward: dQ, dK and dV in one kernel -------------------------
namespace bwd_wg {

using bf16 = __nv_bfloat16;
using namespace pso;

constexpr int NWG = 2, THREADS = 128 * NWG;
constexpr int BLK = 64 * 128;  // 64 rows of a 64-column block (128-byte swizzle)
constexpr int TBLK = 64 * 32;  // 64 rows of a 16-column block (32-byte swizzle)
constexpr int STAGES = 3;      // the Q / dO / LSE / Di copy ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static_assert(D == 40 || D == 64 || D == 80 || D == 160, "head dim");
  using RB = RowBlocks<D>;
  static constexpr int FULL = RB::FULL, TAILS = RB::TAILS;  // 64- and 16-column blocks
  // d = 160: the two warpgroups share 64 kv rows and split the columns of dK,
  // dV and dQ (one 64- and one 16-column block each); else each owns 64 kv
  // rows and every column
  static constexpr bool SPLIT = D > 128;
  static constexpr int KV_ROWS = SPLIT ? 64 : 128;  // kv rows a block
  static constexpr int OF = SPLIT ? FULL / 2 : FULL, OT = SPLIT ? TAILS / 2 : TAILS;
  static constexpr int QT = RB::TILE;                  // a 64-row Q or dO tile
  static constexpr int KT = KV_ROWS / 64 * RB::TILE;  // the block's K or V rows
  static constexpr int DS = KV_ROWS * 128;            // a dS^T buffer: kv rows x 64 q
  static constexpr int ACC = 64 * D * 4;              // a 64-row fp32 tile
  static constexpr int STAGE_BUFS = SPLIT ? 1 : 2;    // fp32 staging tiles
  // 1 KB of slack to align the tiles to the 1024-byte swizzle period
  static constexpr size_t SMEM = 1024 + 2 * (size_t)KT + 2 * STAGES * (size_t)QT + 2 * (size_t)DS +
                                 STAGE_BUFS * (size_t)ACC + STAGES * 2 * BM * sizeof(float);
  // the accumulators of the column blocks a warpgroup owns (at least one of
  // each kind, so no array is empty; the unused ones are never touched)
  static constexpr int NO = OF > 0 ? OF : 1, NTL = OT > 0 ? OT : 1;
  // d = 40: dV, dK and dQ over the three 16-column blocks as one n = 48
  // product each, the blocks read through one descriptor
  static constexpr bool N48 = OT == 3;
  static_assert(2 * ACC <= 2 * STAGES * QT, "the Q / dO ring holds two fp32 tiles");
  static_assert(SPLIT || 2 * ACC <= STAGE_BUFS * ACC, "the staging tiles hold two fp32 tiles");
};

// A warpgroup's fp32 accumulators over the column blocks it owns: of 64
// columns (m16n8 fragments of 8 n-tiles) and of 16 (2 n-tiles).
template <int D>
struct Cols {
  float f[Shape<D>::NO][NT][4];
  float t[Shape<D>::NTL][2][4];
};

template <int D>
__device__ __forceinline__ void zero_cols(Cols<D>& c) {
#pragma unroll
  for (int b = 0; b < Shape<D>::NO; ++b)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c.f[b][j][e] = 0.f;
#pragma unroll
  for (int b = 0; b < Shape<D>::NTL; ++b)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c.t[b][j][e] = 0.f;
}

template <int D>
__device__ __forceinline__ void fence_cols(Cols<D>& c) {
#pragma unroll
  for (int b = 0; b < Shape<D>::OF; ++b) fence_acc(c.f[b]);
#pragma unroll
  for (int b = 0; b < Shape<D>::OT; ++b) fence_acc(c.t[b]);
}

// c += A B over the owned column blocks (the first ones fb0 and tb0) of a
// tile whose rows are the product's k, read MN-major: A is this warp's
// register fragment; `tile` holds `rows` rows a column block, its k-step
// kk at row 16 kk. d = 40's three 16-column blocks are one n = 48 product.
template <int D>
__device__ __forceinline__ void rs_cols(Cols<D>& c, const uint32_t (&a)[4], uint32_t tile,
                                        int rows, int fb0, int tb0, int kk) {
  using SH = Shape<D>;
  const uint32_t tails = tile + SH::FULL * rows * 128;
#pragma unroll
  for (int b = 0; b < SH::OF; ++b)
    wgmma_rs_mn(c.f[b], a, sw128_desc(tile + (fb0 + b) * rows * 128, 1024) + kk * (2048 >> 4));
  if constexpr (SH::N48) {
    wgmma_rs_mn_n48(reinterpret_cast<float(&)[6][4]>(c.t), a,
                    sw32_desc(tails, rows * 32) + kk * (512 >> 4));
  } else {
#pragma unroll
    for (int b = 0; b < SH::OT; ++b)
      wgmma_rs_mn_n16(c.t[b], a, sw32_desc(tails + (tb0 + b) * rows * 32) + kk * (512 >> 4));
  }
}

// Start copying q tile [q0, q0 + BM): Q and dO rows (zero-filled past sq)
// into the swizzled tiles, LSE and Di (zero past sq) into rows.
template <int D>
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

// This warp's 16 rows of the owned column blocks into the fp32 staging tile
// at dst (acc_off's layout); the pad group of d = 40 is not stored.
template <int D>
__device__ __forceinline__ void stage_cols(unsigned char* dst, const Cols<D>& c, int fb0,
                                           int tb0, int warp, int g, int t) {
  using SH = Shape<D>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
#pragma unroll
    for (int b = 0; b < SH::OF; ++b)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + acc_off<D>(r, 8 * (fb0 + b) + j) + t * 8) =
            make_float2(c.f[b][j][2 * i], c.f[b][j][2 * i + 1]);
#pragma unroll
    for (int b = 0; b < SH::OT; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int grp = 8 * SH::FULL + 2 * (tb0 + b) + j;
        if (grp < D / 8)
          *reinterpret_cast<float2*>(dst + acc_off<D>(r, grp) + t * 8) =
              make_float2(c.t[b][j][2 * i], c.t[b][j][2 * i + 1]);
      }
  }
}

// This warp's 16 rows (r0.. of a tile of `rows` rows a column block, in
// copy_rows_swz's layout at `tile`) of the owned column blocks in bf16:
// staged there, then the rows row0.. below n written to dst (row stride ss)
// in 16-byte chunks; the pad chunk of d = 40 is not written.
template <int D>
__device__ __forceinline__ void store_cols_bf16(unsigned char* tile, int rows, const Cols<D>& c,
                                                int fb0, int tb0, int r0, bf16* dst,
                                                long long ss, int row0, int n, int lane) {
  using SH = Shape<D>;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* const tails = tile + SH::FULL * rows * 128;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
#pragma unroll
    for (int b = 0; b < SH::OF; ++b)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<uint32_t*>(tile + (fb0 + b) * rows * 128 + sw128(r, j) + 4 * t) =
            pack_f32(c.f[b][j][2 * i], c.f[b][j][2 * i + 1]);
#pragma unroll
    for (int b = 0; b < SH::OT; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(tails + (tb0 + b) * rows * 32 + sw32(r, j) + 4 * t) =
            pack_f32(c.t[b][j][2 * i], c.t[b][j][2 * i + 1]);
  }
  __syncwarp();
  constexpr int CH = 8 * SH::OF + 2 * SH::OT;  // owned 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < (16 * CH + 31) / 32; ++it) {
    const int idx = lane + 32 * it;
    if ((16 * CH) % 32 != 0 && idx >= 16 * CH) break;
    const int rr = idx / CH, k = idx % CH, r = r0 + rr;
    const int blk = k < 8 * SH::OF ? fb0 + (k >> 3) : tb0 + ((k - 8 * SH::OF) >> 1);
    const int ch = k < 8 * SH::OF ? (k & 7) : ((k - 8 * SH::OF) & 1);
    const int col = k < 8 * SH::OF ? 8 * blk + ch : 8 * SH::FULL + 2 * blk + ch;  // chunk of the row
    const unsigned char* src = k < 8 * SH::OF ? tile + blk * rows * 128 + sw128(r, ch)
                                              : tails + blk * rows * 32 + sw32(r, ch);
    if (col < D / 8 && row0 + rr < n)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + rr) * ss + col * 8) =
          *reinterpret_cast<const uint4*>(src);
  }
  __syncwarp();
}

// One block per (KV_ROWS kv rows, chunk of q tiles, batch*head). d = 40,
// 64, 80: warpgroup wg owns kv rows 64 wg..64 wg + 63 of the block and
// every column; d = 160: both own the block's 64 kv rows, warpgroup wg the
// column blocks wg (64 columns) and 2 + wg (16). Warp w holds rows
// 16 w..16 w + 15 of the warpgroup's kv rows.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_kernel(Params p) {
  using SH = Shape<D>;
  constexpr int FULL = SH::FULL, TAILS = SH::TAILS, KV_ROWS = SH::KV_ROWS;
  constexpr int QT = SH::QT, KT = SH::KT, DS = SH::DS, ACC = SH::ACC;
  constexpr bool SPLIT = SH::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);  // generic address of base
  const uint32_t Ka = base, Va = Ka + KT;
  const uint32_t Qa = Va + KT;                 // stage s: Q at Qa + 2 s QT, dO right after it
  const uint32_t dSa = Qa + 2 * STAGES * QT;   // dS^T of q tile it in buffer it % 2
  const uint32_t Sa = dSa + 2 * DS;            // the fp32 staging tile(s)
  const uint32_t Ra = Sa + SH::STAGE_BUFS * ACC;  // stage s: LSE at Ra + 2 s BM floats, Di after it

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.z, b = bh / p.heads, h = bh % p.heads;
  const int kr = SPLIT ? 0 : 64 * wg;  // this warpgroup's first kv row in the block
  const int k0 = blockIdx.x * KV_ROWS, kw = k0 + kr;
  const int fb0 = SPLIT ? wg * SH::OF : 0, tb0 = SPLIT ? wg * SH::OT : 0;  // owned column blocks
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
  copy_q_tile<D>(Qa, Qa + QT, Ra, qb, dob, p, bh, qt0 * BM);
  cp_async_commit();
  if (qt0 + 1 < qt1)
    copy_q_tile<D>(Qa + 2 * QT, Qa + 3 * QT, Ra + 2 * BM * 4, qb, dob, p, bh, (qt0 + 1) * BM);
  cp_async_commit();

  // K-major descriptors of this warpgroup's K and V rows (the A of S^T =
  // K Q^T and dP^T = V dO^T): 64-column block c at + c KV_ROWS 128 bytes,
  // 16-column block c after them at + c KV_ROWS 32
  const uint32_t Ktail = Ka + FULL * KV_ROWS * 128, Vtail = Va + FULL * KV_ROWS * 128;
  const uint64_t dk_desc = sw128_desc(Ka + kr * 128, 16), dv_desc = sw128_desc(Va + kr * 128, 16);
  const uint64_t ds_mn = sw128_desc(dSa, 1024);  // dS^T MN-major: the A of dQ = dS K

  Cols<D> dk, dv;
  zero_cols(dk);
  zero_cols(dv);

  cp_async_wait<1>();  // K, V and the first q tile
  fence_proxy_async();
  __syncthreads();
  for (int qt = qt0; qt < qt1; ++qt) {
    const int it = qt - qt0, st = it % STAGES;
    const uint32_t Qt = Qa + 2 * st * QT, dOt = Qt + QT;
    const float* lse_t = reinterpret_cast<const float*>(sbase + (Ra - base) + st * 2 * BM * 4);
    const float* di_t = lse_t + BM;

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 kv rows x 64 q
    // columns over the whole depth (4 k-steps a 64-column block, 1 a
    // 16-column one; d = 40's last has 8 zero-filled columns in both)
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
    for (int c = 0; c < FULL; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, dk_desc + c * (KV_ROWS * 128 >> 4) + 2 * kk, dq_k + c * (BLK >> 4) + 2 * kk,
                 c | kk);
#pragma unroll
    for (int c = 0; c < TAILS; ++c)
      wgmma_ss(s, sw32_desc(Ktail + c * KV_ROWS * 32 + kr * 32),
               sw32_desc(Qt + FULL * BLK + c * TBLK), FULL > 0 || c > 0);
    wgmma_commit();
#pragma unroll
    for (int c = 0; c < FULL; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, dv_desc + c * (KV_ROWS * 128 >> 4) + 2 * kk, ddo_k + c * (BLK >> 4) + 2 * kk,
                 c | kk);
#pragma unroll
    for (int c = 0; c < TAILS; ++c)
      wgmma_ss(dp, sw32_desc(Vtail + c * KV_ROWS * 32 + kr * 32),
               sw32_desc(dOt + FULL * BLK + c * TBLK), FULL > 0 || c > 0);
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
    // dV += P^T dO and dK += dS^T Q over the owned column blocks: P^T and
    // dS^T rounded to bf16 straight from the accumulators; dO's and Q's k
    // (the q row) runs down their rows
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) acc_to_a(da[kk], dp, kk);
    fence_cols(dk);
    fence_cols(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) rs_cols(dv, pa[kk], dOt, BM, fb0, tb0, kk);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) rs_cols(dk, da[kk], Qt, BM, fb0, tb0, kk);
    wgmma_commit();

    // dS^T (bf16) into shared memory while those run (d = 160: the first
    // warpgroup's; both hold the same): this lane's kv rows g and g + 8, q
    // columns 16 kk + 8 (i / 2) + 2 t
    if (!SPLIT || wg == 0) {
      unsigned char* const dSw = sbase + (dSa - base) + (it & 1) * DS + (kr + warp * 16) * 128;
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(dSw + sw128(g + 8 * (i & 1), 2 * kk + (i >> 1)) + 4 * t) =
              da[kk][i];
    }
    cp_async_wait<0>();  // tile it + 1 has landed
    fence_proxy_async();  // dS^T and this thread's copies, visible to wgmma
    // the staging tile this tile's dQ goes to is no longer read (tile it - 2's
    // reduction; d = 160: tile it - 1's, one staging tile)
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();  // dS^T, tile it + 1 and tile it - 1's staged dQ are in place
    if (!SPLIT && tid == 0 && it > 0 && !dq_direct) {  // add tile it - 1's dQ into the accumulator
      bulk_reduce_add_f32(dq_acc + (long long)(qt - 1) * BM * D, Sa + ((it - 1) & 1) * ACC, ACC);
      bulk_commit();
    }
    if (qt + 2 < qt1) {  // tile it + 2 into the stage tile it - 1 had
      const int nx = (it + 2) % STAGES;
      copy_q_tile<D>(Qa + 2 * nx * QT, Qa + (2 * nx + 1) * QT, Ra + nx * 2 * BM * 4, qb, dob, p,
                     bh, (qt + 2) * BM);
    }
    cp_async_commit();

    // this tile's dQ = dS K over the block's KV_ROWS kv rows: 64 q rows x the
    // owned columns; d <= 80: the warpgroups take turns, one q tile each
    if (SPLIT || wg == it % NWG) {
      Cols<D> dq;
      zero_cols(dq);
      fence_cols(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_ROWS / 16; ++kk) {  // 16 kv rows: 2048 bytes of dS^T a step
        const uint64_t a = ds_mn + (it & 1) * (DS >> 4) + kk * (2048 >> 4);
#pragma unroll
        for (int c = 0; c < SH::OF; ++c)
          wgmma_ss_tt(dq.f[c], a, sw128_desc(Ka + (fb0 + c) * KV_ROWS * 128, 1024) +
                                      kk * (2048 >> 4), kk);
        if constexpr (SH::N48) {
          wgmma_ss_tt_n48(reinterpret_cast<float(&)[6][4]>(dq.t), a,
                          sw32_desc(Ktail, KV_ROWS * 32) + kk * (512 >> 4), kk);
        } else {
#pragma unroll
          for (int c = 0; c < SH::OT; ++c)
            wgmma_ss_tt_n16(dq.t[c], a, sw32_desc(Ktail + (tb0 + c) * KV_ROWS * 32) +
                                            kk * (512 >> 4), kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_cols(dq);
      unsigned char* const stage = sbase + (Sa - base) + (SPLIT ? 0 : (it & 1) * ACC);
      if (dq_direct) {
        // bf16, staged in this warp's own (swizzled) rows, written as 16-byte chunks
        store_cols_bf16<D>(stage, BM, dq, fb0, tb0, warp * 16, static_cast<bf16*>(p.dq) +
                           b * p.dq_sb + h * p.dq_sh, p.dq_ss, qt * BM + warp * 16, p.sq, lane);
      } else {
        stage_cols<D>(stage, dq, fb0, tb0, warp, g, t);
        fence_proxy_async();  // the staged tile, visible to the bulk reduction
      }
    } else {
      wgmma_wait<0>();
    }
    if (SPLIT && !dq_direct) {  // both halves of the tile staged: add it into the accumulator
      __syncthreads();
      if (tid == 0) {
        bulk_reduce_add_f32(dq_acc + (long long)qt * BM * D, Sa, ACC);
        bulk_commit();
      }
    }
    fence_cols(dk);
    fence_cols(dv);
    fence_a(pa);
    fence_a(da);
  }

  __syncthreads();  // the last tile's dQ is staged and every product is done with K and V
  if (!SPLIT && tid == 0 && !dq_direct) {
    bulk_reduce_add_f32(dq_acc + (long long)(qt1 - 1) * BM * D, Sa + ((qt1 - 1 - qt0) & 1) * ACC,
                        ACC);
    bulk_commit();
  }
  if (gridDim.y == 1) {
    // every q tile is this block's: dK and dV in bf16, staged in this warp's
    // own rows of the K and V tiles
    store_cols_bf16<D>(sbase + (Ka - base), KV_ROWS, dk, fb0, tb0, kr + warp * 16,
                       static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_ss,
                       kw + warp * 16, p.skv, lane);
    store_cols_bf16<D>(sbase + (Va - base), KV_ROWS, dv, fb0, tb0, kr + warp * 16,
                       static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_ss,
                       kw + warp * 16, p.skv, lane);
  } else {
    // this chunk's dK and dV go to their fp32 accumulators (after dQ's, per
    // head n_kv * BN rows each): d <= 80: warpgroup 0's through the two
    // staging tiles, warpgroup 1's through the Q / dO ring; d = 160: both
    // halves of the kv rows' tiles through the ring
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();  // the staging tiles are free
    const uint32_t mine = (SPLIT || wg == 1) ? Qa : Sa;
    stage_cols<D>(sbase + (mine - base), dk, fb0, tb0, warp, g, t);
    stage_cols<D>(sbase + (mine - base) + ACC, dv, fb0, tb0, warp, g, t);
    fence_proxy_async();
    __syncthreads();
    if ((SPLIT ? tid : (tid & 127)) == 0 && kw < p.skv) {
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

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using SH = Shape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SH::SMEM);
  if (attr != cudaSuccess) return attr;
  const int n_q = (p.sq + BM - 1) / BM;
  if (p.q_chunk < 1) return cudaErrorInvalidValue;
  dim3 grid((p.skv + SH::KV_ROWS - 1) / SH::KV_ROWS, (n_q + p.q_chunk - 1) / p.q_chunk,
            batch * p.heads);
  flash_bwd_kernel<D><<<grid, THREADS, SH::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bwd_wg

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
// tiles (with_q), then dK's and dV's kv tiles (with_kv). A thread writes an
// 8-column group of a row (16 bytes) from two 16-byte loads.
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_post_kernel(Params p) {
  constexpr int G = D / 8;  // 8-column groups a row
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
  for (int it = 0; it < (BM * G + NTHREADS - 1) / NTHREADS; ++it) {
    const int idx = threadIdx.x + NTHREADS * it, r = idx / G, m = idx % G;
    const int row = tile * BM + r;
    if ((BM * G) % NTHREADS != 0 && idx >= BM * G) break;
    if (row >= n) continue;
    const float4 a = *reinterpret_cast<const float4*>(tile_src + acc_off<D>(r, m));
    const float4 c = *reinterpret_cast<const float4*>(tile_src + acc_off<D>(r, m) + 16);
    uint4 out;
    out.x = pso::pack_f32(a.x, a.y);
    out.y = pso::pack_f32(a.z, a.w);
    out.z = pso::pack_f32(c.x, c.y);
    out.w = pso::pack_f32(c.z, c.w);
    *reinterpret_cast<uint4*>(dst + (long long)row * ss + m * 8) = out;
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int n_q = (p.sq + BM - 1) / BM, n_kv = (p.skv + BN - 1) / BN;
  dim3 grid((p.with_q ? n_q : 0) + (p.with_kv ? 2 * n_kv : 0), batch * p.heads);
  if (grid.x == 0) return cudaErrorInvalidValue;
  flash_bwd_post_kernel<D><<<grid, NTHREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace post

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32. o and dout are (B, Sq, H, d) views, d a
// multiple of 8 (strides in elements, last dim contiguous); writes di
// (B*H, Sq) fp32 and zeroes acc[0, n_acc) (n_acc a multiple of 4; 0 where
// no accumulator is used).
int flash_attn_bwd_pre(int dtype, int d, const void* o, const void* dout, float* di, float* acc,
                       long long n_acc, long long o_sb, long long o_ss, long long o_sh,
                       long long do_sb, long long do_ss, long long do_sh, int batch, int heads,
                       int sq, void* stream) {
  pre::Params p{};
  p.o = o, p.dout = dout, p.di = di, p.acc = reinterpret_cast<float4*>(acc), p.n_acc4 = n_acc / 4;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh, p.do_sb = do_sb, p.do_ss = do_ss, p.do_sh = do_sh;
  p.heads = heads, p.sq = sq, p.chunks = d / 8, p.rows = (long long)batch * sq * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_acc % 4 || d % 8 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return pre::launch<__nv_bfloat16>(p, s);
  if (dtype == 1) return pre::launch<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 at d = 40, 64, 80 or 160: the one-kernel backward. With skv at or
// below a block's kv rows (128; d = 160: 64) dq is written; else dQ is added
// into acc (zeroed by flash_attn_bwd_pre; per head ceil(sq / 64) tiles of 64
// rows in the tiled layout above) and dq left to flash_attn_bwd_post. With
// q_chunk < ceil(sq / 64) q tiles the q loop is split and dK, dV are added
// into acc after dQ's accumulator, if any (per head ceil(skv / 64) tiles
// each), else written to dk / dv. Any other dtype or d is refused: fp32
// takes the entry of the same name in flash_attn_bwd_fma.cu. q, k, v, dout,
// dq, dk, dv are (B, S, H, d) views; lse and di (B*H, Sq) fp32.
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (d == 40) return bwd_wg::launch<40>(p, batch, s);
  if (d == 64) return bwd_wg::launch<64>(p, batch, s);
  if (d == 80) return bwd_wg::launch<80>(p, batch, s);
  if (d == 160) return bwd_wg::launch<160>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 only: dq (with_q) and dk and dv (with_kv) from acc as flash_attn_bwd
// left it at head dim d.
int flash_attn_bwd_post(int d, const float* acc, void* dq, void* dk, void* dv, long long dq_sb,
                        long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
                        long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
                        int batch, int heads, int sq, int skv, int with_q, int with_kv,
                        void* stream) {
  post::Params p{};
  p.acc = acc, p.dq = dq, p.dk = dk, p.dv = dv;
  p.dq_sb = dq_sb, p.dq_ss = dq_ss, p.dq_sh = dq_sh, p.dk_sb = dk_sb, p.dk_ss = dk_ss,
  p.dk_sh = dk_sh, p.dv_sb = dv_sb, p.dv_ss = dv_ss, p.dv_sh = dv_sh;
  p.heads = heads, p.sq = sq, p.skv = skv, p.with_q = with_q, p.with_kv = with_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 40) return post::launch<40>(p, batch, s);
  if (d == 64) return post::launch<64>(p, batch, s);
  if (d == 80) return post::launch<80>(p, batch, s);
  if (d == 160) return post::launch<160>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

const char* pso_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
