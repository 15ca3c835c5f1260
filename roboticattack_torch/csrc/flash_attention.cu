// Attention forward (B1) and backward (B2) of the Llama decoder, hand-written
// for Hopper: bf16 tensor cores (mma.sync m16n8k16) fed by double-buffered
// cp.async copies.
//
// Replace the Pallas TPU kernels of roboticattack_tpu/ops/flash_attention.py:
//   flash_attention_fwd_bf16 <- _fwd_kernel (via _fwd_pallas)
//   flash_attention_bwd_bf16 <- _bwd_kernel (via _bwd_pallas)
// with the same arithmetic, per (batch, head):
//
//   S  = Q K^T * D^-1/2 + bias            (f32; q, k bf16, products exact)
//   P  = exp(S - rowmax S) / rowsum(...)  (f32)
//   O  = bf16(P) V                        (P rounded to bf16, f32 sums, O bf16)
//
//   dP = dO V^T,  dS = P * (dP - rowsum(dP * P))   (f32 P, dP and dS)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO   (outputs bf16)
//
// q, k, v, o, dO, dq, dk, dv: [BH, S, 128] bf16, contiguous.
// bias: [B, S, S] f32, shared by the H heads of a batch row (bh / H).
// stat_m, stat_l: [BH, S] f32, each row's max and sum of exp, written by
// the forward and read by the backward, which then recomputes the forward's
// P from them. dvec: [BH, S] f32 scratch of the backward, rowsum(dP * P).
//
// What bounds it on the card. At the attack step's shape ([8*32, 288, 128],
// chip_smoke.attention_bounds) B1 must move ~79 MB (q, k, v, o, bias, stats:
// ~23.5 us at 3.35 TB/s) for ~11 GFLOP of products (~11 us at 989 TFLOP/s of
// bf16), B2 ~135 MB (~40 us) for ~27 GFLOP (~27 us): the bytes bound both.
// The kernels recompute scores (B1 twice, B2's rows kernel twice and its
// columns kernel once more) and round S up to whole tiles, so they run
// ~20 (B1) and ~80 (B2) GFLOP of tensor work; the re-read tiles come from L2.
//
// Products and their operands:
//   * Q K^T, dO V^T (rows kernel), K Q^T, V dO^T (columns kernel) and
//     bf16(P) V have two bf16 operands: mma.sync with f32 accumulation forms
//     the same exact products; only the order of the f32 sums differs.
//   * dS K, dS^T Q and P^T dO have an f32 operand x (P or dS). It is split
//     into two bf16 terms, hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact
//     in f32), and each product is two mma's, hi then lo, against the exact
//     bf16 operand. |x - hi - lo| <= 2^-16 |x| (bf16 keeps 8 significant
//     bits; each rounding is within 2^-8 of its value), so a sum over j of
//     x_j b_j is off by at most 2^-16 sum_j |x_j b_j| plus the f32 sums'
//     own rounding: far below the 2^-7 max|plain| tolerance of the tests.
//     TF32 keeps 11 bits at the same cost, so it is worse here;
//     tests/test_torch_flash_attention.py emulates the split on the CPU.
//   * exp is the hardware's ex2.approx of x log2(e) (__expf), and the
//     division by the row sum l a multiplication by its correctly rounded
//     reciprocal: each differs from expf and IEEE division by a few f32 ulps
//     (relative error below 2^-20 wherever exp(x) >= 2^-24), far below the
//     bf16 rounding of P. P is still rounded to bf16 only after it is
//     normalised, and S still rounds the scale and the bias separately.
//
// Layout. A block is 4 warps (128 threads) and owns a 64-row tile: 16 rows a
// warp. It walks the other side's rows in 32-row steps. The m16n8 f32
// accumulator of a warp's 16 x 32 score tile (4 fragments, 16 registers)
// becomes the A operand of the next product in registers (the FA2 layout:
// fragments 2j, 2j + 1 give k-step j), never through shared memory: bf16(P)
// in B1's second pass, hi / lo of dS in the rows kernel. The columns kernel
// computes S^T = K Q^T and dP^T = V dO^T with keys as rows, so P^T and dS^T
// land as the A operands that dV += P^T dO and dK += dS^T Q need; it reads
// each query column's stat_m, stat_l and dvec from shared memory, and works
// 16 queries at a time so that its dK and dV accumulators (128 registers)
// leave room for the rest.
//   forward, one block per (query tile, bh), two passes over the key steps:
//     1. the row max and sum of exp (rescaled as the max grows);
//     2. the scores again, the normalised P, rounded to bf16 where the Pallas
//        kernel rounds it, and O += bf16(P) V.
//   backward, two kernels launched back to back on one stream:
//     rows, one block per (query tile, bh): a first sweep over the key steps
//       gives rowsum(dP * P) (written to dvec), a second one dQ;
//     columns, one block per (key tile, bh): a sweep over the query steps
//       gives dK and dV in registers that the block alone owns.
//   No atomics, and every sum is taken in a fixed order: two launches on the
//   same inputs give the same bits.
//   Skipped work, none of which changes a bit: a warp whose 16 own rows all
//   lie at or past S (nothing of it is stored) computes nothing; a warp whose
//   P for a step is all 0.0f (checked on the computed values, e.g. keys
//   above the causal diagonal) skips the products that would only add exact
//   zeros: P V in B1, dP and dQ in the rows kernel, dP^T, dV and dK in the
//   columns kernel.
//
// Staging. Tiles stay bf16 in shared memory (8 KB per 32 x 128 step, 16 KB
// per 64-row tile), each row's sixteen 16-byte chunks XOR-swizzled by
// (row & 7), so that ldmatrix (and ldmatrix.trans for V, K, Q and dO as B
// operands) reads 8 rows of one chunk column from 8 distinct bank groups. The
// bias tile ([64][32] or [32][64] f32, 8 KB) is staged too, swizzled for the
// reads of its accumulator layout; its rows are 4 S bytes, so it moves in
// 16-byte copies when S % 4 == 0 and in 4-byte ones otherwise. Each step's
// tiles are copied with cp.async into a second buffer while the current step
// is multiplied; rows and columns at or past S are zero-filled by cp.async's
// source size. Shared memory per block: 64 KB forward (Q; K, V, bias x 2),
// 80 KB rows (Q, dO; K, V, bias x 2), 80.75 KB columns (K, V; Q, dO, bias
// and the three row vectors x 2). ptxas (CUDA 12.8, sm_90a): 166 registers
// forward, 179 rows, 252 columns, no spills; so 3 forward blocks or 2
// backward blocks share an SM. Outputs go back through the warp's own rows
// of a staged tile, as 16-byte stores.
//
// What still holds them back (PERF.md): most of a step's instructions are
// address arithmetic and element-wise work (the scale and bias, the
// softmax, which the two-pass forward and the two-sweep rows kernel do
// twice), not mma's; at 8-12 warps an SM the step is latency-bound rather
// than bound by the tensor cores, the copies or L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;     // head dim
constexpr int kOwn = 64;    // rows of the tile a block owns: 4 warps x 16
constexpr int kStep = 32;   // rows of the other side's tile per step
constexpr int kThreads = 128;
constexpr int kChunks = kD / 8;  // 16-byte chunks per row
constexpr uint32_t kOwnBytes = kOwn * kD * 2;     // 16 KB
constexpr uint32_t kStepBytes = kStep * kD * 2;   // 8 KB
constexpr uint32_t kBiasBytes = kOwn * kStep * 4; // 8 KB
constexpr uint32_t kVecBytes = kStep * 4;

// a stage (double-buffered): two step tiles and the bias tile, and in the
// columns kernel the step's stat_m, stat_l and dvec
constexpr uint32_t kStage = 2 * kStepBytes + kBiasBytes;
constexpr uint32_t kColStage = kStage + 3 * kVecBytes;
constexpr size_t kFwdSmem = kOwnBytes + 2 * kStage;       // Q; K, V, bias x 2
constexpr size_t kRowSmem = 2 * kOwnBytes + 2 * kStage;   // Q, dO; K, V, bias x 2
constexpr size_t kColSmem = 2 * kOwnBytes + 2 * kColStage;  // K, V; Q, dO, bias, vectors x 2

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][128] bf16 tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (kD * 2) + ((c ^ (r & 7)) << 4));
}

// Byte offset of element (r, col) of a swizzled [rows][Cols] f32 bias tile
// (Cols 32 or 64: every row starts on bank 0). The chunk XOR keeps the reads
// of one accumulator fragment on distinct banks: rows g of a warp's float2
// reads (by rows), or rows 2t of its scalar reads (ByColumn, the columns
// kernel's transposed fragments).
template <int Cols, bool ByColumn>
__device__ __forceinline__ uint32_t bias_off(int r, int col) {
  const int key = ByColumn ? ((r >> 1) & 3) << 1 : (r & 3) << 1;
  return static_cast<uint32_t>(r * Cols * 4 + (((col >> 2) ^ key) << 4) + ((col & 3) << 2));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Rows [r0, r0 + Rows) of a [S, 128] bf16 matrix into a swizzled tile; rows
// at or past S are zero.
template <int Rows>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int r0, int S) {
#pragma unroll
  for (int u = 0; u < Rows * kChunks / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const bool valid = r0 + r < S;
    cp_async16(dst + swz(r, ch), valid ? src + static_cast<size_t>(r0 + r) * kD + ch * 8 : src, valid);
  }
}

// bias[i0 + r][j0 + col] (r < Rows, col < Cols) into a swizzled tile, zero
// at or past S. Rows are 4 S bytes: 16-byte copies when S % 4 == 0, else
// 4-byte ones.
template <int Rows, int Cols, bool ByColumn>
__device__ __forceinline__ void load_bias(uint32_t dst, const float* bias, int i0, int j0, int S) {
  if (S % 4 == 0) {
#pragma unroll
    for (int u = 0; u < Rows * Cols / 4 / kThreads; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int r = c / (Cols / 4), col = 4 * (c % (Cols / 4));
      const bool valid = i0 + r < S && j0 + col < S;
      const float* src = valid ? bias + static_cast<size_t>(i0 + r) * S + j0 + col : bias;
      cp_async16(dst + bias_off<Cols, ByColumn>(r, col), src, valid);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < Rows * Cols / kThreads; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int r = c / Cols, col = c % Cols;
      const bool valid = i0 + r < S && j0 + col < S;
      const float* src = valid ? bias + static_cast<size_t>(i0 + r) * S + j0 + col : bias;
      cp_async4(dst + bias_off<Cols, ByColumn>(r, col), src, valid);
    }
  }
}

// Entries [r0, r0 + kStep) of an f32 vector of length S; entries past S are 0.
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src, int r0, int S) {
  if (threadIdx.x < kStep) {
    const bool valid = r0 + threadIdx.x < S;
    cp_async4(dst + 4 * threadIdx.x, valid ? src + r0 + threadIdx.x : src, valid);
  }
}

__device__ __forceinline__ void ldsm(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// bf16(x), bf16(y) in one register, x in the low half.
__device__ __forceinline__ uint32_t pack(float x, float y) { return bits(__floats2bfloat162_rn(x, y)); }

// The two-term split of (x, y): hi = bf16, lo = bf16 of the exact remainder.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(__fsub_rn(x, f.x), __fsub_rn(y, f.y));
}

// A operands of k-step j (16 columns) from the accumulator fragments of a
// 16-row tile: fragments 2j (columns 16j + 0..7) and 2j + 1 (16j + 8..15).
__device__ __forceinline__ void frag_a(uint32_t a[4], const float (*f)[4], int j) {
  a[0] = pack(f[2 * j][0], f[2 * j][1]);
  a[1] = pack(f[2 * j][2], f[2 * j][3]);
  a[2] = pack(f[2 * j + 1][0], f[2 * j + 1][1]);
  a[3] = pack(f[2 * j + 1][2], f[2 * j + 1][3]);
}

__device__ __forceinline__ void frag_a_split(uint32_t hi[4], uint32_t lo[4], const float (*f)[4], int j) {
  split(f[2 * j][0], f[2 * j][1], hi[0], lo[0]);
  split(f[2 * j][2], f[2 * j][3], hi[1], lo[1]);
  split(f[2 * j + 1][0], f[2 * j + 1][1], hi[2], lo[2]);
  split(f[2 * j + 1][2], f[2 * j + 1][3], hi[3], lo[3]);
}

// ldmatrix addresses. A operand: rows r0..r0+15 of a tile, k-step kk.
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int kk, int lane) {
  return tile + swz(r0 + (lane & 15), 2 * kk + (lane >> 4));
}
// B operand from a tile whose rows are the n index (B = tile^T): n-tiles
// n0..n0+7 and n0+8..n0+15, k-step kk; regs {b0, b1} of each.
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int n0, int kk, int lane) {
  return tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
}
// B operand from a tile whose rows are the k index (ldmatrix.trans): k rows
// k0..k0+15, n columns 16 np..16 np+15.
__device__ __forceinline__ uint32_t bn_addr(uint32_t tile, int k0, int np, int lane) {
  return tile + swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * np + (lane >> 4));
}

// f[nt] (nt < 2 NPairs) = A[r0..r0+15] . B[n0 + 8 nt..]^T over the 128
// dims, both operands staged tiles with one row per 128-dim vector.
template <int NPairs>
__device__ __forceinline__ void tile_dot(float f[][4], uint32_t ta, int r0, uint32_t tb, int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2 * NPairs; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, a_addr(ta, r0, kk, lane));
#pragma unroll
    for (int np = 0; np < NPairs; ++np) {
      uint32_t b[4];
      ldsm(b, bt_addr(tb, n0 + 16 * np, kk, lane));
      mma(f[2 * np], a, b[0], b[1]);
      mma(f[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 n-tiles of the 128 dims] += A (one k-step of 16) . T[k0..k0+15][:],
// T a staged tile with rows along k; with `lo`, A = hi + lo.
__device__ __forceinline__ void acc_rows(float acc[16][4], const uint32_t hi[4], const uint32_t* lo, uint32_t tile,
                                         int k0, int lane) {
#pragma unroll
  for (int np = 0; np < kD / 16; ++np) {
    uint32_t b[4];
    ldsm_t(b, bn_addr(tile, k0, np, lane));
    mma(acc[2 * np], hi, b[0], b[1]);
    mma(acc[2 * np + 1], hi, b[2], b[3]);
    if (lo != nullptr) {
      mma(acc[2 * np], lo, b[0], b[1]);
      mma(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// s = s * scale + bias (two roundings, as the plain version) for the warp's
// 16 x kStep score fragments: rows r0 + g (+ 8) of the staged [kOwn][kStep]
// bias tile, columns 8 nt + 2 t (+ 1); -inf for keys j0 + column at or past
// S (the staged bias of query rows past S is 0).
__device__ __forceinline__ void scale_bias(float s[kStep / 8][4], const unsigned char* btile, int r0, int j0, int S,
                                           float scale, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
      const int col = 8 * nt + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(btile + bias_off<kStep, false>(r0 + g + 8 * h, col));
      float& x0 = s[nt][2 * h];
      float& x1 = s[nt][2 * h + 1];
      x0 = j0 + col < S ? __fadd_rn(__fmul_rn(x0, scale), b.x) : -INFINITY;
      x1 = j0 + col + 1 < S ? __fadd_rn(__fmul_rn(x1, scale), b.y) : -INFINITY;
    }
}

// Reductions over the 4 lanes (a quad) that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// True on every lane when every value of the warp's N fragments is 0: a
// product with them as its A operand would add exact zeros to its sums.
template <int N>
__device__ __forceinline__ bool warp_all_zero(const float (*f)[4]) {
  bool z = true;
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) z = z && f[nt][e] == 0.f;
  return __all_sync(0xffffffffu, z);
}

__device__ __forceinline__ void zero(float acc[16][4]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// The warp's 16 x 128 accumulator, times `mul`, to bf16 rows
// row0 + 0..15 of dst (rows at or past S are not written), through rows
// r0..r0+15 of the staged tile at `stage`, which the warp alone reads.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float acc[16][4], unsigned char* stage, int r0,
                                           int row0, int S, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + swz(r, nt) + 4 * t) =
          pack(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 16 * kChunks / 32; ++u) {
    const int c = lane + 32 * u;
    const int r = c / kChunks, ch = c % kChunks;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * kD + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r0 + r, ch));
  }
}

// B1. grid (query tiles, BH).
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ stat_m, float* __restrict__ stat_l,
                 int S, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base_addr = smem_addr(smem);
  const uint32_t sQ = base_addr;
  const uint32_t kStages = kOwnBytes;  // offset of stage 0: K, V, bias
  const int i0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const float* bias_b = bias + static_cast<size_t>(bh / heads) * S * S;
  const int n = (S + kStep - 1) / kStep;

  // iterations 0..n-1: pass 1 over key step `it`; n..2n-1: pass 2 over it - n
  auto fetch = [&](int it, int buf) {
    const int j0 = (it < n ? it : it - n) * kStep;
    const uint32_t st = base_addr + kStages + buf * kStage;
    load_tile<kStep>(st, k + base, j0, S);
    if (it >= n) load_tile<kStep>(st + kStepBytes, v + base, j0, S);
    load_bias<kOwn, kStep, false>(st + 2 * kStepBytes, bias_b, i0, j0, S);
  };
  load_tile<kOwn>(sQ, q + base, i0, S);
  fetch(0, 0);
  cp_async_commit();

  // a warp whose 16 rows all lie at or past S has nothing to store
  const bool live = i0 + r0 < S;
  // rows g, g + 8: max, sum of exp and its reciprocal
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
  float acc[16][4];
  zero(acc);
  for (int it = 0; it < 2 * n; ++it) {
    const int buf = it & 1;
    if (it + 1 < 2 * n) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int j0 = (it < n ? it : it - n) * kStep;
    const uint32_t st = kStages + buf * kStage;
    if (live) {
      float s[kStep / 8][4];
      tile_dot<kStep / 16>(s, sQ, r0, base_addr + st, 0, lane);
      scale_bias(s, smem + st + 2 * kStepBytes, r0, j0, S, scale, g, t);
      if (it < n) {
        // the row max and sum of exp; key step 0 holds key 0 < S, so the
        // max is finite from the first step on
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kStep / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
          const float m_new = fmaxf(m[h], quad_max(mx));
          float e = 0.f;
#pragma unroll
          for (int nt = 0; nt < kStep / 8; ++nt) e += __expf(s[nt][2 * h] - m_new) + __expf(s[nt][2 * h + 1] - m_new);
          l[h] = l[h] * __expf(m[h] - m_new) + quad_sum(e);
          m[h] = m_new;
          rl[h] = __frcp_rn(l[h]);
        }
      } else {
        // P = exp(S - m) / l, rounded to bf16, and O += P V unless P is 0
#pragma unroll
        for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * rl[e >> 1];
        if (!warp_all_zero<kStep / 8>(s)) {
#pragma unroll
          for (int j = 0; j < kStep / 16; ++j) {
            uint32_t a[4];
            frag_a(a, s, j);
            acc_rows(acc, a, nullptr, base_addr + st + kStepBytes, 16 * j, lane);
          }
        }
      }
    }
    __syncthreads();
  }
  store_rows(o + base, acc, smem, r0, i0 + r0, S, 1.f, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + r0 + g + 8 * h;
      if (i < S) {
        stat_m[static_cast<size_t>(bh) * S + i] = m[h];
        stat_l[static_cast<size_t>(bh) * S + i] = l[h];
      }
    }
  }
}

// B2, rows. grid (query tiles, BH): dvec and dQ.
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stat_m,
                      const float* __restrict__ stat_l, float* __restrict__ dvec,
                      __nv_bfloat16* __restrict__ dq, int S, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base_addr = smem_addr(smem);
  const uint32_t sQ = base_addr;
  const uint32_t sdO = sQ + kOwnBytes;
  const uint32_t kStages = 2 * kOwnBytes;  // offset of stage 0: K, V, bias
  const int i0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const float* bias_b = bias + static_cast<size_t>(bh / heads) * S * S;
  const int n = (S + kStep - 1) / kStep;

  // iterations 0..n-1: sweep 1 (rowsum(dP * P)) over key step `it`;
  // n..2n-1: sweep 2 (dS, dQ += dS K) over key step it - n
  auto fetch = [&](int it, int buf) {
    const int j0 = (it < n ? it : it - n) * kStep;
    const uint32_t st = base_addr + kStages + buf * kStage;
    load_tile<kStep>(st, k + base, j0, S);
    load_tile<kStep>(st + kStepBytes, v + base, j0, S);
    load_bias<kOwn, kStep, false>(st + 2 * kStepBytes, bias_b, i0, j0, S);
  };
  load_tile<kOwn>(sQ, q + base, i0, S);
  load_tile<kOwn>(sdO, dout + base, i0, S);
  fetch(0, 0);
  cp_async_commit();

  const bool live = i0 + r0 < S;
  float m[2], rl[2], dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + r0 + g + 8 * h;
    m[h] = i < S ? stat_m[static_cast<size_t>(bh) * S + i] : 0.f;
    rl[h] = i < S ? __frcp_rn(stat_l[static_cast<size_t>(bh) * S + i]) : 1.f;
    dsum[h] = 0.f;
  }
  float acc[16][4];
  zero(acc);
  for (int it = 0; it < 2 * n; ++it) {
    const int buf = it & 1;
    if (it + 1 < 2 * n) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int j0 = (it < n ? it : it - n) * kStep;
    const uint32_t st = kStages + buf * kStage;
    if (live) {
      // P in place of S; a step whose P is all 0 adds nothing to dsum or dQ
      float s[kStep / 8][4];
      tile_dot<kStep / 16>(s, sQ, r0, base_addr + st, 0, lane);
      scale_bias(s, smem + st + 2 * kStepBytes, r0, j0, S, scale, g, t);
#pragma unroll
      for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * rl[e >> 1];
      if (!warp_all_zero<kStep / 8>(s)) {
        float dp[kStep / 8][4];
        tile_dot<kStep / 16>(dp, sdO, r0, base_addr + st + kStepBytes, 0, lane);
        if (it < n) {
#pragma unroll
          for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[nt][e] * s[nt][e];
        } else {
          // dS = P (dP - dsum) in place of dP, then dQ += dS K
#pragma unroll
          for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dsum[e >> 1]);
#pragma unroll
          for (int j = 0; j < kStep / 16; ++j) {
            uint32_t hi[4], lo[4];
            frag_a_split(hi, lo, dp, j);
            acc_rows(acc, hi, lo, base_addr + st, 16 * j, lane);
          }
        }
      }
      if (it == n - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dsum[h] = quad_sum(dsum[h]);
          const int i = i0 + r0 + g + 8 * h;
          if (t == 0 && i < S) dvec[static_cast<size_t>(bh) * S + i] = dsum[h];
        }
      }
    }
    __syncthreads();
  }
  store_rows(dq + base, acc, smem, r0, i0 + r0, S, scale, lane);
}

// B2, columns. grid (key tiles, BH): dK and dV. Reads dvec of every query
// row, so it runs after the rows kernel on the same stream.
__global__ void __launch_bounds__(kThreads)
flash_bwd_cols_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stat_m,
                      const float* __restrict__ stat_l, const float* __restrict__ dvec,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int heads,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base_addr = smem_addr(smem);
  const uint32_t sK = base_addr;
  const uint32_t sV = sK + kOwnBytes;
  const uint32_t kStages = 2 * kOwnBytes;  // offset of stage 0: Q, dO, bias, m, l, dvec
  const int j0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const size_t row_base = static_cast<size_t>(bh) * S;
  const float* bias_b = bias + static_cast<size_t>(bh / heads) * S * S;
  const int n = (S + kStep - 1) / kStep;

  auto fetch = [&](int qt, int buf) {
    const int i0 = qt * kStep;
    const uint32_t st = base_addr + kStages + buf * kColStage;
    load_tile<kStep>(st, q + base, i0, S);
    load_tile<kStep>(st + kStepBytes, dout + base, i0, S);
    load_bias<kStep, kOwn, true>(st + 2 * kStepBytes, bias_b, i0, j0, S);
    load_vec(st + kStage, stat_m + row_base, i0, S);
    load_vec(st + kStage + kVecBytes, stat_l + row_base, i0, S);
    load_vec(st + kStage + 2 * kVecBytes, dvec + row_base, i0, S);
  };
  load_tile<kOwn>(sK, k + base, j0, S);
  load_tile<kOwn>(sV, v + base, j0, S);
  fetch(0, 0);
  cp_async_commit();

  const bool live = j0 + r0 < S;
  float acc_dk[16][4], acc_dv[16][4];
  zero(acc_dk);
  zero(acc_dv);
  for (int qt = 0; qt < n; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n) fetch(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int i0 = qt * kStep;
    const uint32_t st = kStages + buf * kColStage;
    const uint32_t tQ = base_addr + st, tdO = tQ + kStepBytes;
    const unsigned char* btile = smem + st + 2 * kStepBytes;
    const float* vm = reinterpret_cast<const float*>(smem + st + kStage);
    const float* vl = vm + kStep;
    const float* vd = vl + kStep;
    // 16 queries at a time: S^T and dP^T fragments with rows keys
    // j0 + r0 + g (+ 8) and columns queries i0 + 16 c + 8 nt + 2 t (+ 1)
    // (P^T in place of S^T; a chunk whose P^T is all 0 adds nothing)
#pragma unroll 1
    for (int c = 0; c < kStep / 16 && live; ++c) {
      float sc[2][4];
      tile_dot<1>(sc, sK, r0, tQ, 16 * c, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 16 * c + 8 * nt + 2 * t + (e & 1);
          const int jl = r0 + g + 8 * (e >> 1);
          float p = 0.f;
          if (i0 + il < S && j0 + jl < S) {
            const float b = *reinterpret_cast<const float*>(btile + bias_off<kOwn, true>(il, jl));
            p = __expf(__fadd_rn(__fmul_rn(sc[nt][e], scale), b) - vm[il]) * __frcp_rn(vl[il]);
          }
          sc[nt][e] = p;
        }
      if (warp_all_zero<2>(sc)) continue;
      float dpt[2][4];
      tile_dot<1>(dpt, sV, r0, tdO, 16 * c, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[nt][e] = sc[nt][e] * (dpt[nt][e] - vd[16 * c + 8 * nt + 2 * t + (e & 1)]);
      uint32_t hi[4], lo[4];
      frag_a_split(hi, lo, sc, 0);
      acc_rows(acc_dv, hi, lo, tdO, 16 * c, lane);
      frag_a_split(hi, lo, dpt, 0);
      acc_rows(acc_dk, hi, lo, tQ, 16 * c, lane);
    }
    __syncthreads();
  }
  store_rows(dk + base, acc_dk, smem, r0, j0 + r0, S, scale, lane);
  store_rows(dv + base, acc_dv, smem + kOwnBytes, r0, j0 + r0, S, 1.f, lane);
}

// Raise the kernels' dynamic shared-memory limit once per device, so that
// later launches (e.g. inside a CUDA graph capture) make no such call.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kFwdSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kRowSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kColSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

// B1 on `stream`; returns the first CUDA error of the set-up or the launch
// (0 = launched). Shapes, types and alignment are checked by the caller.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                                        void* stat_m, void* stat_l, int bh, int heads, int seq, float scale,
                                        void* stream) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kOwn - 1) / kOwn, bh);
  flash_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(stat_m), static_cast<float*>(stat_l), seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// B2 on `stream`: the rows kernel, then the columns kernel. `dvec` is [bh,
// seq] f32 scratch. Returns as flash_attention_fwd_bf16.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* bias,
                                        const void* dout, const void* stat_m, const void* stat_l, void* dvec,
                                        void* dq, void* dk, void* dv, int bh, int heads, int seq, float scale,
                                        void* stream) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((seq + kOwn - 1) / kOwn, bh);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* mp = static_cast<const float*>(stat_m);
  const auto* lp = static_cast<const float*>(stat_l);
  flash_bwd_rows_kernel<<<grid, kThreads, kRowSmem, s>>>(qp, kp, vp, bp, dop, mp, lp, static_cast<float*>(dvec),
                                                         static_cast<__nv_bfloat16*>(dq), seq, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_cols_kernel<<<grid, kThreads, kColSmem, s>>>(qp, kp, vp, bp, dop, mp, lp, static_cast<const float*>(dvec),
                                                         static_cast<__nv_bfloat16*>(dk),
                                                         static_cast<__nv_bfloat16*>(dv), seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
