// Attention forward (B1) and backward (B2) of the Llama decoder, hand-written
// for Hopper.
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
//   dP = dO V^T,  dS = P * (dP - rowsum(dP * P))   (f32 operands throughout)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO   (outputs bf16)
//
// q, k, v, o, dO, dq, dk, dv: [BH, S, 128] bf16, contiguous.
// bias: [B, S, S] f32, shared by the H heads of a batch row (bh / H).
// stat_m, stat_l: [BH, S] f32, each row's max and sum of exp, written by
// the forward and read by the backward, which then recomputes exactly the
// forward's P. dvec: [BH, S] f32 scratch of the backward, rowsum(dP * P).
//
// The Pallas kernel keeps a whole head's S x S f32 scores in VMEM (330 KB at
// S = 288); Hopper gives a block at most 227 KB of shared memory. Here a
// block owns one 64-row tile and walks the other side's 64-row tiles,
// staged in shared memory as f32:
//   forward, one block per (bh, query tile), two passes over the key tiles:
//     1. the row max and sum of exp (rescaled as the max grows);
//     2. the scores again, the normalised P, rounded to bf16 where the Pallas
//        kernel rounds it, and O += P V in f32 registers.
//   backward, two kernels launched back to back on one stream:
//     rows, one block per (bh, query tile): a first sweep over the key tiles
//       gives rowsum(dP * P) (written to dvec), a second one dQ;
//     columns, one block per (bh, key tile): a sweep over the query tiles
//       gives dK and dV in registers that the block alone owns.
//   No atomics, and every sum is taken in a fixed order.
//
// What bounds it on the card: at the attack step's shapes ([8*32, 288, 128])
// the bytes (q, k, v, o, bias: ~78 MB forward) take ~23 us at 3.35 TB/s and
// the operations (4 S^2 D per head forward, 10 S^2 D backward) ~11 / 28 us at
// the bf16 tensor-core rate, so the byte time bounds both. This first design
// runs every product as f32 FMAs on the CUDA cores (the backward's operands
// are f32 by definition; the forward repeats Q K^T in its second pass), so
// the CUDA cores' f32 rate, not the bytes, limits it. Tensor cores on the
// bf16 operands, one-pass rescaling, and skipping fully masked causal tiles
// are work for later changes.
//
// Thread layout (256 threads, tid = 16 ty + tx): in a 64 x 64 score tile a
// thread owns rows 4 ty + r and columns tx + 16 c (r, c < 4); a row's 16
// owners are one half-warp, so row reductions are xor shuffles. In a
// 64 x 128 output tile it owns rows 4 ty + r and columns 4 tx + e and
// 64 + 4 tx + e (e < 4). Staged rows are padded to 132 floats, so the
// float4 reads of four neighbouring columns' rows fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                      // head dim
constexpr int kTile = 64;                    // rows of a query or key tile
constexpr int kThreads = 256;
constexpr int kStride = kD + 4;              // floats per staged row
constexpr int kPStride = kTile + 4;          // floats per row of a P / dS tile
constexpr int kStage = kTile * kStride;      // floats per staged tile
constexpr int kPTile = kTile * kPStride;     // floats per P / dS tile

constexpr size_t kFwdSmem = (3 * kStage + kPTile) * sizeof(float);
constexpr size_t kRowSmem = (4 * kStage + kPTile) * sizeof(float);
constexpr size_t kColSmem = (4 * kStage + 2 * kPTile) * sizeof(float);

// Rows [r0, r0 + 64) of a [S, 128] bf16 matrix -> f32 [64][kStride]; rows at
// or past S are zero.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, int r0, int S) {
  for (int c = threadIdx.x; c < kTile * (kD / 8); c += kThreads) {
    const int r = c >> 4;
    const int d8 = (c & 15) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = a;
    if (r0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * kD + d8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]);
      const float2 f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]);
      const float2 f3 = __bfloat1622float2(h[3]);
      a = make_float4(f0.x, f0.y, f1.x, f1.y);
      b = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
    float* p = dst + r * kStride + d8;
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
}

// acc[r][c] = sum_d A[4 ty + r][d] * B[tx + 16 c][d], f32, d in order.
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(A + (4 * ty + r) * kStride + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * kStride + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(a[r].x, b[c].x, s);
        s = fmaf(a[r].y, b[c].y, s);
        s = fmaf(a[r].z, b[c].z, s);
        s = fmaf(a[r].w, b[c].w, s);
        acc[r][c] = s;
      }
  }
}

// s = s * scale + bias[i, j] (two roundings, as the plain version), -inf
// for keys at or past S; query rows past S read no bias.
__device__ __forceinline__ void scale_bias(float s[4][4], const float* bias, int i0, int j0, int ty,
                                           int tx, int S, float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= S) {
        s[r][c] = -INFINITY;
      } else {
        const float b = i < S ? bias[static_cast<size_t>(i) * S + j] : 0.f;
        s[r][c] = __fadd_rn(__fmul_rn(s[r][c], scale), b);
      }
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[r][e] (e < 8) += sum_j T[4 ty + r][j] * M[j][cols(e)], j < 64 in order,
// cols(e) = 4 tx + e (e < 4) and 64 + 4 tx + e - 4 (e >= 4).
__device__ __forceinline__ void tile_times_rows(const float* T, const float* M, float acc[4][8], int ty, int tx) {
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 t[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) t[r] = *reinterpret_cast<const float4*>(T + (4 * ty + r) * kPStride + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 m0 = *reinterpret_cast<const float4*>(M + (j + u) * kStride + 4 * tx);
      const float4 m1 = *reinterpret_cast<const float4*>(M + (j + u) * kStride + 64 + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = u == 0 ? t[r].x : u == 1 ? t[r].y : u == 2 ? t[r].z : t[r].w;
        acc[r][0] = fmaf(w, m0.x, acc[r][0]);
        acc[r][1] = fmaf(w, m0.y, acc[r][1]);
        acc[r][2] = fmaf(w, m0.z, acc[r][2]);
        acc[r][3] = fmaf(w, m0.w, acc[r][3]);
        acc[r][4] = fmaf(w, m1.x, acc[r][4]);
        acc[r][5] = fmaf(w, m1.y, acc[r][5]);
        acc[r][6] = fmaf(w, m1.z, acc[r][6]);
        acc[r][7] = fmaf(w, m1.w, acc[r][7]);
      }
    }
  }
}

// Rows 4 ty + r of a [64][128] register tile, times `mul`, to bf16 rows
// r0 + 4 ty + r of dst (rows at or past S are not written).
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float acc[4][8], int r0, int S, int ty,
                                           int tx, float mul) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    if (row >= S) continue;
    __nv_bfloat16* p = dst + static_cast<size_t>(row) * kD;
    __nv_bfloat162 lo0 = __floats2bfloat162_rn(acc[r][0] * mul, acc[r][1] * mul);
    __nv_bfloat162 lo1 = __floats2bfloat162_rn(acc[r][2] * mul, acc[r][3] * mul);
    __nv_bfloat162 hi0 = __floats2bfloat162_rn(acc[r][4] * mul, acc[r][5] * mul);
    __nv_bfloat162 hi1 = __floats2bfloat162_rn(acc[r][6] * mul, acc[r][7] * mul);
    reinterpret_cast<__nv_bfloat162*>(p + 4 * tx)[0] = lo0;
    reinterpret_cast<__nv_bfloat162*>(p + 4 * tx)[1] = lo1;
    reinterpret_cast<__nv_bfloat162*>(p + 64 + 4 * tx)[0] = hi0;
    reinterpret_cast<__nv_bfloat162*>(p + 64 + 4 * tx)[1] = hi1;
  }
}

__device__ __forceinline__ void zero(float acc[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
}

// B1. grid (BH, query tiles).
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ stat_m, float* __restrict__ stat_l,
                 int S, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kStage;
  float* Vs = Ks + kStage;
  float* Ps = Vs + kStage;
  const int bh = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const float* bias_b = bias + static_cast<size_t>(bh / heads) * S * S;
  const int n_tiles = (S + kTile - 1) / kTile;

  stage(Qs, q + base, i0, S);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float s[4][4];

  // pass 1: row max and sum of exp; key tile 0 holds key 0 < S, so the max
  // is finite from the first tile on
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    stage(Ks, k + base, kt * kTile, S);
    __syncthreads();
    dot_tile(Qs, Ks, s, ty, tx);
    scale_bias(s, bias_b, i0, kt * kTile, ty, tx, S, scale);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float mx = half_warp_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m[r], mx);
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) e += expf(s[r][c] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + half_warp_sum(e);
      m[r] = m_new;
    }
  }

  // pass 2: P = exp(S - m) / l, rounded to bf16, and O += P V
  float acc[4][8];
  zero(acc);
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    stage(Ks, k + base, kt * kTile, S);
    stage(Vs, v + base, kt * kTile, S);
    __syncthreads();
    dot_tile(Qs, Ks, s, ty, tx);
    scale_bias(s, bias_b, i0, kt * kTile, ty, tx, S, scale);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m[r]) / l[r];
        Ps[(4 * ty + r) * kPStride + tx + 16 * c] = __bfloat162float(__float2bfloat16_rn(p));
      }
    __syncthreads();
    tile_times_rows(Ps, Vs, acc, ty, tx);
  }
  store_rows(o + base, acc, i0, S, ty, tx, 1.f);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      if (i < S) {
        stat_m[static_cast<size_t>(bh) * S + i] = m[r];
        stat_l[static_cast<size_t>(bh) * S + i] = l[r];
      }
    }
  }
}

// B2, rows. grid (BH, query tiles): dvec and dQ.
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stat_m,
                      const float* __restrict__ stat_l, float* __restrict__ dvec,
                      __nv_bfloat16* __restrict__ dq, int S, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kStage;
  float* Ks = dOs + kStage;
  float* Vs = Ks + kStage;
  float* dSs = Vs + kStage;
  const int bh = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const float* bias_b = bias + static_cast<size_t>(bh / heads) * S * S;
  const int n_tiles = (S + kTile - 1) / kTile;

  stage(Qs, q + base, i0, S);
  stage(dOs, dout + base, i0, S);
  float m[4], l[4], dsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    m[r] = i < S ? stat_m[static_cast<size_t>(bh) * S + i] : 0.f;
    l[r] = i < S ? stat_l[static_cast<size_t>(bh) * S + i] : 1.f;
    dsum[r] = 0.f;
  }
  float s[4][4], dp[4][4];

  // sweep 1: rowsum(dP * P)
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    stage(Ks, k + base, kt * kTile, S);
    stage(Vs, v + base, kt * kTile, S);
    __syncthreads();
    dot_tile(Qs, Ks, s, ty, tx);
    scale_bias(s, bias_b, i0, kt * kTile, ty, tx, S, scale);
    dot_tile(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dsum[r] += dp[r][c] * (expf(s[r][c] - m[r]) / l[r]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) dsum[r] = half_warp_sum(dsum[r]);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      if (i < S) dvec[static_cast<size_t>(bh) * S + i] = dsum[r];
    }
  }

  // sweep 2: dS = P (dP - dsum), dQ += dS K
  float acc[4][8];
  zero(acc);
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    stage(Ks, k + base, kt * kTile, S);
    stage(Vs, v + base, kt * kTile, S);
    __syncthreads();
    dot_tile(Qs, Ks, s, ty, tx);
    scale_bias(s, bias_b, i0, kt * kTile, ty, tx, S, scale);
    dot_tile(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m[r]) / l[r];
        dSs[(4 * ty + r) * kPStride + tx + 16 * c] = p * (dp[r][c] - dsum[r]);
      }
    __syncthreads();
    tile_times_rows(dSs, Ks, acc, ty, tx);
  }
  store_rows(dq + base, acc, i0, S, ty, tx, scale);
}

// B2, columns. grid (BH, key tiles): dK and dV. Reads dvec of every query
// row, so it runs after the rows kernel on the same stream.
__global__ void __launch_bounds__(kThreads)
flash_bwd_cols_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stat_m,
                      const float* __restrict__ stat_l, const float* __restrict__ dvec,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int heads,
                      float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kStage;
  float* Qs = Vs + kStage;
  float* dOs = Qs + kStage;
  float* Ps = dOs + kStage;
  float* dSs = Ps + kPTile;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const size_t row_base = static_cast<size_t>(bh) * S;
  const float* bias_b = bias + static_cast<size_t>(bh / heads) * S * S;
  const int n_tiles = (S + kTile - 1) / kTile;

  stage(Ks, k + base, j0, S);
  stage(Vs, v + base, j0, S);
  float acc_dk[4][8], acc_dv[4][8];
  zero(acc_dk);
  zero(acc_dv);
  float s[4][4], dp[4][4];

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int i0 = qt * kTile;
    __syncthreads();
    stage(Qs, q + base, i0, S);
    stage(dOs, dout + base, i0, S);
    __syncthreads();
    // score rows are queries i = i0 + 4 ty + r, columns keys j = j0 + tx + 16 c
    dot_tile(Qs, Ks, s, ty, tx);
    scale_bias(s, bias_b, i0, j0, ty, tx, S, scale);
    dot_tile(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      const bool valid = i < S;
      const float mi = valid ? stat_m[row_base + i] : 0.f;
      const float li = valid ? stat_l[row_base + i] : 1.f;
      const float di = valid ? dvec[row_base + i] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid ? expf(s[r][c] - mi) / li : 0.f;
        Ps[(4 * ty + r) * kPStride + tx + 16 * c] = p;
        dSs[(4 * ty + r) * kPStride + tx + 16 * c] = p * (dp[r][c] - di);
      }
    }
    __syncthreads();
    // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]   (j = j0 + 4 ty + r)
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + i * kPStride + 4 * ty);
      const float4 sv = *reinterpret_cast<const float4*>(dSs + i * kPStride + 4 * ty);
      const float4 o0 = *reinterpret_cast<const float4*>(dOs + i * kStride + 4 * tx);
      const float4 o1 = *reinterpret_cast<const float4*>(dOs + i * kStride + 64 + 4 * tx);
      const float4 q0 = *reinterpret_cast<const float4*>(Qs + i * kStride + 4 * tx);
      const float4 q1 = *reinterpret_cast<const float4*>(Qs + i * kStride + 64 + 4 * tx);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc_dv[r][0] = fmaf(pr[r], o0.x, acc_dv[r][0]);
        acc_dv[r][1] = fmaf(pr[r], o0.y, acc_dv[r][1]);
        acc_dv[r][2] = fmaf(pr[r], o0.z, acc_dv[r][2]);
        acc_dv[r][3] = fmaf(pr[r], o0.w, acc_dv[r][3]);
        acc_dv[r][4] = fmaf(pr[r], o1.x, acc_dv[r][4]);
        acc_dv[r][5] = fmaf(pr[r], o1.y, acc_dv[r][5]);
        acc_dv[r][6] = fmaf(pr[r], o1.z, acc_dv[r][6]);
        acc_dv[r][7] = fmaf(pr[r], o1.w, acc_dv[r][7]);
        acc_dk[r][0] = fmaf(sr[r], q0.x, acc_dk[r][0]);
        acc_dk[r][1] = fmaf(sr[r], q0.y, acc_dk[r][1]);
        acc_dk[r][2] = fmaf(sr[r], q0.z, acc_dk[r][2]);
        acc_dk[r][3] = fmaf(sr[r], q0.w, acc_dk[r][3]);
        acc_dk[r][4] = fmaf(sr[r], q1.x, acc_dk[r][4]);
        acc_dk[r][5] = fmaf(sr[r], q1.y, acc_dk[r][5]);
        acc_dk[r][6] = fmaf(sr[r], q1.z, acc_dk[r][6]);
        acc_dk[r][7] = fmaf(sr[r], q1.w, acc_dk[r][7]);
      }
    }
  }
  store_rows(dk + base, acc_dk, j0, S, ty, tx, scale);
  store_rows(dv + base, acc_dv, j0, S, ty, tx, 1.f);
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
  const dim3 grid(bh, (seq + kTile - 1) / kTile);
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
  const dim3 grid(bh, (seq + kTile - 1) / kTile);
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
