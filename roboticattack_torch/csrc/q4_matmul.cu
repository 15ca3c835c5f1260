// Fused int4 dequant-matmul for the decode tail, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of roboticattack_tpu/ops/q4_matmul.py
// (q4_matmul, kernel bodies _kernel_grouped and _kernel_dense):
//
//   out[m, o] = sum_g scale[o, g] * sum_{j in g} (y[m, 2j] * lo[o, j] + y[m, 2j+1] * hi[o, j])
//
// y    [m, in]      bf16 activations (m = batch x decode positions, small)
// w    [out, in/2]  int8, two signed 4-bit weights per byte along the
//                   contraction: low nibble = channel 2j, high = 2j+1
// scale[out, G]     f32, one per (output channel, group of in/G channels)
// out  [m, out]     bf16
//
// Modes (both launched through roboticattack_torch/ops/q4_matmul.py):
//   grouped (B4, _kernel_grouped, roboticattack_tpu/ops/q4_matmul.py:70): the
//     raw s4 integers are contracted in f32; each group's f32 partial is
//     multiplied by its scale after the group's contraction.
//   dense (B5, _kernel_dense): each weight is dequantized (nibble * scale),
//     rounded to bf16, then contracted with f32 accumulation.
//
// What bounds it: at decode batch sizes this is a matrix-vector product that
// streams the packed weights once: out*in/2 bytes plus out*G*4 bytes of
// scales (8.4 MB for a 4096x4096 projection, 22.6 MB for 11008x4096), against
// the card's memory bandwidth (3.35 TB/s on an H100 SXM). The operations
// (2*m*out*in) are far below the tensor-core peak.
//
// Two bodies, chosen by the host wrapper from the shape before the launch:
//
// 1. q4_matmul_mma_kernel<kDense> (entries q4_matmul_grouped_mma_bf16 and
//    q4_matmul_dense_mma_bf16): grouped mode with a group size that is a
//    multiple of 128 channels (the 7B's 128), and dense mode with any group
//    the wrapper takes (32 * 2^k channels). The products run on the bf16
//    tensor cores (mma.sync m16n8k16, f32 accumulation). bf16(y) x s4, and
//    bf16(y) x bf16(s4 * scale), are exact in f32, so only the order of the
//    f32 sums differs from the plain version.
//    - Operands: a weight row tile is A (M = 16 output channels, K = the
//      contraction), the activations are B (N = 8 activation rows; rows past
//      m are zero), C is [16 channels x 8 rows] in f32. A block owns kMTiles
//      = 2 row tiles (32 channels), so each activation fragment feeds 2 mma's;
//      in dense mode kDenseMTiles = 1 (16 channels): the dequant's registers
//      leave no room for the second, and one measured faster.
//    - The K permutation: a sum over K does not depend on the order of K, so
//      one permutation applied to A and B alike changes nothing. In the
//      fragment layout of m16n8k16 (lane = 4g + t) a register of A holds the
//      k-pair (2t, 2t+1) or (2t+8, 2t+9) of row g or g+8, and a register of B
//      the same k-pair of column g. For k-block b (128 channels = 64 packed
//      bytes a row) lane (g, t) takes bytes [64b + 16t, +16) of rows g and
//      g+8 and activations y[g, 128b + 32t .. +31]: 32 channels. In mma s
//      (q = s/2, e = s&1) k = 2t + 8*half + nib is channel
//      128b + 32t + 8q + 2e + half + 4*nib: word q of each piece holds
//      channels 8q..8q+7 in its nibbles 0..7, and one lop3 takes the nibble
//      pair (j, j+4), j = 2e + half, into one A register; a prmt pairs the
//      activations (j, j+4) alike for B. Each channel of the k-block is
//      visited once.
//    - Unpacking in registers: with u the nibble, ((w >> 4j) & 0x000F000F)
//      ^ 0x43084308 is the bf16 pair 0x4300 | (u ^ 8) = 128 + (u ^ 8); one
//      bf16x2 subtraction of 136 leaves the signed nibble, exactly.
//    - Groups (grouped mode): a k-block's 8 mma's run into a zeroed f32 C
//      fragment, which is scaled and added to the accumulator at the group's
//      last k-block (the Pallas order: the group's f32 partial, then its
//      scale). An mma mixes channels from across its whole k-block, so a
//      group is whole k-blocks: grouped mode takes group sizes of 128 * 2^k.
//    - Dense mode scales each weight before the contraction, so no partial
//      has to belong to one group and the 8 mma's run straight into the
//      accumulator. Each A register's nibble pair (signed, exact in bf16) is
//      widened to two f32 (a bf16 in the high half of a word is that f32),
//      multiplied by the lane's f32 group scale and packed with one
//      cvt.rn.bf16x2.f32: bf16(f32(n) * s), the plain version's bits. A
//      lane's 32 channels of a k-block lie in one group for any group of
//      32 * 2^k channels, so its scale is scale[o, (128b + 32t) / G]: a stage
//      holds 1, 2 or 4 scales a row a k-block (groups of >= 128, 64, 32).
//      The contraction need not be a multiple of 128: lanes past its end
//      read zero activations and zero-filled weights. These 5 instructions
//      an A register (B4's unpacking takes 3) are what dense mode adds to
//      B4's time: the loads are the same.
//    - Streaming the weights: each warp owns a ring of kStages = 2 stages in
//      shared memory; a stage is 2 k-blocks of the block's 32 rows (128
//      contiguous bytes a row, 4 KB; dense: 16 rows, 2 KB) plus their
//      scales, copied with cp.async (L1 bypassed) so that 8 lanes fetch one
//      whole 128-byte line; a 16-byte shared load then hands each lane its
//      piece (odd rows swap their halves, so the reads are free of bank
//      conflicts). The next stage is in
//      flight while a stage is computed: 4 KB a warp, 64 KB an SM at 16
//      warps, above the ~20 KB that 3.35 TB/s at under a microsecond of
//      latency asks. Deeper rings measured slower: they take L1 from the
//      activations, which every block reads.
//    - Filling the card: grid.x covers the output channels 32 (dense: 16)
//      at a time, grid.y the activation rows 8 at a time; a block splits K
//      among its
//      warps in units of whole groups in grouped mode, of one stage in dense
//      mode (up to 8 warps, as many as keep the grid at <= 16 warps an SM,
//      so one wave holds it). The warps' f32 partials are summed in shared
//      memory in a fixed order: the result is bit-deterministic.
//
// 2. q4_matmul_kernel (entry q4_matmul_bf16): grouped mode with groups of 32
//    or 64 channels. CUDA-core FMAs, 16-byte weight loads unpacked with
//    integer shifts, the activations staged through shared
//    memory one K tile at a time:
//   - a block is 8 warps; each warp owns 2 output channels; grid.x covers
//     the output channels in blocks of 16 (the ragged edge is masked);
//   - grid.y covers the activation rows in chunks of MT (1, 2, 4 or 8);
//   - a K tile is 1024 channels = 512 packed bytes of a weight row: lane l
//     of a warp loads bytes [16l, 16l+16) of each of its rows (32 channels),
//     so one warp-wide load is 512 contiguous bytes. The next tile's weights
//     are loaded before the current tile is computed;
//   - the tile's activations sit in shared memory as f32 in 32-channel
//     segments padded to 36 floats, so the lanes' float4 reads fall in
//     distinct banks;
//   - a group of G channels spans G/32 neighbouring lanes; their chunk
//     partials are summed with xor shuffles, then scaled once.
//   - a final xor-shuffle reduction over the warp gives each output.
// The host wrapper checks: in % 32 == 0, G/32 lanes per group is a power of
// two <= 32, 16-byte aligned contiguous operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileK = 1024;                 // channels per K tile (32 lanes x 32)
constexpr int kSeg = 32;                     // channels per lane = 16 packed bytes
constexpr int kSegPad = kSeg + 4;            // padded shared-memory segment
constexpr int kTileStride = (kTileK / kSeg) * kSegPad;  // floats per staged row

// The nibble at bits [28 - kShift, 32 - kShift) of a word, sign-extended:
// shift it to the top, then shift back arithmetically.
template <int kShift>
__device__ __forceinline__ float nib(uint32_t word) {
  return static_cast<float>(static_cast<int32_t>(word << kShift) >> 28);
}

template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
q4_matmul_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 int m, int in_dim, int out_dim, int groups) {
  __shared__ __align__(16) float ys[MT * kTileStride];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * MT;
  const int o0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  const int in_half = in_dim >> 1;
  const int gsz2 = in_half / groups;          // packed bytes per group
  const int lanes_per_group = gsz2 >> 4;      // 16 packed bytes per lane
  const int n_tiles = (in_dim + kTileK - 1) / kTileK;

  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < MT; ++t) acc[r][t] = 0.f;

  uint4 wcur[kRowsPerWarp];
  auto load_w = [&](int tile, uint4* dst) {
    const int byte = tile * (kTileK / 2) + lane * 16;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int o = o0 + r;
      if (o < out_dim && byte < in_half) {
        dst[r] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(o) * in_half + byte));
      } else {
        dst[r] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load_w(0, wcur);

  for (int tile = 0; tile < n_tiles; ++tile) {
    uint4 wnext[kRowsPerWarp];
    if (tile + 1 < n_tiles) load_w(tile + 1, wnext);

    // Stage MT rows x kTileK channels of y as f32. in_dim % 32 == 0, so an
    // 8-channel run is wholly inside or wholly outside the row.
    const int k0 = tile * kTileK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < MT * (kTileK / 8); idx += blockDim.x) {
      const int r = idx / (kTileK / 8);
      const int c8 = (idx % (kTileK / 8)) * 8;
      const int row = row0 + r;
      const int ch = k0 + c8;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = a;
      if (row < m && ch < in_dim) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(y + static_cast<size_t>(row) * in_dim + ch));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 f0 = __bfloat1622float2(h[0]);
        const float2 f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]);
        const float2 f3 = __bfloat1622float2(h[3]);
        a = make_float4(f0.x, f0.y, f1.x, f1.y);
        b = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
      float* dst = ys + r * kTileStride + (c8 / kSeg) * kSegPad + (c8 % kSeg);
      reinterpret_cast<float4*>(dst)[0] = a;
      reinterpret_cast<float4*>(dst)[1] = b;
    }
    __syncthreads();

    const int byte = k0 / 2 + lane * 16;
    const bool active = byte < in_half;
    const int g = active ? byte / gsz2 : 0;
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int o = o0 + r;
      sc[r] = (active && o < out_dim) ? __ldg(scale + static_cast<size_t>(o) * groups + g) : 0.f;
    }

    float part[kRowsPerWarp][MT];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int t = 0; t < MT; ++t) part[r][t] = 0.f;

    const float* yl = ys + lane * kSegPad;
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // 4 channels (2 packed bytes) per step
      float4 yv[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) yv[t] = reinterpret_cast<const float4*>(yl + t * kTileStride)[q];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(&wcur[r]);
        const uint32_t word = words[q >> 1];
        // channels 4q..4q+3 = lo(byte 2q), hi(byte 2q), lo(byte 2q+1), hi(byte 2q+1)
        float w0, w1, w2, w3;
        if (q & 1) {
          w0 = nib<12>(word); w1 = nib<8>(word); w2 = nib<4>(word); w3 = nib<0>(word);
        } else {
          w0 = nib<28>(word); w1 = nib<24>(word); w2 = nib<20>(word); w3 = nib<16>(word);
        }
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          float s = part[r][t];
          s = fmaf(yv[t].x, w0, s);
          s = fmaf(yv[t].y, w1, s);
          s = fmaf(yv[t].z, w2, s);
          s = fmaf(yv[t].w, w3, s);
          part[r][t] = s;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        // the group's f32 partial, then its scale
        float p = part[r][t];
        for (int off = 1; off < lanes_per_group; off <<= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if ((lane & (lanes_per_group - 1)) == 0) acc[r][t] = fmaf(p, sc[r], acc[r][t]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) wcur[r] = wnext[r];
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      float v = acc[r][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int o = o0 + r;
      const int row = row0 + t;
      if (lane == 0 && o < out_dim && row < m) {
        out[static_cast<size_t>(row) * out_dim + o] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <int MT>
void launch(const void* y, const void* w, const void* scale, void* out, int m, int in_dim,
            int out_dim, int groups, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const dim3 grid((out_dim + kRowsPerBlock - 1) / kRowsPerBlock, (m + MT - 1) / MT);
  q4_matmul_kernel<MT><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), m, in_dim, out_dim, groups);
}

// ---------------------------------------------------------------------------
// Body 1: the tensor cores (grouped mode with groups of 128 * 2^k channels,
// dense mode with groups of 32 * 2^k).

constexpr int kMmaMaxWarps = 8;
constexpr int kMmaWarpsPerSm = 16;  // the grid's warps are kept within one wave of this
constexpr int kBlockK = 128;        // channels per k-block: 8 mma's of K = 16
constexpr int kStages = 2;          // a warp's ring of stages; kStages - 1 in flight
constexpr int kMTiles = 2;          // grouped mode: 16-channel row tiles a warp (and a block) owns
constexpr int kDenseMTiles = 1;     // dense mode (its dequant takes the registers of the second)
constexpr int kStageRowBytes = 128; // a stage is 2 k-blocks: 128 packed bytes of each of the block's rows
constexpr int kMaxSpkLog2 = 2;      // dense mode, groups of 32: 4 scales a row a k-block

__host__ __device__ constexpr int mma_m_tiles(bool dense) { return dense ? kDenseMTiles : kMTiles; }

// A stage's bytes: the weights of the block's 16 * m_tiles rows, then the
// scales of its 2 k-blocks, 1 << spk_log2 a row a k-block ([rows][2][1 <<
// spk_log2] f32).
__host__ __device__ constexpr int mma_stage_bytes(int m_tiles, int spk_log2) {
  return 16 * m_tiles * kStageRowBytes + ((16 * m_tiles * 2 * 4) << spk_log2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, bypassing registers; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most kPending of this thread's groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Nibbles j and j+4 of the word w (j = kShift / 4) as a bf16x2 pair of
// signed integers, nibble j in the low half. With u the nibble, the bits
// (u & 0xF) ^ 0x4308 are the bf16 0x4300 | (u ^ 8) = 128 + (u ^ 8) (one lop3
// with both masks); subtracting 136 leaves (u ^ 8) - 8, the signed nibble.
template <int kShift>
__device__ __forceinline__ uint32_t s4_pair(uint32_t w) {
  const uint32_t k136 = 0x43084308u;
  uint32_t v;  // (w >> kShift) & 0x000F000F ^ k136: lut (a & b) ^ c = 0x6a
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(w >> kShift), "r"(0x000F000Fu), "r"(k136));
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The B registers of one k-block from the lane's 32 activations of row g
// (yv): mma s takes word q = s/2 of yv (8 channels) and e = s&1 picks the
// pairs (2e, 2e+4) for k (2t, 2t+1) and (2e+1, 2e+5) for k (2t+8, 2t+9).
__device__ __forceinline__ void kblock_b(uint32_t b[8][2], const uint4* yv) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    b[2 * q][0] = __byte_perm(yv[q].x, yv[q].z, 0x5410);
    b[2 * q][1] = __byte_perm(yv[q].x, yv[q].z, 0x7632);
    b[2 * q + 1][0] = __byte_perm(yv[q].y, yv[q].w, 0x5410);
    b[2 * q + 1][1] = __byte_perm(yv[q].y, yv[q].w, 0x7632);
  }
}

// An A register: the signed nibbles j, j+4 of w (j = kShift / 4) as a bf16
// pair; in dense mode each one dequantized, bf16(f32(n) * s): the pair
// widened to two f32 (the bf16 in the high half of a word is that f32), one
// f32 multiply each, one cvt.rn.bf16x2.f32 (nearest-even) for both.
template <int kShift, bool kDense>
__device__ __forceinline__ uint32_t a_pair(uint32_t w, float s) {
  const uint32_t p = s4_pair<kShift>(w);
  if constexpr (!kDense) {
    return p;
  } else {
    const __nv_bfloat162 r = __floats2bfloat162_rn(__uint_as_float(p << 16) * s,
                                                   __uint_as_float(p & 0xFFFF0000u) * s);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

// One k-block: the 8 mma's over the lane's weight pieces of rows g (wa) and
// g+8 (wb), into c. mma s takes word q = s/2 of each piece, paired as the
// activations: its A registers are nibbles (2e, 2e+4) and (2e+1, 2e+5).
// Dense mode dequantizes rows g and g+8 with the scales sa and sb.
template <bool kDense = false>
__device__ __forceinline__ void kblock_mma(float c[4], const uint4& wa, const uint4& wb, const uint32_t b[8][2],
                                           float sa = 0.f, float sb = 0.f) {
  const uint32_t xa[4] = {wa.x, wa.y, wa.z, wa.w};
  const uint32_t xb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t a[4];
    a[0] = a_pair<0, kDense>(xa[q], sa);
    a[1] = a_pair<0, kDense>(xb[q], sb);
    a[2] = a_pair<4, kDense>(xa[q], sa);
    a[3] = a_pair<4, kDense>(xb[q], sb);
    mma_bf16(c, a, b[2 * q][0], b[2 * q][1]);
    a[0] = a_pair<8, kDense>(xa[q], sa);
    a[1] = a_pair<8, kDense>(xb[q], sb);
    a[2] = a_pair<12, kDense>(xa[q], sa);
    a[3] = a_pair<12, kDense>(xb[q], sb);
    mma_bf16(c, a, b[2 * q + 1][0], b[2 * q + 1][1]);
  }
}

// The warps of a block split K into units of k-blocks, so a warp's run starts
// a stage (2 k-blocks) and, in grouped mode, a group.
__host__ __device__ __forceinline__ int mma_unit(bool dense, int kpg_log2) {
  return !dense && kpg_log2 > 0 ? 1 << kpg_log2 : 2;
}

// Where 16-byte chunk c (0..7) of row r sits in a stage: odd rows swap the
// halves, so the 8 lanes of a quarter warp (rows g, g+1; chunks t or 4+t)
// read 8 distinct 16-byte bank groups.
__device__ __forceinline__ int chunk_off(int r, int c) {
  return r * kStageRowBytes + ((c ^ ((r & 1) << 2)) << 4);
}

// kpg_log2: log2 of the k-blocks a group spans (0 for groups of <= 128
// channels); kSpkLog2: log2 of the scales a row a k-block (dense mode only:
// 1 for groups of 64, 2 for 32).
template <bool kDense, int kSpkLog2>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, kMmaWarpsPerSm / kMmaMaxWarps)
q4_matmul_mma_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                     int m, int in_dim, int out_dim, int groups, int kpg_log2) {
  constexpr int kMT = mma_m_tiles(kDense);  // row tiles
  constexpr int kRows = 16 * kMT;           // output channels a block owns
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kMmaMaxWarps][4 * kMT][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * kRows;
  const int row0 = blockIdx.y * 8;
  const int in_half = in_dim >> 1;
  const int nkb = (in_dim + kBlockK - 1) / kBlockK;  // dense mode: the last may be partial
  const int kpg_mask = (1 << kpg_log2) - 1;
  constexpr int stage_bytes = mma_stage_bytes(kMT, kSpkLog2);

  // this warp's stages: whole units, so none straddles two warps
  const int unit = mma_unit(kDense, kpg_log2);
  const int units = (nkb + unit - 1) / unit;
  const int spu = unit >> 1;  // stages per unit
  const int u_begin = units * warp / warps;
  const int st_begin = u_begin * spu;
  const int n_st = (units * (warp + 1) / warps - u_begin) * spu;

  unsigned char* ring = smem + warp * kStages * stage_bytes;
  const uint32_t ring_u32 = smem_u32(ring);

  // A stage: rows o0..o0+kRows-1, k-blocks 2st, 2st+1. Copy i covers rows
  // 4i..4i+3 with 8 lanes a row, 128 contiguous bytes each (whole lines):
  // lane chunk c = lane & 7 is bytes 128st + 16c of its row.
  const int8_t* wsrc[kRows / 4];
  uint32_t wdst[kRows / 4];
  bool wok[kRows / 4];
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const int r = (lane >> 3) + 4 * i;
    wok[i] = o0 + r < out_dim;
    wsrc[i] = w + static_cast<size_t>(wok[i] ? o0 + r : 0) * in_half + 16 * (lane & 7);
    wdst[i] = chunk_off(r, lane & 7);
  }
  // The scales of the stage's 2 k-blocks: [kRows rows][2][1 << kSpkLog2]
  // f32, entry j of a row being its group ((2st << kSpkLog2) + j) >>
  // kpg_log2. Copy i takes 32 consecutive entries: rows (16 >> kSpkLog2) * i
  // + (lane >> (kSpkLog2 + 1)), entry j = lane & ((2 << kSpkLog2) - 1).
  const int srow = o0 + (lane >> (kSpkLog2 + 1));
  const int sj = lane & ((2 << kSpkLog2) - 1);
  auto issue = [&](int st, int buf) {
    const uint32_t dst = ring_u32 + buf * stage_bytes;
    const bool kok = kStageRowBytes * st + 16 * (lane & 7) < in_half;
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const bool valid = wok[i] && kok;
      cp_async16(dst + wdst[i], valid ? wsrc[i] + st * kStageRowBytes : w, valid);
    }
    const int grp = ((2 * st << kSpkLog2) + sj) >> kpg_log2;
#pragma unroll
    for (int i = 0; i < (kMT << kSpkLog2); ++i) {
      const int o = srow + (16 >> kSpkLog2) * i;
      const bool valid = o < out_dim && grp < groups;
      cp_async4(dst + kRows * kStageRowBytes + 4 * (32 * i + lane),
                valid ? scale + static_cast<size_t>(o) * groups + grp : scale, valid);
    }
  };

  const int yrow = row0 + g;
  const bool vy = yrow < m;
  const uint4* yp = reinterpret_cast<const uint4*>(y + static_cast<size_t>(vy ? yrow : 0) * in_dim + 32 * t);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_st) issue(st_begin + j, j);
    cp_async_commit();
  }

  float acc[kMT][4] = {};
  float part[kMT][4] = {};
  for (int j = 0; j < n_st; ++j) {
    if (j + kStages - 1 < n_st) issue(st_begin + j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const int st = st_begin + j;
    uint4 yv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        yv[h][q] = (vy && kBlockK * (2 * st + h) + 32 * t < in_dim)
                       ? __ldg(yp + (2 * st + h) * (kBlockK / 8) + q) : zero;
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* stage = ring + (j % kStages) * stage_bytes;
    const float* sc = reinterpret_cast<const float*>(stage + kRows * kStageRowBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kb = 2 * st + h;
      if (h == 0 || kb < nkb) {  // a stage's second k-block is past the end when nkb is odd
        uint32_t b[8][2];
        kblock_b(b, yv[h]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r = 16 * mt + g;
          const uint4 wa = *reinterpret_cast<const uint4*>(stage + chunk_off(r, 4 * h + t));
          const uint4 wb = *reinterpret_cast<const uint4*>(stage + chunk_off(r + 8, 4 * h + t));
          if constexpr (kDense) {
            // the lane's 32 channels lie in one group: entry t >> (2 - kSpkLog2)
            const int e = t >> (kMaxSpkLog2 - kSpkLog2);
            kblock_mma<true>(acc[mt], wa, wb, b, sc[((2 * r + h) << kSpkLog2) + e],
                             sc[((2 * (r + 8) + h) << kSpkLog2) + e]);
          } else {
            kblock_mma(part[mt], wa, wb, b);
            if ((kb & kpg_mask) == kpg_mask) {  // the group's last k-block
              const float sa = sc[2 * r + h], sb = sc[2 * (r + 8) + h];
              acc[mt][0] = fmaf(part[mt][0], sa, acc[mt][0]);
              acc[mt][1] = fmaf(part[mt][1], sa, acc[mt][1]);
              acc[mt][2] = fmaf(part[mt][2], sb, acc[mt][2]);
              acc[mt][3] = fmaf(part[mt][3], sb, acc[mt][3]);
#pragma unroll
              for (int i = 0; i < 4; ++i) part[mt][i] = 0.f;
            }
          }
        }
      }
    }
    __syncwarp();  // the stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  // the warps' partials, summed in warp order
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) red[warp][4 * mt + r][lane] = acc[mt][r];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < 4 * kMT; ++r) {
      float v = red[0][r][lane];
      for (int k = 1; k < warps; ++k) v += red[k][r][lane];
      // c0, c1: channel o0+16mt+g, rows 2t, 2t+1; c2, c3: channel o0+16mt+g+8
      const int o = o0 + 16 * (r >> 2) + g + ((r & 2) ? 8 : 0);
      const int row = row0 + 2 * t + (r & 1);
      if (o < out_dim && row < m) out[static_cast<size_t>(row) * out_dim + o] = __float2bfloat16_rn(v);
    }
  }
}

template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, bool dense, int spk_log2) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMmaMaxWarps * kStages * mma_stage_bytes(mma_m_tiles(dense), spk_log2));
}

// The SM count of the current device, and the mma kernels' dynamic
// shared-memory limits raised, once per device, so that later launches (e.g.
// inside a CUDA graph capture) make no such call.
cudaError_t mma_setup(int* sms) {
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && sm_count[dev] > 0) {
    *sms = sm_count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = smem_limit(q4_matmul_mma_kernel<false, 0>, false, 0);
  if (err == cudaSuccess) err = smem_limit(q4_matmul_mma_kernel<true, 0>, true, 0);
  if (err == cudaSuccess) err = smem_limit(q4_matmul_mma_kernel<true, 1>, true, 1);
  if (err == cudaSuccess) err = smem_limit(q4_matmul_mma_kernel<true, 2>, true, 2);
  if (err == cudaSuccess && dev < kMaxDevices) sm_count[dev] = *sms;
  return err;
}

template <bool kDense>
int launch_mma(const void* y, const void* w, const void* scale, void* out, int m, int in_dim, int out_dim,
               int groups, void* stream) {
  int sms = 0;
  const cudaError_t err = mma_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gs = in_dim / groups;
  int kpg_log2 = 0, spk_log2 = 0;
  while ((kBlockK << kpg_log2) < gs) ++kpg_log2;
  while ((kBlockK >> spk_log2) > gs) ++spk_log2;
  const int rows = 16 * mma_m_tiles(kDense);
  const dim3 grid((out_dim + rows - 1) / rows, (m + 7) / 8);
  const long tiles = static_cast<long>(grid.x) * grid.y;
  const int unit = mma_unit(kDense, kpg_log2);
  const int units = ((in_dim + kBlockK - 1) / kBlockK + unit - 1) / unit;
  int warps = kMmaMaxWarps;
  while (warps > 1 && (warps > units || tiles * warps > static_cast<long>(kMmaWarpsPerSm) * sms)) warps >>= 1;
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = warps * kStages * mma_stage_bytes(mma_m_tiles(kDense), spk_log2);
  if (!kDense) {
    q4_matmul_mma_kernel<false, 0><<<grid, warps * 32, smem, s>>>(yp, wp, sp, op, m, in_dim, out_dim, groups,
                                                                  kpg_log2);
  } else if (spk_log2 == 0) {
    q4_matmul_mma_kernel<true, 0><<<grid, warps * 32, smem, s>>>(yp, wp, sp, op, m, in_dim, out_dim, groups,
                                                                 kpg_log2);
  } else if (spk_log2 == 1) {
    q4_matmul_mma_kernel<true, 1><<<grid, warps * 32, smem, s>>>(yp, wp, sp, op, m, in_dim, out_dim, groups,
                                                                 kpg_log2);
  } else {
    q4_matmul_mma_kernel<true, 2><<<grid, warps * 32, smem, s>>>(yp, wp, sp, op, m, in_dim, out_dim, groups,
                                                                 kpg_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grouped mode on the CUDA cores, for any group of 32 * 2^k channels, k <= 5
// (the wrapper sends it groups of 32 and 64; the tensor-core body takes the
// larger ones). Launch on
// `stream` (a cudaStream_t); returns cudaGetLastError() after the launch (0 =
// launched). Shapes and alignment are checked by the caller.
extern "C" int q4_matmul_bf16(const void* y, const void* w, const void* scale, void* out, int m,
                              int in_dim, int out_dim, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 1) {
    launch<1>(y, w, scale, out, m, in_dim, out_dim, groups, s);
  } else if (m <= 2) {
    launch<2>(y, w, scale, out, m, in_dim, out_dim, groups, s);
  } else if (m <= 4) {
    launch<4>(y, w, scale, out, m, in_dim, out_dim, groups, s);
  } else {
    launch<8>(y, w, scale, out, m, in_dim, out_dim, groups, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Grouped mode on the tensor cores: group size in_dim / groups must be
// 128 * 2^k channels (checked by the caller). Launch on `stream`; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int q4_matmul_grouped_mma_bf16(const void* y, const void* w, const void* scale, void* out, int m,
                                          int in_dim, int out_dim, int groups, void* stream) {
  return launch_mma<false>(y, w, scale, out, m, in_dim, out_dim, groups, stream);
}

// Dense mode on the tensor cores: group size 32 * 2^k channels, k <= 5
// (checked by the caller). Launch on `stream`; returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int q4_matmul_dense_mma_bf16(const void* y, const void* w, const void* scale, void* out, int m,
                                        int in_dim, int out_dim, int groups, void* stream) {
  return launch_mma<true>(y, w, scale, out, m, in_dim, out_dim, groups, stream);
}

extern "C" const char* q4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
