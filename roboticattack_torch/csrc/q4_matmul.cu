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
//     multiplied by its scale after the group's contraction (the Pallas
//     order).
//   dense (B5, _kernel_dense): each weight is dequantized (nibble * scale),
//     rounded to bf16, then contracted with f32 accumulation.
//
// What bounds it: at decode sizes this is a product of a few activation rows
// with a matrix that is streamed once: out*in/2 bytes of packed weights plus
// out*G*4 bytes of scales (8.4 MB for a 4096x4096 projection, 22.6 MB for
// 11008x4096), against the card's memory bandwidth (3.35 TB/s on an H100
// SXM). Even at m = 64 the operations (2*m*out*in) are far below the
// tensor-core peak. At m <= 8 the weight loads take the time; at m = 56 the
// issue of the unpacking, the activation reads and the mma's, and the
// activations' copies into shared memory, take more of it than the weights.
//
// One body, q4_matmul_mma_kernel<kDense, kSpkLog2, kNT> (entries
// q4_matmul_grouped_mma_bf16 and q4_matmul_dense_mma_bf16), for grouped mode
// with every group the wrapper takes (32 * 2^k channels) and every m, and for
// dense mode. The products run on the bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulation). bf16(y) x s4, and bf16(y) x bf16(s4 * scale), are exact
// in f32, so only the order of the f32 sums differs from the plain version.
//   - Operands: a weight row tile is A (M = 16 output channels, K = the
//     contraction), an n-tile of activations is B (N = 8 activation rows),
//     C is [16 channels x 8 rows] in f32.
//   - The K permutation: a sum over K does not depend on the order of K, so
//     one permutation applied to A and B alike changes nothing. In the
//     fragment layout of m16n8k16 (lane = 4g + t) a register of A holds the
//     k-pair (2t, 2t+1) or (2t+8, 2t+9) of row g or g+8, and a register of B
//     the same k-pair of column g. A k-block is 128 channels (64 packed bytes
//     a row, 8 mma's). Lane (g, t) holds 4 words (16 bytes) of rows g and g+8
//     of it; word q holds the channels c..c+7 (c = twice the word's first
//     byte), and mma s = 2q + e takes word q and the 16-byte load of the
//     activations c..c+7 that pairs with it. Where the words come from is the
//     fragment map; it keeps each mma inside one group:
//       groups of >= 128 channels (and dense mode): lane t holds bytes
//         [16t, +16) of the k-block, one 16-byte piece a row; an mma spans
//         the whole k-block, one group;
//       groups of 64: bytes [8t, +8) of the first group and [32 + 8t, +8)
//         of the second, two 8-byte pieces; mma's 0-3 take the first group,
//         4-7 the second;
//       groups of 32: bytes [16p + 4t, +4) of group p = 0..3, four 4-byte
//         pieces (a lane's share of a 32-channel group in a row is 4 bytes:
//         2 mma's of 4 k-values); mma's 2p, 2p+1 take group p.
//     Which nibbles of word q pair with which k is the pairing. At m <= 8
//     (and dense mode) k = 2t + 8*half + nib is channel c + 2e + half +
//     4*nib: one lop3 takes the nibble pair (j, j+4), j = 2e + half, into an
//     A register, and a prmt pairs the activations (j, j+4) alike for B. At m
//     > 8 k is channel c + 4e + 2*half + nib: an A register is the two
//     nibbles of byte 2e + half (one prmt of w and w >> 4, then the lop3),
//     and the B registers are activation words as they are, so the n-tiles
//     take no prmt. Each channel of the k-block is visited once, by A and B
//     in the same slot.
//   - Unpacking in registers: with u the nibble, ((w >> 4j) & 0x000F000F)
//     ^ 0x43084308 is the bf16 pair 0x4300 | (u ^ 8) = 128 + (u ^ 8); one
//     bf16x2 subtraction of 136 leaves the signed nibble, exactly.
//   - Groups (grouped mode): a group's mma's run into a zeroed f32 C
//     fragment, which is scaled and added to the accumulator after the
//     group's last mma: after mma's 3 and 7 (groups of 64), after every
//     second (32), at the end of the group's last k-block (>= 128).
//   - Dense mode scales each weight before the contraction, so no partial
//     has to belong to one group and the mma's run straight into the
//     accumulator. Each A register's nibble pair (signed, exact in bf16) is
//     widened to two f32 (a bf16 in the high half of a word is that f32),
//     multiplied by the lane's f32 group scale and packed with one
//     cvt.rn.bf16x2.f32: bf16(f32(n) * s), the plain version's bits. Dense
//     mode keeps the 16-byte map: a lane's 32 channels of a k-block lie in
//     one group for any group of 32 * 2^k channels, so its scale is
//     scale[o, (128b + 32t) / G].
//   - Scales: a stage holds 1, 2 or 4 scales a row a k-block (groups of >=
//     128, 64, 32: kSpkLog2 = 0, 1, 2). The contraction need not be a
//     multiple of 128 (groups of 32 or 64, dense mode): pieces past its end
//     read zero activations, zero-filled weights and zero scales.
//   - Streaming the weights: each warp owns a ring of 2 stages in shared
//     memory; a stage is 2 k-blocks of the warp's 16 * kMT rows (128
//     contiguous bytes a row) plus their scales, copied with cp.async (L1
//     bypassed) so that 8 lanes fetch one whole 128-byte line. The 16-byte
//     chunk c of row r sits at chunk c ^ f(r) (see chunk_off): the 16-, 8-
//     and 4-byte reads of the three maps are free of bank conflicts. The
//     next stage is in flight while a stage is computed. Deeper rings
//     measured slower at m <= 8 (they take L1 from the activations) and no
//     faster at m > 8 (2 to 6 weight stages).
//   - m <= 8 (kNT = 1, the sequential tail): grid.x covers the output
//     channels 32 at a time (2 row tiles a warp; dense mode 16), grid.y the
//     rows 8 at a time (dense mode at any m); a lane loads its activations
//     (through L1) for both k-blocks of a stage before it waits for the
//     stage; a block's warps split K in units of whole groups (of a stage in
//     dense mode), up to 8 warps, as many as keep the grid within one wave
//     of 16 warps an SM. Their f32 partials are summed in shared memory in
//     warp order.
//   - m > 8 (kNT = 2, 4, 7 or 8 n-tiles; m = 56 is the Jacobi pass at bs 8,
//     7 n-tiles): each A fragment, unpacked once, feeds every n-tile of its
//     row chunk, so a launch reads each weight byte once for m <= 64 (chunks
//     of 64 rows beyond: grid.z). A block's 8 warps (4 where 8 would leave
//     half the SMs without a block) are row groups of 16 channels that share
//     one 2-stage ring of activation stages ([2 k-blocks][8 kNT rows][256
//     bytes], chunks placed by act_pos so the n-tiles' 16-byte reads are
//     free of bank conflicts), copied with cp.async by all warps and
//     published by a block barrier a stage; rows past m are not copied (an
//     mma's column n reaches only output row n, which is not stored). K is
//     split among the blocks of a thread-block cluster (grid.y, up to 8, as
//     many as keep one wave: 2 blocks an SM, 1 from 7 n-tiles on, whose
//     136-208 registers take half the SM's and keep the accumulators out of
//     local memory; each slice >= 4 stages); each block leaves its f32
//     partials in its shared memory and block r of the cluster sums its
//     share over the blocks in rank order through distributed shared
//     memory.
//   The partial sums are taken in a fixed order in both regimes: the result
//   is bit-deterministic.
// Times (scripts/sweep_q4_mma.py on an H100 80GB HBM3 at 700 W, this body
// against the earlier one in the same run; PERF.md has chip_smoke.py's runs):
// one decoder layer's 7 projections of the 7B at groups of 128, 0.0777-0.0781
// ms at m=8 and 0.0740 at m=2 (earlier 0.0758-0.0762 / 0.0724), 0.1808-0.1811
// at m=56 (earlier 0.2785; torch.matmul on pre-dequantized bf16 weights
// 0.165); a tp=4 rank's layer at groups of 64, m=8, 0.0509 ms (chip_smoke.py;
// the CUDA-core body it replaces 0.1055-0.1065).
// The host wrapper checks: in % 32 == 0, a group of 32 * 2^k channels
// (k <= 5), 16-byte aligned contiguous operands.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaMaxWarps = 8;
constexpr int kMmaWarpsPerSm = 16;  // the grid's warps are kept within one wave of this
constexpr int kBlockK = 128;        // channels per k-block: 8 mma's of K = 16
constexpr int kStages = 2;          // a warp's ring of stages (m > 8: and the activations'); kStages - 1 in flight
constexpr int kMTiles = 2;          // grouped mode, m <= 8: 16-channel row tiles a warp owns
constexpr int kWideMTiles = 1;      // grouped mode, m > 8 (the n-tiles' accumulators take the registers)
constexpr int kDenseMTiles = 1;     // dense mode (its dequant takes the registers of the second)
constexpr int kMaxNT = 8;           // up to 8 n-tiles: m <= 64 in one read of the weights
constexpr int kWideWarps = 8;       // m > 8: a block's warps (its row groups); 4 where 8 leave SMs idle
constexpr int kMaxCluster = 8;      // m > 8: K split among up to 8 blocks of a cluster
constexpr int kMinSliceUnits = 4;   // m > 8: each block's slice of K at least 4 units (stages)
constexpr int kStageRowBytes = 128; // a stage is 2 k-blocks: 128 packed bytes of each of the warp's rows
constexpr int kMaxSpkLog2 = 2;      // groups of 32: 4 scales a row a k-block

__host__ __device__ constexpr int mma_m_tiles(bool dense, int nt) {
  return dense ? kDenseMTiles : nt == 1 ? kMTiles : kWideMTiles;
}

// A stage's bytes: the weights of the warp's 16 * m_tiles rows, then the
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

// m > 8: the signed nibbles of byte j of w (j = kByte) as a bf16 pair, the
// low nibble (the even channel) in the low half: one prmt takes byte j of w
// and of w4 = w >> 4 into bytes 0 and 2, then the lop3 and subtraction of
// s4_pair.
template <int kByte>
__device__ __forceinline__ uint32_t s4_byte_pair(uint32_t w, uint32_t w4) {
  const uint32_t k136 = 0x43084308u;
  const uint32_t x = __byte_perm(w, w4, kByte | (kByte << 4) | ((4 + kByte) << 8) | ((4 + kByte) << 12));
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(x), "r"(0x000F000Fu), "r"(k136));
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The warps of a block (of a row group) split K into units of k-blocks, so
// a warp's run starts a stage (2 k-blocks) and, in grouped mode, a group.
__host__ __device__ __forceinline__ int mma_unit(bool dense, int kpg_log2) {
  return !dense && kpg_log2 > 0 ? 1 << kpg_log2 : 2;
}

// Where 16-byte chunk c (0..7) of row r sits in a stage: c ^ f(r). The map
// of groups of >= 128 reads 16 bytes a lane (quarter-warp phases: rows g and
// g+1), f = 4 (r & 1) puts the two rows in the two halves of the 32 banks;
// groups of 64 read 8 bytes (half warps: rows 4i..4i+3), f adds r & 2 so the
// four rows take four pairs of chunks; groups of 32 read 4 bytes (the warp:
// rows 0..7), f adds (r >> 2) & 1, the low 3 bits of r reversed.
template <int kPieceLog2>
__device__ __forceinline__ int chunk_off(int r, int c) {
  const int f = ((r & 1) << 2) | (kPieceLog2 > 0 ? r & 2 : 0) | (kPieceLog2 > 1 ? (r >> 2) & 1 : 0);
  return r * kStageRowBytes + ((c ^ f) << 4);
}

// The lane's 4 words of row r in k-block h of a stage, by the fragment map
// with pieces of 16 >> kPieceLog2 bytes (see the header).
template <int kPieceLog2>
__device__ __forceinline__ void lane_words(uint32_t x[4], const unsigned char* stage, int r, int h, int t) {
  if constexpr (kPieceLog2 == 0) {  // bytes [16t, +16)
    const uint4 v = *reinterpret_cast<const uint4*>(stage + chunk_off<0>(r, 4 * h + t));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (kPieceLog2 == 1) {  // bytes [32p + 8t, +8), p = 0, 1
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(stage + chunk_off<1>(r, 4 * h + 2 * p + (t >> 1)) + 8 * (t & 1));
      x[2 * p] = v.x, x[2 * p + 1] = v.y;
    }
  } else {  // bytes [16p + 4t, +4), p = 0..3
#pragma unroll
    for (int p = 0; p < 4; ++p) x[p] = *reinterpret_cast<const uint32_t*>(stage + chunk_off<2>(r, 4 * h + p) + 4 * t);
  }
}

// The 16-byte activation load (8 channels) that pairs with word q of lane t:
// its index among the k-block's 16 (lane part kWords * t, word part below).
template <int kPieceLog2>
__host__ __device__ constexpr int act_word(int q) {
  return (16 >> kPieceLog2) * (q / (4 >> kPieceLog2)) + q % (4 >> kPieceLog2);
}

template <int kPieceLog2>
__device__ __forceinline__ int act_index(int q, int t) {
  return act_word<kPieceLog2>(q) + (4 >> kPieceLog2) * t;
}

// m > 8: where 16-byte chunk c (0..15) of activation row R of a k-block sits
// in a shared-memory stage (256 bytes a row): its low 3 bits XORed so that
// the quarter warp's 16-byte reads (rows g, g+1; t = 0..3; one word q) fall
// in 8 distinct 16-byte bank groups at every fragment map.
template <int kPieceLog2>
__device__ __forceinline__ int act_pos(int R, int c) {
  const int s = kPieceLog2 == 0 ? ((R & 1) << 1) | (c >> 3) : (R & 1) << (kPieceLog2 == 1 ? 0 : 2);
  return ((c & 7) ^ s) | (c & 8);
}

// The 2 mma's of word q (slots 2q, 2q+1) of one row tile and n-tile: A from
// the words xa (row g) and xb (row g+8), B from the activations yq paired as
// the nibbles (pairs (2e, 2e+4) for k (2t, 2t+1), (2e+1, 2e+5) for k (2t+8,
// 2t+9)); dense mode dequantizes rows g and g+8 with the scales sa and sb.
template <bool kDense>
__device__ __forceinline__ void word_mma(float c[4], uint32_t xa, uint32_t xb, const uint32_t b[2][2], float sa,
                                         float sb) {
  uint32_t a[4];
  a[0] = a_pair<0, kDense>(xa, sa);
  a[1] = a_pair<0, kDense>(xb, sb);
  a[2] = a_pair<4, kDense>(xa, sa);
  a[3] = a_pair<4, kDense>(xb, sb);
  mma_bf16(c, a, b[0][0], b[0][1]);
  a[0] = a_pair<8, kDense>(xa, sa);
  a[1] = a_pair<8, kDense>(xb, sb);
  a[2] = a_pair<12, kDense>(xa, sa);
  a[3] = a_pair<12, kDense>(xb, sb);
  mma_bf16(c, a, b[1][0], b[1][1]);
}

// The B registers of word q's 2 mma's from its 8 activations.
__device__ __forceinline__ void word_b(uint32_t b[2][2], const uint4& yq) {
  b[0][0] = __byte_perm(yq.x, yq.z, 0x5410);
  b[0][1] = __byte_perm(yq.x, yq.z, 0x7632);
  b[1][0] = __byte_perm(yq.y, yq.w, 0x5410);
  b[1][1] = __byte_perm(yq.y, yq.w, 0x7632);
}

// m > 8: the bytes of a block's activation stage, [2 k-blocks][8 * nt
// rows][256 bytes].
__host__ __device__ constexpr int act_stage_bytes(int nt) { return nt == 1 ? 0 : 2 * 8 * nt * 256; }

// A block's dynamic shared memory: the warps' weight rings and, at m > 8,
// the activation ring.
__host__ __device__ constexpr int mma_smem_bytes(bool dense, int spk_log2, int nt, int warps) {
  return kStages * (warps * mma_stage_bytes(mma_m_tiles(dense, nt), spk_log2) + act_stage_bytes(nt));
}

// kSpkLog2: log2 of the scales a row a k-block (groups of >= 128: 0, 64: 1,
// 32: 2), in grouped mode also the fragment map's; kNT: n-tiles of 8
// activation rows a block feeds; kpg_log2: log2 of the k-blocks a group spans
// (groups of >= 256). At m <= 8 the grid is (output tiles, row chunks of 8)
// and a block's warps split K; at m > 8 it is (output tiles, K slices, row
// chunks of 64), the K slices of a tile one cluster, and a block's warps are
// row groups of 16 * kMT channels.
template <bool kDense, int kSpkLog2, int kNT>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, kNT >= 7 ? 1 : kMmaWarpsPerSm / kMmaMaxWarps)
q4_matmul_mma_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                     int m, int in_dim, int out_dim, int groups, int kpg_log2) {
  constexpr int kMT = mma_m_tiles(kDense, kNT);  // row tiles a warp owns
  constexpr int kRows = 16 * kMT;                   // its output channels
  constexpr int kPieceLog2 = kDense ? 0 : kSpkLog2;
  constexpr int kWords = 4 >> kPieceLog2;           // words a piece: a group's last mma's end word q
  constexpr int stage_bytes = mma_stage_bytes(kMT, kSpkLog2);
  constexpr int astage_bytes = act_stage_bytes(kNT);
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rws = kNT == 1 ? 1 : blockDim.x >> 5;   // row groups a block
  const int rw = kNT == 1 ? 0 : warp;                  // the warp's row group
  const int kw = kNT == 1 ? warp : blockIdx.y;         // its slice of K
  const int kws = kNT == 1 ? blockDim.x >> 5 : gridDim.y;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = (blockIdx.x * rws + rw) * kRows;
  const int row0 = (kNT == 1 ? blockIdx.y : blockIdx.z) * 8 * kNT;
  const int in_half = in_dim >> 1;
  const int nkb = (in_dim + kBlockK - 1) / kBlockK;  // the last may be partial
  const int kpg_mask = (1 << kpg_log2) - 1;

  // this warp's stages: whole units, so none straddles two slices
  const int unit = mma_unit(kDense, kpg_log2);
  const int units = (nkb + unit - 1) / unit;
  const int spu = unit >> 1;  // stages per unit
  const int u_begin = units * kw / kws;
  const int st_begin = u_begin * spu;
  const int n_st = (units * (kw + 1) / kws - u_begin) * spu;

  unsigned char* ring = smem + warp * kStages * stage_bytes;
  const uint32_t ring_u32 = smem_u32(ring);

  // A stage: rows o0..o0+kRows-1, k-blocks 2st, 2st+1. Copy i covers rows
  // 4i..4i+3 with 8 lanes a row, 128 contiguous bytes each (whole lines):
  // lane chunk c = lane & 7 is bytes 128st + 16c of its row. At m <= 8 the
  // copies' addresses are kept in registers; at m > 8, whose accumulators
  // take them, they are computed a stage.
  constexpr int kKeep = kNT == 1 ? kRows / 4 : 1;
  const int8_t* wsrc[kKeep];
  uint32_t wdst[kKeep];
  bool wok[kKeep];
  if constexpr (kNT == 1) {
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = (lane >> 3) + 4 * i;
      wok[i] = o0 + r < out_dim;
      wsrc[i] = w + static_cast<size_t>(wok[i] ? o0 + r : 0) * in_half + 16 * (lane & 7);
      wdst[i] = chunk_off<kPieceLog2>(r, lane & 7);
    }
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
      if constexpr (kNT == 1) {
        const bool valid = wok[i] && kok;
        cp_async16(dst + wdst[i], valid ? wsrc[i] + st * kStageRowBytes : w, valid);
      } else {
        const int r = (lane >> 3) + 4 * i;
        const bool valid = o0 + r < out_dim && kok;
        cp_async16(dst + chunk_off<kPieceLog2>(r, lane & 7),
                   valid ? w + static_cast<size_t>(o0 + r) * in_half + kStageRowBytes * st + 16 * (lane & 7) : w,
                   valid);
      }
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

  // grouped mode: the group's last mma's scale and add its partial (piece p
  // of k-block h)
  float acc[kMT][kNT][4] = {};
  float part[kMT][kNT][4] = {};
  auto flush = [&](const float* sc, int mt, int h, int p) {
    const int r = 16 * mt + g;
    const float s0 = sc[((2 * r + h) << kSpkLog2) + p];
    const float s1 = sc[((2 * (r + 8) + h) << kSpkLog2) + p];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[mt][nt][0] = fmaf(part[mt][nt][0], s0, acc[mt][nt][0]);
      acc[mt][nt][1] = fmaf(part[mt][nt][1], s0, acc[mt][nt][1]);
      acc[mt][nt][2] = fmaf(part[mt][nt][2], s1, acc[mt][nt][2]);
      acc[mt][nt][3] = fmaf(part[mt][nt][3], s1, acc[mt][nt][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
    }
  };
  // the group ends with word q of k-block kb
  auto group_end = [&](int q, int kb) {
    return kPieceLog2 > 0 ? q % kWords == kWords - 1 : q == 3 && (kb & kpg_mask) == kpg_mask;
  };

  if constexpr (kNT == 1) {
    // m <= 8: lane (g, t) feeds activation row row0 + g (zero past m); its
    // loads of a k-block start at act_index(0, t), and piece p's start is
    // channel 128kb + (128 >> kPieceLog2) p + (32 >> kPieceLog2) t.
    const int yrow = row0 + g;
    const bool vy = yrow < m;
    const uint4* yp = reinterpret_cast<const uint4*>(y + static_cast<size_t>(vy ? yrow : 0) * in_dim) + kWords * t;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_st) issue(st_begin + j, j);
      cp_async_commit();
    }
    for (int j = 0; j < n_st; ++j) {
      if (j + kStages - 1 < n_st) issue(st_begin + j + kStages - 1, (j + kStages - 1) % kStages);
      cp_async_commit();
      const int st = st_begin + j;
      uint4 yv[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int chan = kBlockK * (2 * st + h) + (kBlockK >> kPieceLog2) * (q / kWords) + (32 >> kPieceLog2) * t;
          yv[h][q] = (vy && chan < in_dim) ? __ldg(yp + (2 * st + h) * (kBlockK / 8) + act_word<kPieceLog2>(q))
                                           : zero;
        }
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const unsigned char* stage = ring + (j % kStages) * stage_bytes;
      const float* sc = reinterpret_cast<const float*>(stage + kRows * kStageRowBytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kb = 2 * st + h;
        if (h == 0 || kb < nkb) {  // a stage's second k-block is past the end when nkb is odd
          uint32_t b[4][2][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) word_b(b[q], yv[h][q]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const int r = 16 * mt + g;
            uint32_t wa[4], wb[4];
            lane_words<kPieceLog2>(wa, stage, r, h, t);
            lane_words<kPieceLog2>(wb, stage, r + 8, h, t);
            // dense mode: the lane's 32 channels lie in one group, entry t >> (2 - kSpkLog2)
            const int e = t >> (kMaxSpkLog2 - kSpkLog2);
            const float sa = kDense ? sc[((2 * r + h) << kSpkLog2) + e] : 0.f;
            const float sb = kDense ? sc[((2 * (r + 8) + h) << kSpkLog2) + e] : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if constexpr (kDense) {
                word_mma<true>(acc[mt][0], wa[q], wb[q], b[q], sa, sb);
              } else {
                word_mma<false>(part[mt][0], wa[q], wb[q], b[q], 0.f, 0.f);
                if (group_end(q, kb)) flush(sc, mt, h, q / kWords);
              }
            }
          }
        }
      }
      __syncwarp();  // the stage's readers are done before it is refilled
    }
  } else {
    // m > 8 (grouped mode): the block's warps (its row groups) share a ring
    // of activation stages and a barrier a stage publishes them; lane (g, t)
    // reads row 8nt + g of n-tile nt. Warp rw copies rows rw, rw + rws, ...,
    // 16 lanes a row and k-block (chunk lane & 15 of k-block lane >> 4).
    // Rows past m are not copied: an mma's column n of B reaches only column
    // n of its product, the output row that is never stored. Channels past
    // the contraction are zero-filled (their weights are zero; garbage could
    // be a NaN). A registers hold byte pairs (the two nibbles of one byte),
    // so the B registers are the activation words as they are.
    unsigned char* aring = smem + rws * kStages * stage_bytes;
    const int ah = lane >> 4, ach = lane & 15;
    const int arows = m - row0 < 8 * kNT ? m - row0 : 8 * kNT;
    auto issue_act = [&](int st, int buf) {
      const int chan = kBlockK * (2 * st + ah) + 8 * ach;
      const uint32_t dst =
          smem_u32(aring) + buf * astage_bytes + ah * (8 * kNT * 256) + (act_pos<kPieceLog2>(rw, ach) << 4);
      for (int R = rw; R < arows; R += rws)  // rws is even: R & 1 = rw & 1
        cp_async16(dst + R * 256, chan < in_dim ? y + static_cast<size_t>(row0 + R) * in_dim + chan : y,
                   chan < in_dim);
    };

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_st) issue(st_begin + j, j), issue_act(st_begin + j, j);
      cp_async_commit();
    }
    for (int j = 0; j < n_st; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage j is in; every warp is done with stage j - 1
      if (j + kStages - 1 < n_st) {
        const int buf = (j + kStages - 1) % kStages;
        issue(st_begin + j + kStages - 1, buf);
        issue_act(st_begin + j + kStages - 1, buf);
      }
      cp_async_commit();
      const int st = st_begin + j;
      const unsigned char* stage = ring + (j % kStages) * stage_bytes;
      const float* sc = reinterpret_cast<const float*>(stage + kRows * kStageRowBytes);
      const unsigned char* astage = aring + (j % kStages) * astage_bytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kb = 2 * st + h;
        if (h == 0 || kb < nkb) {
          uint32_t wa[kMT][4], wb[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            lane_words<kPieceLog2>(wa[mt], stage, 16 * mt + g, h, t);
            lane_words<kPieceLog2>(wb[mt], stage, 16 * mt + g + 8, h, t);
          }
          const unsigned char* arow = astage + h * (8 * kNT * 256) + g * 256;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // mma 2q + e: a0/a2 = bytes 2e / 2e+1 of word q of row g (k 2t,
            // 2t+1 / 2t+8, 2t+9: channels c + 4e + 0, 1 / 2, 3), a1/a3 of row g+8
            uint32_t a[2][kMT][4];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              const uint32_t xa = wa[mt][q], xb = wb[mt][q], xa4 = xa >> 4, xb4 = xb >> 4;
              a[0][mt][0] = s4_byte_pair<0>(xa, xa4);
              a[0][mt][1] = s4_byte_pair<0>(xb, xb4);
              a[0][mt][2] = s4_byte_pair<1>(xa, xa4);
              a[0][mt][3] = s4_byte_pair<1>(xb, xb4);
              a[1][mt][0] = s4_byte_pair<2>(xa, xa4);
              a[1][mt][1] = s4_byte_pair<2>(xb, xb4);
              a[1][mt][2] = s4_byte_pair<3>(xa, xa4);
              a[1][mt][3] = s4_byte_pair<3>(xb, xb4);
            }
            const int off = act_pos<kPieceLog2>(g, act_index<kPieceLog2>(q, t)) << 4;  // rows 8nt + g: R & 1 = g & 1
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              // B of mma 2q + e: activation words 2e, 2e+1 (channels c + 4e + 0..3)
              const uint4 yq = *reinterpret_cast<const uint4*>(arow + nt * 8 * 256 + off);
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
                mma_bf16(part[mt][nt], a[0][mt], yq.x, yq.y);
                mma_bf16(part[mt][nt], a[1][mt], yq.z, yq.w);
              }
            }
            if (group_end(q, kb)) {
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) flush(sc, mt, h, q / kWords);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (kNT == 1) {
    // The K slices' partials, summed in slice order in shared memory.
    constexpr int kRegs = 4 * kMT;
    __shared__ float red[kMmaMaxWarps * kRegs * 32];
    if (kw > 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[(warp * kRegs + mt * 4 + i) * 32 + lane] = acc[mt][0][i];
    }
    __syncthreads();
    if (kw == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = acc[mt][0][i];
          for (int k = 1; k < kws; ++k) v += red[(k * kRegs + mt * 4 + i) * 32 + lane];
          // c0, c1: channel o0+16mt+g, rows 2t, 2t+1; c2, c3: channel o0+16mt+g+8
          const int o = o0 + 16 * mt + g + ((i & 2) ? 8 : 0);
          const int row = row0 + 2 * t + (i & 1);
          if (o < out_dim && row < m) out[static_cast<size_t>(row) * out_dim + o] = __float2bfloat16_rn(v);
        }
    }
  } else {
    // The cluster's K slices: each block's [8 kNT rows][its channels] f32
    // partials in its shared memory (over the drained rings), then block r
    // of the cluster sums its share of the elements over the blocks in rank
    // order, through distributed shared memory. Both cluster barriers keep
    // every block's shared memory alive while a peer reads it.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int rows = rws * kRows;  // the block's output channels
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(8 * nt + 2 * t + (i & 1)) * rows + rw * kRows + 16 * mt + g + ((i & 2) ? 8 : 0)] = acc[mt][nt][i];
    cluster.sync();
    // 4 consecutive channels of one row a thread: the peers' loads issued
    // together, then summed in rank order
    const int n4 = 2 * kNT * rows, slices = cluster.num_blocks(), r = cluster.block_rank();
    for (int e = n4 * r / slices + threadIdx.x; e < n4 * (r + 1) / slices; e += blockDim.x) {
      float4 p[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < slices) p[k] = reinterpret_cast<const float4*>(cluster.map_shared_rank(red, k))[e];
      float4 v = p[0];
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k)
        if (k < slices) v.x += p[k].x, v.y += p[k].y, v.z += p[k].z, v.w += p[k].w;
      const int row = row0 + 4 * e / rows, o = blockIdx.x * rows + 4 * e % rows;
      if (row < m) {
        __nv_bfloat16* dst = out + static_cast<size_t>(row) * out_dim + o;
        if (o < out_dim) dst[0] = __float2bfloat16_rn(v.x);
        if (o + 1 < out_dim) dst[1] = __float2bfloat16_rn(v.y);
        if (o + 2 < out_dim) dst[2] = __float2bfloat16_rn(v.z);
        if (o + 3 < out_dim) dst[3] = __float2bfloat16_rn(v.w);
      }
    }
    cluster.sync();
  }
}

using MmaKernel = void (*)(const __nv_bfloat16*, const int8_t*, const float*, __nv_bfloat16*, int, int, int, int,
                           int);

// The n-tiles a grouped launch instantiates for m rows: 1, 2, 4, 7 (the
// Jacobi pass at bs 8, m = 56, and m = 33..56) or 8 (a row chunk of 64).
constexpr int kNTs[] = {1, 2, 4, 7, 8};

inline int n_tiles_for(int m) {
  const int need = m <= 8 ? 1 : m >= 8 * kMaxNT ? kMaxNT : (m + 7) / 8;
  for (int nt : kNTs)
    if (nt >= need) return nt;
  return kMaxNT;
}

// The instantiation for a shape: dense mode at one n-tile (its grid.y takes
// 8 rows at a time), grouped mode at each of kNTs.
template <bool kDense, int kSpkLog2>
MmaKernel mma_kernel_nt(int nt) {
  if constexpr (kDense) {
    return q4_matmul_mma_kernel<true, kSpkLog2, 1>;
  } else {
    switch (nt) {
      case 1: return q4_matmul_mma_kernel<false, kSpkLog2, 1>;
      case 2: return q4_matmul_mma_kernel<false, kSpkLog2, 2>;
      case 4: return q4_matmul_mma_kernel<false, kSpkLog2, 4>;
      case 7: return q4_matmul_mma_kernel<false, kSpkLog2, 7>;
      default: return q4_matmul_mma_kernel<false, kSpkLog2, 8>;
    }
  }
}

template <bool kDense>
MmaKernel mma_kernel(int spk_log2, int nt) {
  if (spk_log2 == 0) return mma_kernel_nt<kDense, 0>(nt);
  if (spk_log2 == 1) return mma_kernel_nt<kDense, 1>(nt);
  return mma_kernel_nt<kDense, 2>(nt);
}

// The SM count and the opt-in shared memory a block of the current device,
// and every instantiation's dynamic shared-memory limit raised (to what 8
// warps take, within the device's), once per device, so that later launches
// (e.g. inside a CUDA graph capture) make no such call.
cudaError_t mma_setup(int* sms, int* smem_max) {
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {}, smem_optin[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && sm_count[dev] > 0) {
    *sms = sm_count[dev];
    *smem_max = smem_optin[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int dense = 0; dense < 2 && err == cudaSuccess; ++dense)
    for (int spk = 0; spk <= kMaxSpkLog2 && err == cudaSuccess; ++spk)
      for (int nt : kNTs) {
        if (err != cudaSuccess || (dense && nt > 1)) break;
        const int bytes = mma_smem_bytes(dense, spk, nt, kMmaMaxWarps);
        err = cudaFuncSetAttribute(dense ? mma_kernel<true>(spk, nt) : mma_kernel<false>(spk, nt),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes < *smem_max ? bytes : *smem_max);
      }
  if (err == cudaSuccess && dev < kMaxDevices) sm_count[dev] = *sms, smem_optin[dev] = *smem_max;
  return err;
}

template <bool kDense>
int launch_mma(const void* y, const void* w, const void* scale, void* out, int m, int in_dim, int out_dim,
               int groups, void* stream) {
  int sms = 0, smem_max = 0;
  const cudaError_t err = mma_setup(&sms, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gs = in_dim / groups;
  int kpg_log2 = 0, spk_log2 = 0;
  while ((kBlockK << kpg_log2) < gs) ++kpg_log2;
  while ((kBlockK >> spk_log2) > gs) ++spk_log2;
  // grouped mode: n-tiles enough for m (<= 8 of them: a row chunk of 64)
  const int nt = kDense ? 1 : n_tiles_for(m);
  const int unit = mma_unit(kDense, kpg_log2);
  const int units = ((in_dim + kBlockK - 1) / kBlockK + unit - 1) / unit;
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const MmaKernel kernel = mma_kernel<kDense>(spk_log2, nt);
  if (nt == 1) {
    // m <= 8 (and dense mode, 8 rows a grid.y): K split among a block's
    // warps, halved from 8 until the grid keeps to one wave of 16 warps an SM
    const int rows = 16 * mma_m_tiles(kDense, 1);
    const dim3 grid((out_dim + rows - 1) / rows, (m + 7) / 8);
    const long tiles = static_cast<long>(grid.x) * grid.y;
    int warps = kMmaMaxWarps;
    while (warps > 1 && (warps > units || tiles * warps > static_cast<long>(kMmaWarpsPerSm) * sms)) warps >>= 1;
    kernel<<<grid, warps * 32, mma_smem_bytes(kDense, spk_log2, 1, warps), static_cast<cudaStream_t>(stream)>>>(
        yp, wp, sp, op, m, in_dim, out_dim, groups, kpg_log2);
    return static_cast<int>(cudaGetLastError());
  }
  // m > 8: kWideWarps warps a block (half that where the output's tiles
  // would fill under half the SMs), one row group each; K split among the blocks of
  // a cluster (grid.y), doubled up to 8 while the grid keeps to one wave (two
  // blocks an SM, one at 8 n-tiles, whose registers take the SM's half) and
  // each slice to kMinSliceUnits units
  const int mt = mma_m_tiles(kDense, nt);
  const int wide_tiles = (out_dim + 16 * mt * kWideWarps - 1) / (16 * mt * kWideWarps);
  const int wide = wide_tiles * 2 < sms ? kWideWarps / 2 : kWideWarps;
  const int rows = 16 * mt * wide;
  const int tiles = (out_dim + rows - 1) / rows, chunks = (m + 8 * nt - 1) / (8 * nt);
  int slices = 1;
  const long per_sm = nt >= 7 ? 1 : 2;
  while (slices < kMaxCluster && static_cast<long>(tiles) * chunks * slices * 2 <= per_sm * sms &&
         units >= 2 * slices * kMinSliceUnits)
    slices <<= 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, slices, chunks);
  cfg.blockDim = dim3(wide * 32);
  cfg.dynamicSmemBytes = mma_smem_bytes(kDense, spk_log2, nt, wide);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, yp, wp, sp, op, m, in_dim, out_dim, groups, kpg_log2);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grouped mode: group size in_dim / groups of 32 * 2^k channels, k <= 5, any
// m (checked by the caller). Launch on `stream` (a cudaStream_t); returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int q4_matmul_grouped_mma_bf16(const void* y, const void* w, const void* scale, void* out, int m,
                                          int in_dim, int out_dim, int groups, void* stream) {
  return launch_mma<false>(y, w, scale, out, m, in_dim, out_dim, groups, stream);
}

// Dense mode: group size 32 * 2^k channels, k <= 5 (checked by the caller).
// Launch on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int q4_matmul_dense_mma_bf16(const void* y, const void* w, const void* scale, void* out, int m,
                                        int in_dim, int out_dim, int groups, void* stream) {
  return launch_mma<true>(y, w, scale, out, m, in_dim, out_dim, groups, stream);
}

extern "C" const char* q4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
