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
//   grouped (B4, _kernel_grouped): the raw s4 integers are contracted in
//     f32; each group's f32 partial is multiplied by its scale after the
//     group's contraction.
//   dense (B5, _kernel_dense): each weight is dequantized (nibble * scale),
//     rounded to bf16, then contracted with f32 accumulation.
//
// What bounds it: at decode batch sizes this is a matrix-vector product that
// streams the packed weights once: out*in/2 bytes plus out*G*4 bytes of
// scales (8.4 MB for a 4096x4096 projection, 22.6 MB for 11008x4096), against
// the card's memory bandwidth (3.35 TB/s on an H100 SXM). The design keeps
// the traffic at that: weights are read once, with 16-byte loads, unpacked
// in registers with integer shifts; the activations are staged through
// shared memory one K tile at a time and shared by the block's warps.
//
// Layout of the work:
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
//   - grouped mode: a group of G channels spans G/32 neighbouring lanes; their
//     chunk partials are summed with xor shuffles, then scaled once.
//   - a final xor-shuffle reduction over the warp gives each output.
// The host wrapper checks: in % 32 == 0, G/32 lanes per group is a power of
// two <= 32, 16-byte aligned contiguous operands.
//
// This first design is simple and correct and runs the FMAs on the CUDA
// cores. Tensor-core MMA (mma.sync / wgmma), TMA staging and split-K for
// more blocks in flight are work for later changes.

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

template <int MT, bool kDense>
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
        if (kDense) {
          w0 = __bfloat162float(__float2bfloat16_rn(w0 * sc[r]));
          w1 = __bfloat162float(__float2bfloat16_rn(w1 * sc[r]));
          w2 = __bfloat162float(__float2bfloat16_rn(w2 * sc[r]));
          w3 = __bfloat162float(__float2bfloat16_rn(w3 * sc[r]));
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
        if (kDense) {
          acc[r][t] += part[r][t];
        } else {
          // the group's f32 partial, then its scale
          float p = part[r][t];
          for (int off = 1; off < lanes_per_group; off <<= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
          if ((lane & (lanes_per_group - 1)) == 0) acc[r][t] = fmaf(p, sc[r], acc[r][t]);
        }
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
            int out_dim, int groups, bool dense, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const dim3 grid((out_dim + kRowsPerBlock - 1) / kRowsPerBlock, (m + MT - 1) / MT);
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (dense) {
    q4_matmul_kernel<MT, true><<<grid, block, 0, stream>>>(yp, wp, sp, op, m, in_dim, out_dim, groups);
  } else {
    q4_matmul_kernel<MT, false><<<grid, block, 0, stream>>>(yp, wp, sp, op, m, in_dim, out_dim, groups);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch (0 = launched). Shapes and alignment are checked by the caller.
extern "C" int q4_matmul_bf16(const void* y, const void* w, const void* scale, void* out, int m,
                              int in_dim, int out_dim, int groups, int dense, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool d = dense != 0;
  if (m <= 1) {
    launch<1>(y, w, scale, out, m, in_dim, out_dim, groups, d, s);
  } else if (m <= 2) {
    launch<2>(y, w, scale, out, m, in_dim, out_dim, groups, d, s);
  } else if (m <= 4) {
    launch<4>(y, w, scale, out, m, in_dim, out_dim, groups, d, s);
  } else {
    launch<8>(y, w, scale, out, m, in_dim, out_dim, groups, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* q4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
