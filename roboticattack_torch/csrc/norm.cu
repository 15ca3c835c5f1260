// Row normalisation of every transformer block of the port, forward and
// backward, hand-written for Hopper: LayerNorm (the vision towers, Phi-2's
// decoder) and RMSNorm (the Llama / Mistral decoders, every norm of the
// DeepSeek-V3 decoder, MLA's kv_norm included), bf16 in and out with f32
// statistics.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which fuses
// each into one pass over the row. The port ran them as eager chains of f32
// operations (ops/norm.py layer_norm_plain: 11 kernels each way;
// rms_norm_plain: 7), each reading and writing the whole activation in f32.
// These kernels read each row once in bf16 and write it once.
//
// Arithmetic, per row of width n (x bf16; f32 from here on):
//   LayerNorm  mean = sum(x) / n, var = sum((x - mean)^2) / n (two sums over
//              the row held in registers, not E[x^2] - mean^2),
//              rstd = rsqrt(var + eps), y = bf16((x - mean) * rstd * scale + bias)
//   RMSNorm    rstd = rsqrt(sum(x^2) / n + eps), y = bf16(w * bf16(x * rstd))
//              (HF's LlamaRMSNorm: the normalised row is rounded to bf16 before
//              the weight, and the bf16 product rounds once)
// and back, with dy bf16 as autograd hands it over:
//   LayerNorm  g = dy * scale, xhat = (x - mean) * rstd,
//              dx = bf16(rstd * (g - sum(g) / n - xhat * sum(g * xhat) / n)),
//              dscale = sum over rows of dy * xhat, dbias = sum over rows of dy
//   RMSNorm    g = bf16(dy * w) (autograd's product of two bf16 tensors),
//              dx = bf16(g * rstd - x * rstd^3 * sum(g * x) / n),
//              dw = sum over rows of dy * bf16(x * rstd)
// Each product, sum and difference of the plain chain keeps its place and
// runs in f32 (__fmul_rn / __fadd_rn where the chain rounds a product before
// the next operation, so nvcc does not contract them into one fma); only the
// order of the f32 sums differs.
//
// Operands. x: rows of n elements, a row stride that is a multiple of 8
// elements (so MLA's kv latent goes in as a slice of its projection), 16-byte
// aligned; y, dy, dx: contiguous [rows, n]; scale / w / bias: [n]; mean, rstd:
// [rows] f32, written by the forward and read by the backward (mean for
// LayerNorm only). n a multiple of 8, at most 5120.
//
// What bounds it on the card: bytes. The forward reads x and writes y (4n
// bytes a row), the backward reads x and dy and writes dx (6n): at Mistral's
// decoder [2304, 4096] 37.7 MB (11.3 us at 3.35 TB/s) and 56.6 MB (16.9 us),
// at a tower's [2088, 1024] about 2.6 / 3.8 us. The eager chains moved several
// times those bytes in f32, over 7-11 launches each way.
//
// Layout. A block is 4 warps (128 threads). A row is held by a group of
// kWarps warps (1, 2 or 4, so 4, 2 or 1 rows a block), each thread holding up
// to kVecs 16-byte vectors of it (8 bf16 elements each; vector j of the row
// belongs to thread j % (32 kWarps)), loaded once with every thread's loads in
// flight together and kept as raw bf16 in registers; the tile is the smallest
// of seven that covers the row (Tile, by_tile), so 512-wide rows pack 4 to a
// block and 2304-4864 rows fill the 132 SMs many times over. The row's sums go
// through warp shuffles and, across the warps of a row, a few floats of shared
// memory, in a fixed order. The weight gradients (the trainer's; the attack's
// weights need none) are a pass of their own: one thread per 8 columns sums
// 32 rows' products (norm_wgrad_part_kernel), and a second kernel adds those
// partial sums in row order (norm_wgrad_sum_kernel): no atomics, so two
// launches on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // a block: 4 warps
constexpr int kPartRows = 32;  // rows of one weight-gradient partial sum

// kWarps warps a row, kVecs 16-byte vectors a thread: rows up to
// 256 * kWarps * kVecs elements.
template <int kWarps, int kVecs>
struct Tile {
  static constexpr int warps = kWarps;
  static constexpr int vecs = kVecs;
  static constexpr int row_threads = 32 * kWarps;
  static constexpr int rows = kThreads / row_threads;  // rows a block
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x, the low half, from lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The sums of a and b over the kWarps warps of the calling thread's row, in a
// fixed order; every thread of the row gets them. `red`: 2 * kThreads / 32
// floats of shared memory. Every thread of the block calls it.
template <int kWarps>
__device__ __forceinline__ void row_sums(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (kWarps > 1) {
    const int warp = threadIdx.x / 32, first = warp / kWarps * kWarps;
    if (threadIdx.x % 32 == 0) {
      red[2 * warp] = a;
      red[2 * warp + 1] = b;
    }
    __syncthreads();
    a = b = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      a += red[2 * (first + i)];
      b += red[2 * (first + i) + 1];
    }
    __syncthreads();  // red is free for the next call
  }
}

// One row a group of T::row_threads threads. A row past `rows` loads zeros
// and stores nothing, but takes part in the block's barriers.
template <class T, bool kLayer>
__global__ void __launch_bounds__(kThreads)
    norm_fwd_kernel(const uint4* __restrict__ x, long long x_stride, const uint4* __restrict__ w,
                    const uint4* __restrict__ b, uint4* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int rows, int nvec, float inv_n, float eps) {
  __shared__ float red[2 * kThreads / 32];
  const int t = threadIdx.x % T::row_threads;
  const int row = blockIdx.x * T::rows + threadIdx.x / T::row_threads;
  const bool live = row < rows;
  const uint4* xr = x + static_cast<long long>(row) * x_stride;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xv[T::vecs], wv[T::vecs], bv[kLayer ? T::vecs : 1];
#pragma unroll
  for (int i = 0; i < T::vecs; ++i) {
    const int j = t + i * T::row_threads;
    const bool in = live && j < nvec;
    xv[i] = in ? xr[j] : zero;
    wv[i] = in ? w[j] : zero;
    if constexpr (kLayer) bv[i] = in ? b[j] : zero;
  }
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < T::vecs; ++i) {
    float f[8];
    unpack(xv[i], f);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += kLayer ? f[k] : f[k] * f[k];
  }
  row_sums<T::warps>(s, q, red);
  float mean = 0.f, rstd;
  if constexpr (kLayer) {
    mean = s * inv_n;
    q = 0.f;
#pragma unroll
    for (int i = 0; i < T::vecs; ++i) {
      if (t + i * T::row_threads < nvec) {
        float f[8];
        unpack(xv[i], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = f[k] - mean;
          q += d * d;
        }
      }
    }
    float unused = 0.f;
    row_sums<T::warps>(q, unused, red);
    rstd = rsqrtf(q * inv_n + eps);
  } else {
    rstd = rsqrtf(s * inv_n + eps);
  }
  if (!live) return;  // past the last barrier
  if (t == 0) {
    rstd_out[row] = rstd;
    if constexpr (kLayer) mean_out[row] = mean;
  }
  uint4* yr = y + static_cast<long long>(row) * nvec;
#pragma unroll
  for (int i = 0; i < T::vecs; ++i) {
    const int j = t + i * T::row_threads;
    if (j >= nvec) continue;
    float f[8], g[8], o[8];
    unpack(xv[i], f);
    unpack(wv[i], g);
    if constexpr (kLayer) {
      float c[8];
      unpack(bv[i], c);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(__fmul_rn(__fmul_rn(f[k] - mean, rstd), g[k]), c[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __fmul_rn(bf16_round(f[k] * rstd), g[k]);
    }
    yr[j] = pack(o);
  }
}

// The backward's terms of 8 elements: g (the gradient reaching the
// normalised row) and h, xhat (LayerNorm) or x (RMSNorm).
template <bool kLayer>
__device__ __forceinline__ void bwd_terms(const uint4& xv, const uint4& dv, const uint4& wv, float mean, float rstd,
                                          float (&g)[8], float (&h)[8]) {
  float d[8], c[8];
  unpack(xv, h);
  unpack(dv, d);
  unpack(wv, c);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if constexpr (kLayer) {
      g[k] = __fmul_rn(d[k], c[k]);
      h[k] = __fmul_rn(h[k] - mean, rstd);
    } else {
      g[k] = bf16_round(__fmul_rn(d[k], c[k]));
    }
  }
}

// dx of one row a group of threads, from x, dy, the weight and the forward's
// statistics.
template <class T, bool kLayer>
__global__ void __launch_bounds__(kThreads)
    norm_bwd_kernel(const uint4* __restrict__ x, long long x_stride, const uint4* __restrict__ dy,
                    const uint4* __restrict__ w, const float* __restrict__ mean_in,
                    const float* __restrict__ rstd_in, uint4* __restrict__ dx, int rows, int nvec, float inv_n) {
  __shared__ float red[2 * kThreads / 32];
  const int t = threadIdx.x % T::row_threads;
  const int row = blockIdx.x * T::rows + threadIdx.x / T::row_threads;
  const bool live = row < rows;
  const uint4* xr = x + static_cast<long long>(row) * x_stride;
  const uint4* dyr = dy + static_cast<long long>(row) * nvec;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xv[T::vecs], dv[T::vecs], wv[T::vecs];
#pragma unroll
  for (int i = 0; i < T::vecs; ++i) {
    const int j = t + i * T::row_threads;
    const bool in = live && j < nvec;
    xv[i] = in ? xr[j] : zero;
    dv[i] = in ? dyr[j] : zero;  // zero dy: the padding adds nothing to either sum
    wv[i] = in ? w[j] : zero;
  }
  const float rstd = live ? rstd_in[row] : 0.f;
  float mean = 0.f;
  if constexpr (kLayer) mean = live ? mean_in[row] : 0.f;
  float sg = 0.f, sgh = 0.f;
#pragma unroll
  for (int i = 0; i < T::vecs; ++i) {
    float g[8], h[8];
    bwd_terms<kLayer>(xv[i], dv[i], wv[i], mean, rstd, g, h);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sg += g[k];
      sgh += g[k] * h[k];
    }
  }
  row_sums<T::warps>(sg, sgh, red);
  if (!live) return;  // past the last barrier
  const float mg = sg * inv_n, mgh = sgh * inv_n, cube = -sgh * (rstd * rstd * rstd) * inv_n;
  uint4* dxr = dx + static_cast<long long>(row) * nvec;
#pragma unroll
  for (int i = 0; i < T::vecs; ++i) {
    const int j = t + i * T::row_threads;
    if (j >= nvec) continue;
    float g[8], h[8], o[8];
    bwd_terms<kLayer>(xv[i], dv[i], wv[i], mean, rstd, g, h);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (kLayer) {
        o[k] = rstd * (g[k] - mg - h[k] * mgh);
      } else {
        o[k] = g[k] * rstd + h[k] * cube;
      }
    }
    dxr[j] = pack(o);
  }
}

// The weight gradients' partial sums: thread j of block (., p) sums vector
// column j over rows [32 p, 32 p + 32) into part[p] (and the bias's into
// part[parts + p]), f32 [parts, n] each.
template <bool kLayer>
__global__ void __launch_bounds__(kThreads)
    norm_wgrad_part_kernel(const uint4* __restrict__ x, long long x_stride, const uint4* __restrict__ dy,
                           const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                           float* __restrict__ part, int rows, int nvec, int parts) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nvec) return;
  const int p = blockIdx.y, r1 = min(rows, (p + 1) * kPartRows);
  float dw[8] = {}, db[8] = {};
  for (int r = p * kPartRows; r < r1; ++r) {
    float f[8], d[8];
    unpack(x[static_cast<long long>(r) * x_stride + j], f);
    unpack(dy[static_cast<long long>(r) * nvec + j], d);
    const float rstd = rstd_in[r];
    const float mean = kLayer ? mean_in[r] : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float h = kLayer ? __fmul_rn(f[k] - mean, rstd) : bf16_round(f[k] * rstd);
      dw[k] += d[k] * h;
      if constexpr (kLayer) db[k] += d[k];
    }
  }
  const long long n = 8LL * nvec;
  float4* out = reinterpret_cast<float4*>(part + p * n) + 2 * j;
  out[0] = make_float4(dw[0], dw[1], dw[2], dw[3]);
  out[1] = make_float4(dw[4], dw[5], dw[6], dw[7]);
  if constexpr (kLayer) {
    out = reinterpret_cast<float4*>(part + (parts + p) * n) + 2 * j;
    out[0] = make_float4(db[0], db[1], db[2], db[3]);
    out[1] = make_float4(db[4], db[5], db[6], db[7]);
  }
}

// Column c of grid row y: the sum of its `parts` partial sums, in order.
__global__ void __launch_bounds__(kThreads)
    norm_wgrad_sum_kernel(const float* __restrict__ part, int parts, int n, __nv_bfloat16* __restrict__ dw,
                          __nv_bfloat16* __restrict__ db) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  const float* src = part + static_cast<long long>(blockIdx.y) * parts * n + c;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += src[static_cast<long long>(p) * n];
  (blockIdx.y == 0 ? dw : db)[c] = __float2bfloat16_rn(s);
}

constexpr int kMaxVecs = 640;  // 5120 elements

// The smallest tile that covers a row of nvec vectors.
template <class F>
cudaError_t by_tile(int nvec, F&& f) {
  if (nvec <= 64) return f(Tile<1, 2>{});
  if (nvec <= 128) return f(Tile<1, 4>{});
  if (nvec <= 160) return f(Tile<1, 5>{});
  if (nvec <= 256) return f(Tile<2, 4>{});
  if (nvec <= 320) return f(Tile<2, 5>{});
  if (nvec <= 512) return f(Tile<4, 4>{});
  return f(Tile<4, 5>{});
}

bool bad_shape(int rows, int n, long long x_stride) {
  return rows <= 0 || n <= 0 || n % 8 != 0 || n / 8 > kMaxVecs || x_stride % 8 != 0 || x_stride < n;
}

}  // namespace

// y = norm(x) for `rows` rows of n elements; LayerNorm with `b` (and `mean`),
// RMSNorm without (b and mean null).
extern "C" int norm_fwd_bf16(const void* x, long long x_stride, const void* w, const void* b, void* y, void* mean,
                             void* rstd, int rows, int n, float eps, void* stream) {
  if (bad_shape(rows, n, x_stride) || (b == nullptr) != (mean == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = n / 8;
  const auto* xp = static_cast<const uint4*>(x);
  const auto* wp = static_cast<const uint4*>(w);
  const auto* bp = static_cast<const uint4*>(b);
  auto* yp = static_cast<uint4*>(y);
  auto* mp = static_cast<float*>(mean);
  auto* rp = static_cast<float*>(rstd);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_tile(nvec, [&](auto tile) {
    using T = decltype(tile);
    const int blocks = (rows + T::rows - 1) / T::rows;
    if (b != nullptr)
      norm_fwd_kernel<T, true><<<blocks, kThreads, 0, s>>>(xp, x_stride / 8, wp, bp, yp, mp, rp, rows, nvec,
                                                           1.0f / n, eps);
    else
      norm_fwd_kernel<T, false><<<blocks, kThreads, 0, s>>>(xp, x_stride / 8, wp, bp, yp, mp, rp, rows, nvec,
                                                            1.0f / n, eps);
    return cudaGetLastError();
  }));
}

// dx of norm_fwd_bf16's rows from dy and the forward's statistics; `layer`
// picks LayerNorm (mean read) or RMSNorm.
extern "C" int norm_bwd_bf16(const void* x, long long x_stride, const void* dy, const void* w, const void* mean,
                             const void* rstd, void* dx, int rows, int n, int layer, void* stream) {
  if (bad_shape(rows, n, x_stride) || (layer != 0 && mean == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = n / 8;
  const auto* xp = static_cast<const uint4*>(x);
  const auto* dyp = static_cast<const uint4*>(dy);
  const auto* wp = static_cast<const uint4*>(w);
  const auto* mp = static_cast<const float*>(mean);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<uint4*>(dx);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_tile(nvec, [&](auto tile) {
    using T = decltype(tile);
    const int blocks = (rows + T::rows - 1) / T::rows;
    if (layer)
      norm_bwd_kernel<T, true><<<blocks, kThreads, 0, s>>>(xp, x_stride / 8, dyp, wp, mp, rp, dxp, rows, nvec,
                                                           1.0f / n);
    else
      norm_bwd_kernel<T, false><<<blocks, kThreads, 0, s>>>(xp, x_stride / 8, dyp, wp, mp, rp, dxp, rows, nvec,
                                                            1.0f / n);
    return cudaGetLastError();
  }));
}

// The number of partial sums norm_wgrad_bf16 needs for `rows` rows: its
// scratch `part` holds (layer ? 2 : 1) * norm_wgrad_parts(rows) * n floats.
extern "C" int norm_wgrad_parts(int rows) { return (rows + kPartRows - 1) / kPartRows; }

// dw (and, with `layer`, db) [n] bf16: the weight gradients over all rows,
// through the f32 scratch `part`.
extern "C" int norm_wgrad_bf16(const void* x, long long x_stride, const void* dy, const void* mean, const void* rstd,
                               void* part, void* dw, void* db, int rows, int n, int layer, void* stream) {
  if (bad_shape(rows, n, x_stride) || (layer != 0 && (mean == nullptr || db == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = n / 8, parts = norm_wgrad_parts(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nvec + kThreads - 1) / kThreads, parts);
  auto* pp = static_cast<float*>(part);
  if (layer)
    norm_wgrad_part_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), x_stride / 8, static_cast<const uint4*>(dy), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), pp, rows, nvec, parts);
  else
    norm_wgrad_part_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), x_stride / 8, static_cast<const uint4*>(dy), nullptr,
        static_cast<const float*>(rstd), pp, rows, nvec, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_wgrad_sum_kernel<<<dim3((n + kThreads - 1) / kThreads, layer ? 2 : 1), kThreads, 0, s>>>(
      pp, parts, n, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* norm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
