// 2x2x2 stride-2 max pool on channel-first bf16 and fp32 volumes, floor
// semantics for odd extents (the trailing plane, row or column is dropped,
// as torch MaxPool3d and the JAX reshape+max chain do), and its backward,
// in bf16 and fp32 too.
//
// Replaces: multimodal_segmentation_project_tpu/ops/pool.py
//   * _fwd_pool_kernel (public op max_pool2x_cf, forward): pool2x_kernel<T>,
//     bf16 (mmseg_pool2x) and fp32 (mmseg_pool2x_f32: the JAX package's
//     fp32 policy, whose pool kernel runs in x's dtype);
//   * _bwd_kernel (its custom-VJP backward): pool2x_bwd_kernel<T>,
//       dx[v] = g[v/2] * [x[v] == y[v/2]] / count(v/2),
//     equal shares to the window's tied maxima (JAX's convention, not
//     torch's first match), with the tie count and g / count in fp32 and
//     one cast to x's type, as the TPU kernel computes them: bf16
//     (mmseg_pool2x_bwd) and fp32 (mmseg_pool2x_bwd_f32, the fp32 policy's
//     train step; the cast is the identity).
//
// Design: one thread per output voxel reads its 8 inputs and writes their
// maximum; neighbouring threads take neighbouring output columns, so a warp
// reads two contiguous 64-byte runs per input row and writes one 64-byte
// run (128 in fp32). A max selects one of its inputs, so the result is
// exact in either type. NaN wins, as with jnp.maximum.
//
// The backward uses one thread per pooled voxel too: it reads y and g once
// and its 8 inputs, and writes their 8 gradients. The wrapper zero-fills dx
// first where an extent is odd (the dropped tail gets no gradient).
//
// What bounds both on an H100: device-memory bandwidth. The forward reads
// the input once and writes an eighth of it; the backward reads x and an
// eighth of it twice (y, g) and writes x's size. There is no arithmetic to
// speak of. The TPU kernels' W-duplicated rows, lane rolls and 0/1
// selection-matrix compaction existed only for the TPU's lane layout and
// are not carried over; neither is the TPU backward's W in [48, 512] gate.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ T nan_max(T m, T v) {
  const float fm = as_float(m), fv = as_float(v);
  return (fv > fm || fv != fv) ? v : m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool2x_kernel(const T* __restrict__ x, T* __restrict__ y, long long BC, int D, int H, int W,
              int Do, int Ho, int Wo) {
  const long long n = BC * Do * Ho * Wo;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int wo = int(i % Wo);
  long long t = i / Wo;
  const int ho = int(t % Ho);
  t /= Ho;
  const int dd = int(t % Do);
  const long long bc = t / Do;
  const size_t plane = size_t(H) * W;
  const T* p = x + (size_t(bc) * D + 2 * dd) * plane + size_t(2 * ho) * W + 2 * wo;
  T m = p[0];
  m = nan_max(m, p[1]);
  m = nan_max(m, p[W]);
  m = nan_max(m, p[W + 1]);
  m = nan_max(m, p[plane]);
  m = nan_max(m, p[plane + 1]);
  m = nan_max(m, p[plane + W]);
  m = nan_max(m, p[plane + W + 1]);
  y[i] = m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool2x_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
                  T* __restrict__ dx, long long BC, int D, int H, int W, int Do, int Ho, int Wo) {
  const long long n = BC * Do * Ho * Wo;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int wo = int(i % Wo);
  long long t = i / Wo;
  const int ho = int(t % Ho);
  t /= Ho;
  const int dd = int(t % Do);
  const long long bc = t / Do;
  const size_t plane = size_t(H) * W;
  const size_t base = (size_t(bc) * D + 2 * dd) * plane + size_t(2 * ho) * W + 2 * wo;
  const size_t off[8] = {0, 1, size_t(W), size_t(W) + 1,
                         plane, plane + 1, plane + W, plane + W + 1};
  const float yv = as_float(y[i]);
  float m[8];
  float cnt = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k] = as_float(x[base + off[k]]) == yv ? 1.0f : 0.0f;
    cnt += m[k];
  }
  const float scale = as_float(g[i]) / cnt;
#pragma unroll
  for (int k = 0; k < 8; ++k) dx[base + off[k]] = from_float<T>(m[k] * scale);
}

}  // namespace

MMSEG_API int mmseg_pool2x(const void* x, void* y, int B, int C, int D, int H, int W,
                           void* stream) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const long long n = (long long)B * C * Do * Ho * Wo;
  if (n == 0) return int(cudaSuccess);
  const unsigned blocks = unsigned((n + THREADS - 1) / THREADS);
  pool2x_kernel<bf16><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), (long long)B * C, D, H, W, Do, Ho,
      Wo);
  return int(cudaGetLastError());
}

// The fp32 forward, with the wrapper's descriptor (ops/pool.py:f32_launch_dims:
// one thread per pooled voxel, THREADS a block) checked against the
// kernel's own: another gets cudaErrorInvalidConfiguration and nothing runs.
MMSEG_API int mmseg_pool2x_f32(const void* x, void* y, int B, int C, int D, int H, int W,
                               int blocks, int threads, void* stream) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const long long n = (long long)B * C * Do * Ho * Wo;
  if (threads != THREADS || (long long)blocks != (n + THREADS - 1) / THREADS)
    return int(cudaErrorInvalidConfiguration);
  if (n == 0) return int(cudaSuccess);
  pool2x_kernel<float><<<unsigned(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), (long long)B * C, D, H, W, Do, Ho,
      Wo);
  return int(cudaGetLastError());
}

MMSEG_API int mmseg_pool2x_bwd(const void* x, const void* y, const void* g, void* dx, int B,
                               int C, int D, int H, int W, void* stream) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const long long n = (long long)B * C * Do * Ho * Wo;
  if (n == 0) return int(cudaSuccess);
  const unsigned blocks = unsigned((n + THREADS - 1) / THREADS);
  pool2x_bwd_kernel<bf16><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), (long long)B * C, D, H, W, Do, Ho, Wo);
  return int(cudaGetLastError());
}

// The fp32 backward; blocks and threads as ops/pool.py:f32_launch_dims
// computes them (one thread per pooled voxel), checked as for the fp32
// forward. The wrapper zero-fills dx where an extent is odd.
MMSEG_API int mmseg_pool2x_bwd_f32(const void* x, const void* y, const void* g, void* dx, int B,
                                   int C, int D, int H, int W, int blocks, int threads,
                                   void* stream) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const long long n = (long long)B * C * Do * Ho * Wo;
  if (threads != THREADS || (long long)blocks != (n + THREADS - 1) / THREADS)
    return int(cudaErrorInvalidConfiguration);
  if (n == 0) return int(cudaSuccess);
  pool2x_bwd_kernel<float><<<unsigned(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(g),
      static_cast<float*>(dx), (long long)B * C, D, H, W, Do, Ho, Wo);
  return int(cudaGetLastError());
}
