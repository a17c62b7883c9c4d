// 1x1x1 head: a per-voxel product of channel-first features (B, Cin, D, H, W)
// with a (Co, Cin) matrix, out[o] = bias[o] + sum_i x[i] * w[o, i], in fp32.
//
// Replaces: multimodal_segmentation_project_tpu/ops/head.py _head_kernel,
// in both of its uses:
//   * the forward of head1x1_cf: bf16 features in, fp32 logits out, Co = the
//     classes (at most 8; the model has 4): mmseg_head1x1;
//   * the dx of its backward (_head_bwd_rule): the fp32 logits' cotangent
//     in (Cin = the classes), the transposed weights, a zero bias, and the
//     features' dtype out, bf16, Co = features[0] (16, at most 64):
//     mmseg_head1x1_dx.
//
// Design: one thread per voxel reads its Cin input values (neighbouring
// threads read neighbouring voxels of the same channel plane, so each load
// instruction of a warp is one contiguous run), multiplies them against the
// (Co, Cin) fp32 weights held in shared memory (every thread of a warp
// reads the same weight: a broadcast), keeps Co fp32 sums in registers and
// writes them, rounded once to the output type.
//
// What bounds it on an H100: device-memory bandwidth. At 192^3 the forward
// (Cin = 16, Co = 4) reads 226 MB and writes 113 MB for 64 FMAs per voxel;
// the dx (Cin = 4, Co = 16) reads 113 MB and writes 226 MB.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename TIn, typename TOut, int MAX_CO>
__global__ void __launch_bounds__(THREADS)
head1x1_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, TOut* __restrict__ out, int Cin, int Co,
               long long V) {
  extern __shared__ float sw[];  // (Co, Cin)
  for (int i = threadIdx.x; i < Co * Cin; i += THREADS) sw[i] = w[i];
  __syncthreads();

  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= V) return;
  const int b = blockIdx.y;
  const TIn* xp = x + size_t(b) * Cin * V + v;

  float acc[MAX_CO];
#pragma unroll
  for (int o = 0; o < MAX_CO; ++o) acc[o] = o < Co ? bias[o] : 0.0f;
  for (int i = 0; i < Cin; ++i) {
    const float xv = to_f32(xp[size_t(i) * V]);
#pragma unroll
    for (int o = 0; o < MAX_CO; ++o)
      if (o < Co) acc[o] = fmaf(xv, sw[o * Cin + i], acc[o]);
  }
  TOut* op = out + size_t(b) * Co * V + v;
#pragma unroll
  for (int o = 0; o < MAX_CO; ++o)
    if (o < Co) store(op + size_t(o) * V, acc[o]);
}

template <typename TIn, typename TOut, int MAX_CO>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int Cin, int Co,
           long long V, void* stream) {
  if (Co < 1 || Co > MAX_CO) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  dim3 grid(unsigned((V + THREADS - 1) / THREADS), B);
  const size_t smem = size_t(Co) * Cin * sizeof(float);
  head1x1_kernel<TIn, TOut, MAX_CO><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<TOut*>(out), Cin, Co, V);
  return int(cudaGetLastError());
}

}  // namespace

MMSEG_API int mmseg_head1x1(const void* x, const void* w, const void* bias, void* out, int B,
                            int Cin, int Co, long long V, void* stream) {
  return launch<bf16, float, 8>(x, w, bias, out, B, Cin, Co, V, stream);
}

MMSEG_API int mmseg_head1x1_dx(const void* ct, const void* w, const void* bias, void* dx, int B,
                               int Cin, int Co, long long V, void* stream) {
  return launch<float, bf16, 64>(ct, w, bias, dx, B, Cin, Co, V, stream);
}
