// 1x1x1 segmentation head: bf16 features (B, Cin, D, H, W) -> fp32 logits
// (B, Co, D, H, W), logits[o] = bias[o] + sum_i x[i] * w[o, i].
//
// Replaces: multimodal_segmentation_project_tpu/ops/head.py _head_kernel
//   (public op head1x1_cf, forward).
//
// Design: one thread per voxel reads its Cin bf16 values (neighbouring
// threads read neighbouring voxels of the same channel plane, so each load
// instruction of a warp is one contiguous 64-byte run), multiplies them
// against the (Co, Cin) fp32 weights held in shared memory (every thread
// of a warp reads the same weight: a broadcast) and writes Co fp32 logits.
// At most 8 classes (the model has 4).
//
// What bounds it on an H100: device-memory bandwidth. At 192^3 with Cin =
// 16 and Co = 4 it reads 226 MB and writes 113 MB for 64 FMAs per voxel.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CO = 8;

__global__ void __launch_bounds__(THREADS)
head1x1_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int Cin, int Co,
               long long V) {
  extern __shared__ float sw[];  // (Co, Cin)
  for (int i = threadIdx.x; i < Co * Cin; i += THREADS) sw[i] = w[i];
  __syncthreads();

  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= V) return;
  const int b = blockIdx.y;
  const bf16* xp = x + size_t(b) * Cin * V + v;

  float acc[MAX_CO];
#pragma unroll
  for (int o = 0; o < MAX_CO; ++o) acc[o] = o < Co ? bias[o] : 0.0f;
  for (int i = 0; i < Cin; ++i) {
    const float xv = __bfloat162float(xp[size_t(i) * V]);
#pragma unroll
    for (int o = 0; o < MAX_CO; ++o)
      if (o < Co) acc[o] = fmaf(xv, sw[o * Cin + i], acc[o]);
  }
  float* op = out + size_t(b) * Co * V + v;
#pragma unroll
  for (int o = 0; o < MAX_CO; ++o)
    if (o < Co) op[size_t(o) * V] = acc[o];
}

}  // namespace

MMSEG_API int mmseg_head1x1(const void* x, const void* w, const void* bias, void* out, int B,
                            int Cin, int Co, long long V, void* stream) {
  if (Co < 1 || Co > MAX_CO) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  dim3 grid(unsigned((V + THREADS - 1) / THREADS), B);
  const size_t smem = size_t(Co) * Cin * sizeof(float);
  head1x1_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), Cin, Co, V);
  return int(cudaGetLastError());
}
