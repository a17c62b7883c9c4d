// 2x2x2 stride-2 transpose convolution (ConvTranspose3d, kernel == stride)
// on channel-first bf16 volumes, written straight into depth-to-space order:
//
//   out[b, o, 2d+a, 2h+p, 2w+q] = bias[o] + sum_i x[b, i, d, h, w] * K[a, p, q, i, o]
//
// with fp32 products and sums, the fp32 bias added last, and one rounding
// to bf16, as the TPU kernel rounds.
//
// Replaces: multimodal_segmentation_project_tpu/ops/upconv.py _d2s_kernel
//   (public op upconv2x_cf, forward).
//
// Layout: x (B, Cin, D, H, W) bf16, K (2, 2, 2, Cin, Cout) bf16 (the JAX
// kernel layout, [phase][i][o]), bias (Cout,) fp32, out (B, Cout, 2D, 2H,
// 2W) bf16, all contiguous.
//
// Design: one thread per output voxel and per group of 16 output channels
// (grid y). The thread's phase (a, p, q) picks its 16-channel weight slice;
// neighbouring threads are neighbouring output columns, so input reads are
// shared by pairs of threads and output writes are contiguous. The weights
// of the block's channel group are staged in shared memory as fp32 in
// chunks of 64 input channels (8 * 64 * 16 * 4 B = 32 KB), which bounds
// shared memory for any Cin (the widest kernel-path upconv, 128 -> 64 at
// 24^3, has 8 * 128 * 64 weights). The TPU kernel's W-duplicated input,
// its parity selects and its W <= 128 gate are TPU layout work and are not
// carried over.
//
// What bounds it on an H100: at the full-resolution level (32 -> 16,
// 96^3 -> 192^3) the write of the 226 MB output and 16 scalar FMAs per
// input channel per thread on the CUDA cores; there is no tensor-core use.
#include "common.cuh"

namespace {

constexpr int OG = 16;        // output channels per thread (and per block)
constexpr int CKU = 64;       // input channels per staged weight chunk
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
upconv_d2s_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                  const float* __restrict__ bias, bf16* __restrict__ out, int Cin, int Cout,
                  int D, int H, int W) {
  __shared__ __align__(16) float ws[8 * CKU * OG];

  const int H2 = 2 * H, W2 = 2 * W;
  const long long nvox = 8LL * D * H * W;
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = v < nvox;
  const int og0 = blockIdx.y * OG;
  const int b = blockIdx.z;

  int ow = 0, oh = 0, od = 0;
  if (active) {
    ow = int(v % W2);
    const long long t = v / W2;
    oh = int(t % H2);
    od = int(t / H2);
  }
  const int phase = ((od & 1) * 2 + (oh & 1)) * 2 + (ow & 1);
  const size_t in_plane = size_t(H) * W;
  const size_t in_vol = in_plane * D;
  const bf16* xp = x + size_t(b) * Cin * in_vol + size_t(od >> 1) * in_plane +
                   size_t(oh >> 1) * W + (ow >> 1);

  float acc[OG];
#pragma unroll
  for (int o = 0; o < OG; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CKU) {
    const int nc = min(CKU, Cin - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < 8 * CKU * OG; i += THREADS) {
      const int o = i % OG;
      const int r = i / OG;
      const int ci = r % CKU;
      const int ph = r / CKU;
      float val = 0.0f;
      if (ci < nc && og0 + o < Cout)
        val = __bfloat162float(k[(size_t(ph) * Cin + c0 + ci) * Cout + og0 + o]);
      ws[i] = val;
    }
    __syncthreads();
    if (active) {
      const float4* wp = reinterpret_cast<const float4*>(ws + phase * CKU * OG);
      for (int ci = 0; ci < nc; ++ci) {
        const float xv = __bfloat162float(xp[size_t(c0 + ci) * in_vol]);
#pragma unroll
        for (int j = 0; j < OG / 4; ++j) {
          const float4 q = wp[ci * (OG / 4) + j];
          acc[4 * j + 0] = fmaf(xv, q.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(xv, q.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv, q.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv, q.w, acc[4 * j + 3]);
        }
      }
    }
  }

  if (!active) return;
  const size_t out_plane = size_t(H2) * W2;
  const size_t out_vol = out_plane * 2 * D;
  bf16* op = out + size_t(b) * Cout * out_vol + size_t(od) * out_plane + size_t(oh) * W2 + ow;
#pragma unroll
  for (int o = 0; o < OG; ++o)
    if (og0 + o < Cout) op[size_t(og0 + o) * out_vol] = __float2bfloat16(acc[o] + bias[og0 + o]);
}

}  // namespace

MMSEG_API int mmseg_upconv_d2s(const void* x, const void* k, const void* bias, void* out, int B,
                               int Cin, int Cout, int D, int H, int W, void* stream) {
  const long long nvox = 8LL * D * H * W;
  if (nvox == 0) return int(cudaSuccess);
  dim3 grid(unsigned((nvox + THREADS - 1) / THREADS), unsigned((Cout + OG - 1) / OG), B);
  upconv_d2s_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k), static_cast<const float*>(bias),
      static_cast<bf16*>(out), Cin, Cout, D, H, W);
  return int(cudaGetLastError());
}
