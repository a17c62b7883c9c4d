// 1x1x1 head: a per-voxel product of channel-first features with a small
// fp32 matrix, in both of the TPU kernel's uses.
//
// Replaces: multimodal_segmentation_project_tpu/ops/head.py _head_kernel:
//   * the forward of head1x1_cf: bf16 features (B, Cin, D, H, W) in, fp32
//     logits out[o] = bias[o] + sum_i x[i] * w[o, i], Co = the classes (at
//     most 8; the model has 4): head1x1_kernel, mmseg_head1x1;
//   * the dx of its backward (_head_bwd_rule): the logits' fp32 cotangent
//     ct (B, NC, D, H, W) in, NC = the classes, and the features' dtype
//     out, dx[f] = bf16(sum_c w[c, f] * ct[c]) for f < Cf (16 on the main
//     path, at most 64), fp32 sums and one rounding, no bias (the TPU
//     kernel's is zero): head1x1_dx_kernel, mmseg_head1x1_dx. w is the
//     head's (NC, Cf) weight as the model holds it.
//
// Forward design: one thread per voxel reads its Cin input values
// (neighbouring threads read neighbouring voxels of the same channel
// plane, so each load instruction of a warp is one contiguous run),
// multiplies them against the (Co, Cin) fp32 weights held in shared
// memory (every thread of a warp reads the same weight: a broadcast),
// keeps Co fp32 sums in registers and writes them as fp32.
//
// dx design: one thread per 8 consecutive voxels of one batch element. It
// loads the NC class planes' 8 values as two 16-byte loads each (NC * 8
// fp32 values in registers, 2 * NC loads in flight a thread), then walks
// the Cf output channels with a runtime loop: per channel one 16-byte
// broadcast read of its NC weights from shared memory, 8 * NC FMAs and
// one 16-byte store of the 8 rounded values (a warp writes 512
// contiguous bytes per channel plane). Where V % 8 != 0 or ct is not
// 16-byte aligned the same thread does 4-byte loads and 2-byte stores,
// each guarded by v < V: the tail and an unaligned view stay in the
// kernel. Registers do not grow with Cf.
//
// What bounds it on an H100: device-memory bandwidth. At 192^3 the forward
// (Cin = 16, Co = 4) reads 226 MB and writes 113 MB for 64 FMAs per voxel;
// the dx (NC = 4, Cf = 16) reads 113 MB and writes 226 MB for 64 FMAs per
// voxel, 0.101 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

constexpr int DX_VOX = 8;       // voxels per thread: two float4 per class plane
constexpr int DX_MAX_CF = 64;   // feature channels (shared memory: 64 x 8 floats)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// NCP: NC rounded up to 4, the pitch of a channel's weights in shared memory.
template <int NC>
__global__ void __launch_bounds__(THREADS)
head1x1_dx_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                  bf16* __restrict__ dx, int Cf, long long V, long long groups, bool vec) {
  constexpr int NCP = (NC + 3) / 4 * 4;
  __shared__ __align__(16) float sw[DX_MAX_CF * NCP];  // [f][c], zero past NC
  for (int i = threadIdx.x; i < Cf * NCP; i += THREADS) {
    const int f = i / NCP, c = i % NCP;
    sw[i] = c < NC ? w[size_t(c) * Cf + f] : 0.0f;
  }
  __syncthreads();

  const long long gi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (gi >= groups) return;
  const long long per_b = (V + DX_VOX - 1) / DX_VOX;
  const long long b = gi / per_b;
  const long long v0 = (gi - b * per_b) * DX_VOX;
  const int n = V - v0 < DX_VOX ? int(V - v0) : DX_VOX;  // voxels of this group
  const float* cp = ct + size_t(b) * NC * V + v0;
  bf16* dp = dx + size_t(b) * Cf * V + v0;

  float xv[NC][DX_VOX];
  if (vec) {  // V % 8 == 0 and ct 16-byte aligned: every group is whole and aligned
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 lo = *reinterpret_cast<const float4*>(cp + size_t(c) * V);
      const float4 hi = *(reinterpret_cast<const float4*>(cp + size_t(c) * V) + 1);
      xv[c][0] = lo.x, xv[c][1] = lo.y, xv[c][2] = lo.z, xv[c][3] = lo.w;
      xv[c][4] = hi.x, xv[c][5] = hi.y, xv[c][6] = hi.z, xv[c][7] = hi.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < DX_VOX; ++j) xv[c][j] = j < n ? cp[size_t(c) * V + j] : 0.0f;
  }

  const float4* sw4 = reinterpret_cast<const float4*>(sw);
  for (int f = 0; f < Cf; ++f) {
    float wf[NCP];
#pragma unroll
    for (int k = 0; k < NCP / 4; ++k) {
      const float4 q = sw4[f * (NCP / 4) + k];
      wf[4 * k] = q.x, wf[4 * k + 1] = q.y, wf[4 * k + 2] = q.z, wf[4 * k + 3] = q.w;
    }
    float s[DX_VOX];
#pragma unroll
    for (int j = 0; j < DX_VOX; ++j) {
      s[j] = xv[0][j] * wf[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) s[j] = fmaf(xv[c][j], wf[c], s[j]);
    }
    bf16* op = dp + size_t(f) * V;
    if (vec) {
      uint4 q;
      q.x = pack_bf16x2(s[0], s[1]);
      q.y = pack_bf16x2(s[2], s[3]);
      q.z = pack_bf16x2(s[4], s[5]);
      q.w = pack_bf16x2(s[6], s[7]);
      *reinterpret_cast<uint4*>(op) = q;
    } else {
#pragma unroll
      for (int j = 0; j < DX_VOX; ++j)
        if (j < n) op[j] = __float2bfloat16(s[j]);
    }
  }
}

template <int NC>
int launch_dx(const void* ct, const void* w, void* dx, int B, int Cf, long long V,
              cudaStream_t stream) {
  const long long groups = B * ((V + DX_VOX - 1) / DX_VOX);
  const bool vec = V % DX_VOX == 0 && (reinterpret_cast<uintptr_t>(ct) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  head1x1_dx_kernel<NC><<<unsigned((groups + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(ct), static_cast<const float*>(w), static_cast<bf16*>(dx), Cf,
      V, groups, vec);
  return int(cudaGetLastError());
}

}  // namespace

MMSEG_API int mmseg_head1x1(const void* x, const void* w, const void* bias, void* out, int B,
                            int Cin, int Co, long long V, void* stream) {
  constexpr int MAX_CO = 8;
  if (Co < 1 || Co > MAX_CO) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  dim3 grid(unsigned((V + THREADS - 1) / THREADS), B);
  const size_t smem = size_t(Co) * Cin * sizeof(float);
  head1x1_kernel<bf16, float, MAX_CO><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), Cin, Co, V);
  return int(cudaGetLastError());
}

// dx (B, Cf, V) bf16 from ct (B, NC, V) fp32 and w (NC, Cf) fp32; NC 1..8,
// Cf 1..64.
MMSEG_API int mmseg_head1x1_dx(const void* ct, const void* w, void* dx, int B, int NC, int Cf,
                               long long V, void* stream) {
  if (Cf < 1 || Cf > DX_MAX_CF) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NC) {
    case 1: return launch_dx<1>(ct, w, dx, B, Cf, V, s);
    case 2: return launch_dx<2>(ct, w, dx, B, Cf, V, s);
    case 3: return launch_dx<3>(ct, w, dx, B, Cf, V, s);
    case 4: return launch_dx<4>(ct, w, dx, B, Cf, V, s);
    case 5: return launch_dx<5>(ct, w, dx, B, Cf, V, s);
    case 6: return launch_dx<6>(ct, w, dx, B, Cf, V, s);
    case 7: return launch_dx<7>(ct, w, dx, B, Cf, V, s);
    case 8: return launch_dx<8>(ct, w, dx, B, Cf, V, s);
    default: return int(cudaErrorInvalidValue);
  }
}
