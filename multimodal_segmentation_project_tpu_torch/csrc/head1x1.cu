// 1x1x1 head: a per-voxel product of channel-first features with a small
// fp32 matrix, in both of the TPU kernel's uses, and the head's weight
// gradient.
//
// Replaces: multimodal_segmentation_project_tpu/ops/head.py _head_kernel:
//   * the forward of head1x1_cf: bf16 features (B, Cin, D, H, W) in, fp32
//     logits out[o] = bias[o] + sum_i x[i] * w[o, i], Co = the classes (at
//     most 8; the model has 4): head1x1_kernel<bf16, CO>, mmseg_head1x1;
//     and its fp32 instance, fp32 features in (the JAX package's fp32
//     policy, whose head kernel reads x's dtype): head1x1_kernel<float,
//     CO>, mmseg_head1x1_f32;
//   * the dx of its backward (_head_bwd_rule): the logits' fp32 cotangent
//     ct (B, NC, D, H, W) in, NC = the classes, and the features' dtype
//     out, dx[f] = bf16(sum_c w[c, f] * ct[c]) for f < Cf (16 on the main
//     path, at most 64), fp32 sums and one rounding, no bias (the TPU
//     kernel's is zero): head1x1_dx_kernel<bf16, NC>, mmseg_head1x1_dx; and
//     its fp32 instance for fp32 features (the fp32 policy's train step,
//     no rounding): head1x1_dx_kernel<float, NC>, mmseg_head1x1_dx_f32. w
//     is the head's (NC, Cf) weight as the model holds it.
// and the XLA work of the same backward (ops/head.py, _head_bwd_rule's
// dot_general and sum), which has no Pallas kernel:
//   * dk[f, c] = sum_{b,v} x[b, f, v] * ct[b, c, v] and db[c] = sum_{b,v}
//     ct[b, c, v] in fp32, from the features the forward saved and the
//     fp32 cotangent: head1x1_dw_kernel<T, ..>, head1x1_dw_reduce_kernel;
//     bf16 features (mmseg_head1x1_dw) or fp32 ones (mmseg_head1x1_dw_f32).
//
// Forward design: one thread per 8 consecutive voxels of one batch
// element. It walks the Cin channel planes FWD_UNROLL at a time, one
// 16-byte load (8 bf16; two 16-byte loads of 8 fp32) per plane, so
// FWD_UNROLL planes' loads are in flight a thread (neighbouring threads
// read neighbouring 16 bytes: a warp reads 512 contiguous bytes per plane,
// 1 KB in fp32). Per channel one 16-byte broadcast read
// (two where Co > 4) of its Co weights from a [Cin][Co rounded up to 4]
// shared table, zero past Co, and 8 * Co FMAs into Co x 8 fp32
// accumulators; the sum starts at the bias and adds the channels in order
// i = 0..Cin-1. Then two 16-byte fp32 stores per class plane (a warp
// writes 1 KB contiguous per class).
//
// dx design: one thread per 8 consecutive voxels of one batch element. It
// loads the NC class planes' 8 values as two 16-byte loads each (NC * 8
// fp32 values in registers, 2 * NC loads in flight a thread), then walks
// the Cf output channels with a runtime loop: per channel one 16-byte
// broadcast read of its NC weights from shared memory, 8 * NC FMAs and
// one 16-byte store of the 8 rounded values (fp32: two 16-byte stores; a
// warp writes 512 contiguous bytes per channel plane, 1 KB in fp32).
// Registers do not grow with Cf.
//
// Weight-gradient design: a fixed grid of nblk blocks (the wrapper picks
// nblk, one a SM, from the SM count and the volume alone) times one block
// row per slice of dw_slice<T>(NC) feature channels. Thread t of block k
// walks the 8-voxel groups t + 256 k, t + 256 (k + nblk), ... of the
// flattened (batch, volume): per group two 16-byte loads per class plane
// of ct and one per feature plane of x (two in fp32), and fp32 partials of
// dk over its slice (slice * NC values) and of db in registers. The block
// then sums its threads' partials in a fixed order (a shuffle tree per
// warp, the warps in order) into its row of a [nblk][Cf * NC + NC] fp32
// scratch, and a second launch sums the rows in block order. No atomics:
// the same bits every run on one card.
//
// Tail and alignment: where V % 8 != 0 or a volume's pointer is not 16-byte
// aligned, the same threads do guarded 2- or 4-byte loads and stores
// (zero past the volume; for the weight gradient in a second instance of
// its kernel): the tail and an unaligned view stay in the kernels.
//
// What bounds them on an H100: device-memory bandwidth. At 192^3 the forward
// (Cin = 16, Co = 4) reads 226 MB (fp32: 453 MB) and writes 113 MB for 64
// FMAs per voxel;
// the dx (NC = 4, Cf = 16) reads 113 MB and writes 226 MB; the weight
// gradient reads both, 339 MB, for 68 FMAs and adds per voxel: each 0.101
// ms at 3.35 TB/s. In fp32 the dx writes and the weight gradient reads 453
// MB of features: 0.169 ms each.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int VOX = 8;          // voxels per thread: 16 bytes of bf16, 32 of fp32
constexpr int FWD_UNROLL = 8;   // forward: channel planes loaded at once
constexpr int DX_MAX_CF = 64;   // feature channels (dx's shared table: 64 x 8 floats)

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 8 bf16 of one plane as raw bits; zero past the n >= 1 valid voxels. VEC:
// the 8 are whole and 16-byte aligned. Otherwise 2-byte loads, each from
// a voxel inside the volume and then selected (no branches, so the
// compiler keeps each plane's loads together).
template <bool VEC>
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, int n) {
  if (VEC) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint32_t h[VOX];
#pragma unroll
  for (int j = 0; j < VOX; ++j) {
    const uint32_t v = s[j < n ? j : n - 1];
    h[j] = j < n ? v : 0u;
  }
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}

__device__ __forceinline__ void unpack8_bf16(uint4 q, float v[VOX]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// 8 fp32 of one plane; zero past the n >= 1 valid voxels (4-byte loads
// selected as load8_bf16's).
template <bool VEC>
__device__ __forceinline__ void load8_f32(const float* p, int n, float v[VOX]) {
  if (VEC) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < VOX; ++j) {
      const float t = p[j < n ? j : n - 1];
      v[j] = j < n ? t : 0.0f;
    }
  }
}

// 8 voxels of one feature plane as loaded, and as fp32 values: the forward
// keeps FWD_UNROLL planes of these in flight before it converts them.
template <typename T>
struct Vox8;

template <>
struct Vox8<bf16> {
  uint4 q;
  template <bool VEC>
  __device__ __forceinline__ void load(const bf16* p, int n) { q = load8_bf16<VEC>(p, n); }
  __device__ __forceinline__ void unpack(float v[VOX]) const { unpack8_bf16(q, v); }
};

template <>
struct Vox8<float> {
  float f[VOX];
  template <bool VEC>
  __device__ __forceinline__ void load(const float* p, int n) { load8_f32<VEC>(p, n, f); }
  __device__ __forceinline__ void unpack(float v[VOX]) const {
#pragma unroll
    for (int j = 0; j < VOX; ++j) v[j] = f[j];
  }
};

// The group gi of 8 voxels: its batch element, first voxel and voxel count.
struct Group {
  long long b, v0;
  int n;
};

__device__ __forceinline__ Group group_of(long long gi, long long V) {
  const long long per_b = (V + VOX - 1) / VOX;
  Group g;
  g.b = gi / per_b;
  g.v0 = (gi - g.b * per_b) * VOX;
  g.n = V - g.v0 < VOX ? int(V - g.v0) : VOX;
  return g;
}

// One channel plane of the forward: acc[o][j] += x[j] * w[o] for o < CO.
template <typename T, int CO>
__device__ __forceinline__ void fwd_channel(float (&acc)[CO][VOX], const Vox8<T>& q,
                                            const float4* wrow) {
  constexpr int COP = (CO + 3) / 4 * 4;
  float wv[COP];
#pragma unroll
  for (int k = 0; k < COP / 4; ++k) {
    const float4 t = wrow[k];
    wv[4 * k] = t.x, wv[4 * k + 1] = t.y, wv[4 * k + 2] = t.z, wv[4 * k + 3] = t.w;
  }
  float xv[VOX];
  q.unpack(xv);
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int j = 0; j < VOX; ++j) acc[o][j] = fmaf(xv[j], wv[o], acc[o][j]);
}

// The forward's sums of one group, onto the bias: the Cin channels in order.
template <typename T, int CO, bool VEC>
__device__ __forceinline__ void fwd_group(float (&acc)[CO][VOX], const T* xp,
                                          const float4* sw4, int Cin, long long V, int n) {
  constexpr int COP = (CO + 3) / 4 * 4;
  int i = 0;
  for (; i + FWD_UNROLL <= Cin; i += FWD_UNROLL) {
    Vox8<T> q[FWD_UNROLL];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) q[u].template load<VEC>(xp + size_t(i + u) * V, n);
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u)
      fwd_channel<T, CO>(acc, q[u], sw4 + (i + u) * (COP / 4));
  }
  for (; i < Cin; ++i) {
    Vox8<T> q;
    q.template load<VEC>(xp + size_t(i) * V, n);
    fwd_channel<T, CO>(acc, q, sw4 + i * (COP / 4));
  }
}

// T the features' type, CO classes; COP = CO rounded up to 4, the pitch of
// a channel's weights.
template <typename T, int CO>
__global__ void __launch_bounds__(THREADS)
head1x1_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int Cin, long long V,
               long long groups, bool vec) {
  constexpr int COP = (CO + 3) / 4 * 4;
  extern __shared__ float4 sw4[];  // [Cin][COP / 4]: channel i's weights, zero past CO
  float* sw = reinterpret_cast<float*>(sw4);
  for (int i = threadIdx.x; i < Cin * COP; i += THREADS) {
    const int ci = i / COP, o = i % COP;
    sw[i] = o < CO ? w[size_t(o) * Cin + ci] : 0.0f;
  }
  __syncthreads();

  const long long gi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (gi >= groups) return;
  const Group g = group_of(gi, V);
  const T* xp = x + size_t(g.b) * Cin * V + g.v0;

  float acc[CO][VOX];
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int j = 0; j < VOX; ++j) acc[o][j] = bias[o];
  if (vec)
    fwd_group<T, CO, true>(acc, xp, sw4, Cin, V, g.n);
  else
    fwd_group<T, CO, false>(acc, xp, sw4, Cin, V, g.n);

  float* op = out + size_t(g.b) * CO * V + g.v0;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    float* p = op + size_t(o) * V;
    if (vec) {
      reinterpret_cast<float4*>(p)[0] = make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(acc[o][4], acc[o][5], acc[o][6], acc[o][7]);
    } else {
#pragma unroll
      for (int j = 0; j < VOX; ++j)
        if (j < g.n) p[j] = acc[o][j];
    }
  }
}

// The forward's launch: blocks of THREADS groups, the [Cin][COP] weight
// table as dynamic shared memory. Where the wrapper gives its descriptor
// (blocks >= 0: the fp32 entry), it must be this one, or the launch is
// refused with cudaErrorInvalidConfiguration.
template <typename T, int CO>
int launch_fwd(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
               long long V, long long blocks, int threads, int smem_given, cudaStream_t stream) {
  constexpr int COP = (CO + 3) / 4 * 4;
  const size_t smem = size_t(Cin) * COP * sizeof(float);
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  const long long groups = B * ((V + VOX - 1) / VOX);
  const long long nblk = (groups + THREADS - 1) / THREADS;
  if (blocks >= 0 && (blocks != nblk || threads != THREADS || size_t(smem_given) != smem))
    return int(cudaErrorInvalidConfiguration);
  const bool vec = V % VOX == 0 && aligned16(x) && aligned16(out);
  head1x1_kernel<T, CO><<<unsigned(nblk), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), Cin, V, groups, vec);
  return int(cudaGetLastError());
}

template <typename T>
int forward(const void* x, const void* w, const void* bias, void* out, int B, int Cin, int Co,
            long long V, long long blocks, int threads, int smem, cudaStream_t s) {
  switch (Co) {
    case 1: return launch_fwd<T, 1>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 2: return launch_fwd<T, 2>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 3: return launch_fwd<T, 3>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 4: return launch_fwd<T, 4>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 5: return launch_fwd<T, 5>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 6: return launch_fwd<T, 6>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 7: return launch_fwd<T, 7>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    case 8: return launch_fwd<T, 8>(x, w, bias, out, B, Cin, V, blocks, threads, smem, s);
    default: return int(cudaErrorInvalidValue);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// NCP: NC rounded up to 4, the pitch of a channel's weights in shared
// memory; T the features' type, which dx is written in.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
head1x1_dx_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                  T* __restrict__ dx, int Cf, long long V, long long groups, bool vec) {
  constexpr int NCP = (NC + 3) / 4 * 4;
  __shared__ __align__(16) float sw[DX_MAX_CF * NCP];  // [f][c], zero past NC
  for (int i = threadIdx.x; i < Cf * NCP; i += THREADS) {
    const int f = i / NCP, c = i % NCP;
    sw[i] = c < NC ? w[size_t(c) * Cf + f] : 0.0f;
  }
  __syncthreads();

  const long long gi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (gi >= groups) return;
  const Group g = group_of(gi, V);
  const float* cp = ct + size_t(g.b) * NC * V + g.v0;
  T* dp = dx + size_t(g.b) * Cf * V + g.v0;

  float xv[NC][VOX];
  if (vec) {
#pragma unroll
    for (int c = 0; c < NC; ++c) load8_f32<true>(cp + size_t(c) * V, g.n, xv[c]);
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) load8_f32<false>(cp + size_t(c) * V, g.n, xv[c]);
  }

  const float4* sw4 = reinterpret_cast<const float4*>(sw);
  for (int f = 0; f < Cf; ++f) {
    float wf[NCP];
#pragma unroll
    for (int k = 0; k < NCP / 4; ++k) {
      const float4 q = sw4[f * (NCP / 4) + k];
      wf[4 * k] = q.x, wf[4 * k + 1] = q.y, wf[4 * k + 2] = q.z, wf[4 * k + 3] = q.w;
    }
    float s[VOX];
#pragma unroll
    for (int j = 0; j < VOX; ++j) {
      s[j] = xv[0][j] * wf[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) s[j] = fmaf(xv[c][j], wf[c], s[j]);
    }
    T* op = dp + size_t(f) * V;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        reinterpret_cast<float4*>(op)[0] = make_float4(s[0], s[1], s[2], s[3]);
        reinterpret_cast<float4*>(op)[1] = make_float4(s[4], s[5], s[6], s[7]);
      } else {
#pragma unroll
        for (int j = 0; j < VOX; ++j)
          if (j < g.n) op[j] = s[j];
      }
    } else if (vec) {
      uint4 q;
      q.x = pack_bf16x2(s[0], s[1]);
      q.y = pack_bf16x2(s[2], s[3]);
      q.z = pack_bf16x2(s[4], s[5]);
      q.w = pack_bf16x2(s[6], s[7]);
      *reinterpret_cast<uint4*>(op) = q;
    } else {
#pragma unroll
      for (int j = 0; j < VOX; ++j)
        if (j < g.n) op[j] = __float2bfloat16(s[j]);
    }
  }
}

// The dx's launch: blocks of THREADS groups. Where the wrapper gives its
// descriptor (blocks >= 0: the fp32 entry), it must be this one, or the
// launch is refused with cudaErrorInvalidConfiguration.
template <typename T, int NC>
int launch_dx(const void* ct, const void* w, void* dx, int B, int Cf, long long V,
              long long blocks, int threads, cudaStream_t stream) {
  const long long groups = B * ((V + VOX - 1) / VOX);
  const long long nblk = (groups + THREADS - 1) / THREADS;
  if (blocks >= 0 && (blocks != nblk || threads != THREADS))
    return int(cudaErrorInvalidConfiguration);
  const bool vec = V % VOX == 0 && aligned16(ct) && aligned16(dx);
  head1x1_dx_kernel<T, NC><<<unsigned(nblk), THREADS, 0, stream>>>(
      static_cast<const float*>(ct), static_cast<const float*>(w), static_cast<T*>(dx), Cf, V,
      groups, vec);
  return int(cudaGetLastError());
}

template <typename T>
int dx_by_classes(const void* ct, const void* w, void* dx, int B, int NC, int Cf, long long V,
                  long long blocks, int threads, cudaStream_t s) {
  switch (NC) {
    case 1: return launch_dx<T, 1>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 2: return launch_dx<T, 2>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 3: return launch_dx<T, 3>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 4: return launch_dx<T, 4>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 5: return launch_dx<T, 5>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 6: return launch_dx<T, 6>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 7: return launch_dx<T, 7>(ct, w, dx, B, Cf, V, blocks, threads, s);
    case 8: return launch_dx<T, 8>(ct, w, dx, B, Cf, V, blocks, threads, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// Feature channels per slice of the weight gradient on bf16 features, by
// the number of classes: slice * NC dk partials, NC db partials, the
// group's NC * 8 cotangent values and the slice's x loads in flight fit
// 255 registers without spilling.
__host__ __device__ constexpr int dw_slice_bf16(int nc) { return nc <= 4 ? 16 : nc <= 6 ? 8 : 4; }
// fp32 features take twice the registers a load, so half the slice (at 16
// channels the guarded instance spilled).
template <typename T>
__host__ __device__ constexpr int dw_slice(int nc) {
  return dw_slice_bf16(nc) / int(sizeof(T) / 2);
}

constexpr int WARPS = THREADS / 32;
// One block a SM: ptxas then keeps a group's 2 * NC + slice 16-byte loads in
// flight a thread (168-255 registers). Capped at 128 for two blocks a SM
// it spilled, and the kernel ran slower.
constexpr int DW_BLOCKS_PER_SM = 1;

// One group's terms of a thread's weight-gradient partials: acc[f * NC + c]
// += x[f0 + f] . ct[c] over the group's 8 voxels for the FS channels of the
// slice, acc[FS * NC + c] += the sum of ct[c].
template <typename T, int NC, int FS, bool VEC>
__device__ __forceinline__ void dw_group(float (&acc)[FS * NC + NC], const float* cp,
                                         const T* xp, int f0, int Cf, long long V, int n) {
  float cv[NC][VOX];
#pragma unroll
  for (int c = 0; c < NC; ++c) load8_f32<VEC>(cp + size_t(c) * V, n, cv[c]);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < VOX; ++j) acc[FS * NC + c] += cv[c][j];
  const T* p = xp + size_t(f0) * V;
#pragma unroll
  for (int f = 0; f < FS; ++f) {
    Vox8<T> q;
    q.template load<VEC>(p, n);
    float xv[VOX];
    q.unpack(xv);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < VOX; ++j) acc[f * NC + c] = fmaf(xv[j], cv[c][j], acc[f * NC + c]);
    // past Cf the last channel is read again (an L1 hit) and never stored
    if (f0 + f + 1 < Cf) p += V;
  }
}

// Block (k, s): the slice s of feature channels, the groups k, k + nblk, ...
// (in units of THREADS groups); its row k of part holds, after all slices
// ran, dk (f-major, Cf * NC) then db (NC). T the features' type; VEC (V % 8
// == 0, x and ct 16-byte aligned) and the guarded loads are separate
// instances.
template <typename T, int NC, bool VEC>
__global__ void __launch_bounds__(THREADS, DW_BLOCKS_PER_SM)
head1x1_dw_kernel(const T* __restrict__ x, const float* __restrict__ ct,
                  float* __restrict__ part, int Cf, long long V, long long groups) {
  constexpr int FS = dw_slice<T>(NC);
  constexpr int NP = FS * NC + NC;  // a thread's partials: dk over the slice, then db
  __shared__ float red[WARPS][NP];
  const int f0 = blockIdx.y * FS;

  float acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.0f;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long gi = (long long)blockIdx.x * THREADS + threadIdx.x; gi < groups; gi += stride) {
    const Group g = group_of(gi, V);
    const float* cp = ct + size_t(g.b) * NC * V + g.v0;
    const T* xp = x + size_t(g.b) * Cf * V + g.v0;
    dw_group<T, NC, FS, VEC>(acc, cp, xp, f0, Cf, V, g.n);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  const int E = Cf * NC + NC;
  float* row = part + size_t(blockIdx.x) * E;
  for (int k = threadIdx.x; k < NP; k += THREADS) {
    const bool db = k >= FS * NC;
    if (db ? blockIdx.y != 0 : f0 + k / NC >= Cf) continue;
    float s = red[0][k];
    for (int w = 1; w < WARPS; ++w) s += red[w][k];
    row[db ? Cf * NC + (k - FS * NC) : f0 * NC + k] = s;
  }
}

// dk and db: entry e of the rows summed in block order.
__global__ void __launch_bounds__(THREADS)
head1x1_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dk,
                         float* __restrict__ db, int CfNC, int E, int nblk) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  float s = part[e];
  for (int k = 1; k < nblk; ++k) s += part[size_t(k) * E + e];
  if (e < CfNC)
    dk[e] = s;
  else
    db[e - CfNC] = s;
}

// The weight gradient's launch. Where the wrapper gives its descriptor
// (slices >= 0: the fp32 entry), its slices of feature channels and
// threads must be this kernel's, or the launch is refused with
// cudaErrorInvalidConfiguration.
template <typename T, int NC>
int launch_dw(const void* x, const void* ct, void* part, void* dk, void* db, int B, int Cf,
              long long V, int nblk, int slices, int threads, cudaStream_t stream) {
  constexpr int FS = dw_slice<T>(NC);
  if (slices >= 0 && (slices != (Cf + FS - 1) / FS || threads != THREADS))
    return int(cudaErrorInvalidConfiguration);
  const long long groups = B * ((V + VOX - 1) / VOX);
  const bool vec = V % VOX == 0 && aligned16(x) && aligned16(ct);
  const dim3 grid(unsigned(nblk), unsigned((Cf + FS - 1) / FS));
  const T* xt = static_cast<const T*>(x);
  const float* cf = static_cast<const float*>(ct);
  float* pf = static_cast<float*>(part);
  if (vec)
    head1x1_dw_kernel<T, NC, true><<<grid, THREADS, 0, stream>>>(xt, cf, pf, Cf, V, groups);
  else
    head1x1_dw_kernel<T, NC, false><<<grid, THREADS, 0, stream>>>(xt, cf, pf, Cf, V, groups);
  const int E = Cf * NC + NC;
  head1x1_dw_reduce_kernel<<<(E + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dk), static_cast<float*>(db), Cf * NC,
      E, nblk);
  return int(cudaGetLastError());
}

template <typename T>
int dw_by_classes(const void* x, const void* ct, void* part, void* dk, void* db, int B, int Cf,
                  int NC, long long V, int nblk, int slices, int threads, cudaStream_t s) {
  switch (NC) {
    case 1: return launch_dw<T, 1>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 2: return launch_dw<T, 2>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 3: return launch_dw<T, 3>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 4: return launch_dw<T, 4>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 5: return launch_dw<T, 5>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 6: return launch_dw<T, 6>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 7: return launch_dw<T, 7>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    case 8: return launch_dw<T, 8>(x, ct, part, dk, db, B, Cf, V, nblk, slices, threads, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (B, Co, V) fp32 from x (B, Cin, V) bf16, w (Co, Cin) fp32 and bias
// (Co,) fp32; Co 1..8, Cin * (Co rounded up to 4) * 4 bytes <= 48 KB.
MMSEG_API int mmseg_head1x1(const void* x, const void* w, const void* bias, void* out, int B,
                            int Cin, int Co, long long V, void* stream) {
  if (Cin < 1) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  return forward<bf16>(x, w, bias, out, B, Cin, Co, V, -1, 0, 0,
                       static_cast<cudaStream_t>(stream));
}

// The same from fp32 features x (B, Cin, V); blocks, threads and smem as
// ops/head.py:f32_launch_dims computes them.
MMSEG_API int mmseg_head1x1_f32(const void* x, const void* w, const void* bias, void* out,
                                int B, int Cin, int Co, long long V, long long blocks,
                                int threads, int smem, void* stream) {
  if (Cin < 1 || blocks < 0) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  return forward<float>(x, w, bias, out, B, Cin, Co, V, blocks, threads, smem,
                        static_cast<cudaStream_t>(stream));
}

// dx (B, Cf, V) bf16 from ct (B, NC, V) fp32 and w (NC, Cf) fp32; NC 1..8,
// Cf 1..64.
MMSEG_API int mmseg_head1x1_dx(const void* ct, const void* w, void* dx, int B, int NC, int Cf,
                               long long V, void* stream) {
  if (Cf < 1 || Cf > DX_MAX_CF) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  return dx_by_classes<bf16>(ct, w, dx, B, NC, Cf, V, -1, 0, static_cast<cudaStream_t>(stream));
}

// The same with dx (B, Cf, V) in fp32 (fp32 features); blocks and threads as
// ops/head.py:dx_f32_launch_dims computes them.
MMSEG_API int mmseg_head1x1_dx_f32(const void* ct, const void* w, void* dx, int B, int NC,
                                   int Cf, long long V, long long blocks, int threads,
                                   void* stream) {
  if (Cf < 1 || Cf > DX_MAX_CF || blocks < 0) return int(cudaErrorInvalidValue);
  if (V == 0 || B == 0) return int(cudaSuccess);
  return dx_by_classes<float>(ct, w, dx, B, NC, Cf, V, blocks, threads,
                              static_cast<cudaStream_t>(stream));
}

// dk (Cf, NC) and db (NC,) fp32 from x (B, Cf, V) bf16 and ct (B, NC, V)
// fp32, through part, an fp32 scratch of nblk * (Cf * NC + NC); NC 1..8,
// Cf 1..64, nblk >= 1.
MMSEG_API int mmseg_head1x1_dw(const void* x, const void* ct, void* part, void* dk, void* db,
                               int B, int Cf, int NC, long long V, int nblk, void* stream) {
  if (Cf < 1 || Cf > DX_MAX_CF || nblk < 1) return int(cudaErrorInvalidValue);
  return dw_by_classes<bf16>(x, ct, part, dk, db, B, Cf, NC, V, nblk, -1, 0,
                             static_cast<cudaStream_t>(stream));
}

// The same from fp32 features x (B, Cf, V); nblk, the slices of feature
// channels (the grid's y) and threads as ops/head.py:dw_f32_launch_dims
// computes them.
MMSEG_API int mmseg_head1x1_dw_f32(const void* x, const void* ct, void* part, void* dk,
                                   void* db, int B, int Cf, int NC, long long V, int nblk,
                                   int slices, int threads, void* stream) {
  if (Cf < 1 || Cf > DX_MAX_CF || nblk < 1 || slices < 0) return int(cudaErrorInvalidValue);
  return dw_by_classes<float>(x, ct, part, dk, db, B, Cf, NC, V, nblk, slices, threads,
                              static_cast<cudaStream_t>(stream));
}
