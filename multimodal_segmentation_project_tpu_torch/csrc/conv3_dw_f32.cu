// Weight gradient of the SAME 3x3x3 convolution on channel-first fp32
// volumes, in full fp32 on the CUDA cores:
//
//   dW[kd, kh, kw, ci, co] = sum over b, v of x[b, ci, v + (kd, kh, kw) - 1] * g[b, co, v]
//
// with x zero outside the volume (the SAME halo).
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   * _dw_kernel_shared (the dW of conv3x3x3_cf's backward, _conv_dw_shared)
//     on fp32 x and cotangent, as the JAX package runs it under its fp32
//     policy (it stages in x's dtype): conv3_dw_f32_partial_kernel<false>,
//     mmseg_conv3_dw_f32;
//   * _dw_kernel_prologue (the dW of the fused DoubleConv's boundary convs,
//     _conv_dw_prologue) on fp32 x, a, t and cotangent: the input staged as
//     relu(x * a + t) with a, t (B, Cin) fp32 per (batch, channel), the
//     SAME halo kept 0: conv3_dw_f32_partial_kernel<true>,
//     mmseg_conv3_dw_f32_prologue.
//
// Why a body of its own, and no MMA: conv3_dw.cu runs mma.sync on bf16
// operands, and a TF32 MMA keeps 10 mantissa bits (about 5e-4 relative
// error a product), where an fp32 dW is held to 2e-5 of max |dW|. So this
// body multiplies and adds in fp32 FFMA.
//
// Layout: x (B, Cin, D, H, W) fp32, g (B, Cout, D, H, W) fp32, dW (27, Cin,
// Cout) fp32 = (3, 3, 3, Cin, Cout), all contiguous. The wrapper allocates
// the fp32 scratch `partial` of nblk * 27 * Cin * Cout values
// (ops/conv3.py:dw_f32_operands picks nblk).
//
// Design: a GEMM with M = 27 taps x Cin, N = Cout and K = the output
// voxels, in two passes.
//
//   1. conv3_dw_f32_partial_kernel: grid (nblk, ceil(Cin / CI), ceil(Cout /
//      CO)), THREADS = 256 threads, 8 warps. Block (k, i, j) owns input
//      channels [CI i, CI i + CI) and output channels [CO j, CO j + CO) and
//      walks the output tiles k, k + nblk, k + 2 nblk, ... of the volume
//      (TD x TH x TW = 4 x 8 x 16 voxels, W fastest, then H, D and the
//      batch) through a two-stage cp.async ring: while the FMAs of tile t
//      read one stage, tile t + nblk lands in the other. A stage holds the
//      tile's haloed input of the CI channels as conv3_f32.cu stages it
//      (conv3_f32_tile.cuh: W-minor rows of PITCH = 20 floats, zero
//      outside the volume and past Cin) and the tile's cotangent of the CO
//      channels, rows of 16 voxels at the same pitch (zero outside the
//      volume and past Cout); 16-byte pieces where W % 4 == 0 and the
//      tensor is aligned, else 4-byte ones. With the prologue, once a tile
//      has landed one pass rewrites its staged input in place as relu(x *
//      a + t) of the tile's batch element (conv3_f32_tile.cuh), and a
//      barrier then hands the stage to the FMAs.
//      Warp w takes input channel w % CI and output channels CO / 2 * (w /
//      CI) + [0, RN); lane l the tile's output row (l / 8, l % 8), all 16
//      voxels of it, in two halves of 8: it holds 27 taps x RN = 4 output
//      channels = 108 fp32 accumulators. Per half it reads its RN x 8
//      cotangent values once (two 16-byte reads a channel), then per (kd,
//      kh) the 10-voxel window of one staged input row (two 16-byte reads
//      and two 4-byte reads) and adds 3 kw x RN x 8 products: 864 FMAs a
//      half for 44 reads. A quarter warp's 16-byte reads fall on 8
//      consecutive staged rows, whose pitch (5 x 16 bytes) puts them on 8
//      different groups of banks.
//      At the end each warp sums its lanes by a shuffle tree (a fixed
//      order) and writes its (27, 1, RN) slice of the block's (27, Cin,
//      Cout) partial sums once: every entry of every block's partial is
//      written, a block without tiles writing zeros.
//   2. conv3_dw_f32_reduce_kernel: one thread per dW element sums the nblk
//      partials in block order.
// Each accumulator sums its row's voxels in order, tile after tile; the
// split over blocks is fixed by the SM count and the channel counts, so
// the result is the same bits on every run on one card. No atomics.
//
// What bounds it on an H100: the fp32 operations. An fp32 train step's
// eleven dW (the convs with Cin, Cout <= 64 at 192^3) do about 679 GFLOP,
// 10.1 ms at 67 TFLOP/s of FFMA; they read about 1.7 GB once (0.5 ms at
// 3.35 TB/s). Per tile a warp issues 3456 FFMAs for 88 shared-memory reads
// and the block stages 39 KB (the input's halo doubles its share), so the
// FMAs, not shared memory or L2, should set the pace; 108 accumulators a
// thread leave room for one block of 8 warps an SM. Cin = 1 (the first
// conv) leaves three of the four input-channel warps idle: 6 of the 679
// GFLOP.
#include "conv3_f32_tile.cuh"

using namespace conv3f32;

namespace {

constexpr int CI = 4;            // input channels per block (a warp each)
constexpr int CO = 8;            // output channels per block
constexpr int RN = 4;            // output channels per warp
constexpr int RTHREADS = 256;    // threads of the reduce
constexpr int X_FLOATS = CI * ROWS * PITCH;      // one stage's input tile
constexpr int G_FLOATS = CO * TD * TH * PITCH;   // one stage's cotangent tile
constexpr int STAGE_FLOATS = X_FLOATS + G_FLOATS;
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * 4;
static_assert(CI * (CO / RN) * 32 == THREADS, "one warp per (input channel, output group)");
static_assert(TD * TH == 32, "one lane per output row of the tile");

struct DwArgs {
  const float* x;      // (B, Cin, D, H, W)
  const float* g;      // (B, Cout, D, H, W)
  const float* a;      // (B, Cin): the prologue's scale (kernel 6 only)
  const float* t;      // (B, Cin): its shift
  float* partial;      // (nblk, 27, Cin, Cout)
  int Cin, Cout, D, H, W;
  int tiles_w, tiles_h, tiles_d, ntiles;
};

// The origin of output tile `tile`: its batch element and first voxel.
struct TileAt {
  int b, d0, h0, w0;
};

__device__ __forceinline__ TileAt tile_at(const DwArgs& p, int tile) {
  const int tw = tile % p.tiles_w;
  int r = tile / p.tiles_w;
  const int h0 = (r % p.tiles_h) * TH;
  r /= p.tiles_h;
  return {r / p.tiles_d, (r % p.tiles_d) * TD, h0, tw * TW};
}

// Issue output tile `tile` into the stage at shared address `st`: the
// haloed input of channels [c0, c0 + CI) and the cotangent of channels
// [o0, o0 + CO). vx, vg: W % 4 == 0 and x (g) is 16-byte aligned.
__device__ __forceinline__ void issue_tile(uint32_t st, const DwArgs& p, int tile, int c0,
                                           int o0, bool vx, bool vg) {
  const TileAt at = tile_at(p, tile);
  const int b = at.b, d0 = at.d0, h0 = at.h0, w0 = at.w0;
  issue_input<CI>(st, p.x, p.Cin, p.D, p.H, p.W, b, c0, d0, h0, w0, vx);
  // cotangent, per (channel, output row): 4 pieces of 4 voxels
  const uint32_t gst = st + uint32_t(X_FLOATS) * 4u;
  for (int i = threadIdx.x; i < CO * TD * TH * 4; i += THREADS) {
    const int piece = i % 4, cr = i / 4;  // cr = channel * 32 + output row
    const int co = o0 + cr / (TD * TH), orow = cr % (TD * TH);
    const int gd = d0 + orow / TH, gh = h0 + orow % TH;
    const bool ok = co < p.Cout && gd < p.D && gh < p.H;
    const float* src =
        ok ? p.g + ((size_t(b) * p.Cout + co) * p.D + gd) * size_t(p.H) * p.W + size_t(gh) * p.W
           : p.g;
    const uint32_t dst = gst + uint32_t(cr * PITCH + 4 * piece) * 4u;
    const int w = w0 + 4 * piece;
    if (vg) {
      const bool in = ok && w < p.W;
      cp_async16(dst, in ? src + w : p.g, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = ok && w + e < p.W;
        cp_async4(dst + 4u * e, in ? src + w + e : p.g, in);
      }
    }
  }
  cp_async_commit();
}

template <bool PRO>
__global__ void __launch_bounds__(THREADS, 1) conv3_dw_f32_partial_kernel(const DwArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ci_l = warp % CI;                 // input channel of this warp in the block's chunk
  const int n0 = (warp / CI) * RN;            // its first output channel in the block's CO
  const int od = lane >> 3, oh = lane & 7;    // output row of this lane in the tile
  const int c0 = blockIdx.y * CI, o0 = blockIdx.z * CO;
  const bool active = c0 + ci_l < p.Cin;      // warp-uniform
  const uint32_t smem_s = uint32_t(__cvta_generic_to_shared(smem));
  const bool vx = p.W % 4 == 0 && aligned16(p.x);
  const bool vg = p.W % 4 == 0 && aligned16(p.g);

  float acc[27][RN];
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[k][n] = 0.0f;

  const int first = blockIdx.x;
  if (first < p.ntiles) issue_tile(smem_s, p, first, c0, o0, vx, vg);
  int s = 0;
  for (int tile = first; tile < p.ntiles; tile += gridDim.x, s ^= 1) {
    if (tile + int(gridDim.x) < p.ntiles) {
      issue_tile(smem_s + uint32_t((s ^ 1) * STAGE_FLOATS) * 4u, p, tile + gridDim.x, c0, o0,
                 vx, vg);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile has landed in stage s
    if (PRO) {
      const TileAt at = tile_at(p, tile);
      prologue_input<CI>(smem + s * STAGE_FLOATS, p.a, p.t, p.Cin, p.D, p.H, p.W, at.b, c0,
                         at.d0, at.h0, at.w0);
      __syncthreads();  // the activated input is in place
    }
    if (active) {
      const float* xs = smem + s * STAGE_FLOATS + ci_l * ROWS * PITCH;
      const float* gs = smem + s * STAGE_FLOATS + X_FLOATS + (n0 * TD * TH + lane) * PITCH;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        // the cotangent of RN channels at voxels [8 half, 8 half + 8) of the row
        float gv[RN][8];
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          const float* gr = gs + n * TD * TH * PITCH + 8 * half;
          const float4 lo = *reinterpret_cast<const float4*>(gr);
          const float4 hi = *reinterpret_cast<const float4*>(gr + 4);
          gv[n][0] = lo.x, gv[n][1] = lo.y, gv[n][2] = lo.z, gv[n][3] = lo.w;
          gv[n][4] = hi.x, gv[n][5] = hi.y, gv[n][6] = hi.z, gv[n][7] = hi.w;
        }
        // the window: staged-row offsets of voxel w0 - 1 + 8 half (a0), of
        // the 8 voxels after it (v4) and of the last (a9)
        const int a0 = half ? 7 : LEFT;
        const int v4 = 8 * half;
        const int a9 = half ? RIGHT : 8;
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float* row = xs + ((od + kd) * HR + oh + kh) * PITCH;
            float v[10];
            v[0] = row[a0];
            const float4 lo = *reinterpret_cast<const float4*>(row + v4);
            const float4 hi = *reinterpret_cast<const float4*>(row + v4 + 4);
            v[1] = lo.x, v[2] = lo.y, v[3] = lo.z, v[4] = lo.w;
            v[5] = hi.x, v[6] = hi.y, v[7] = hi.z, v[8] = hi.w;
            v[9] = row[a9];
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              const int k = (kd * 3 + kh) * 3 + kw;
#pragma unroll
              for (int n = 0; n < RN; ++n)
#pragma unroll
                for (int m = 0; m < 8; ++m) acc[k][n] = fmaf(v[m + kw], gv[n][m], acc[k][n]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

  // the warp's rows summed by a shuffle tree; lane 0 writes the slice
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      float v = acc[k][n];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
      acc[k][n] = v;
    }
  if (lane != 0 || !active) return;
  const int ci = c0 + ci_l;
  float* out = p.partial + size_t(blockIdx.x) * 27 * p.Cin * p.Cout;
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int co = o0 + n0 + n;
      if (co < p.Cout) out[(size_t(k) * p.Cin + ci) * p.Cout + co] = acc[k][n];
    }
}

__global__ void __launch_bounds__(RTHREADS)
conv3_dw_f32_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int nblk,
                           int n_out) {
  const int i = blockIdx.x * RTHREADS + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += partial[size_t(k) * n_out + i];
  dw[i] = s;
}

// Check the descriptor against the kernel's own, then the two passes.
template <bool PRO>
int launch(const void* x, const void* g, const void* a, const void* t, void* partial, void* dw,
           int B, int Cin, int Cout, int D, int H, int W, int grid_x, int grid_y, int grid_z,
           int threads, int smem, void* stream) {
  if (x == nullptr || g == nullptr || partial == nullptr || dw == nullptr || Cin < 1 ||
      Cout < 1 || grid_x < 1 || (PRO && (a == nullptr || t == nullptr)))
    return int(cudaErrorInvalidValue);
  if (threads != THREADS || smem != SMEM_BYTES || grid_y != (Cin + CI - 1) / CI ||
      grid_z != (Cout + CO - 1) / CO)
    return int(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DwArgs args{};
  args.x = static_cast<const float*>(x);
  args.g = static_cast<const float*>(g);
  args.a = static_cast<const float*>(a);
  args.t = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  args.Cin = Cin, args.Cout = Cout, args.D = D, args.H = H, args.W = W;
  args.tiles_w = (W + TW - 1) / TW, args.tiles_h = (H + TH - 1) / TH;
  args.tiles_d = (D + TD - 1) / TD;
  args.ntiles = B * args.tiles_d * args.tiles_h * args.tiles_w;
  cudaError_t err = cudaFuncSetAttribute(conv3_dw_f32_partial_kernel<PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  conv3_dw_f32_partial_kernel<PRO><<<dim3(grid_x, grid_y, grid_z), THREADS, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n_out = 27 * Cin * Cout;
  conv3_dw_f32_reduce_kernel<<<(n_out + RTHREADS - 1) / RTHREADS, RTHREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), grid_x, n_out);
  return int(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a conv3_dw_f32_partial_kernel block: two stages
// of CI haloed input channels and CO cotangent channels.
MMSEG_API int mmseg_conv3_dw_f32_smem_bytes() { return SMEM_BYTES; }

// Kernel 2 in fp32: dW (27, Cin, Cout) from x (B, Cin, D, H, W) and g (B,
// Cout, D, H, W), through partial, an fp32 scratch of nblk * 27 * Cin *
// Cout; grid (nblk, ceil(Cin / CI), ceil(Cout / CO)), threads and smem as
// ops/conv3.py:dw_f32_launch_dims computes them, checked against the
// kernel's own (another gets cudaErrorInvalidConfiguration and nothing
// runs).
MMSEG_API int mmseg_conv3_dw_f32(const void* x, const void* g, void* partial, void* dw, int B,
                                 int Cin, int Cout, int D, int H, int W, int grid_x, int grid_y,
                                 int grid_z, int threads, int smem, void* stream) {
  return launch<false>(x, g, nullptr, nullptr, partial, dw, B, Cin, Cout, D, H, W, grid_x,
                       grid_y, grid_z, threads, smem, stream);
}

// Kernel 6 in fp32: the dW of the conv of relu(x * a + t), a, t (B, Cin);
// the scratch and the descriptor as for mmseg_conv3_dw_f32.
MMSEG_API int mmseg_conv3_dw_f32_prologue(const void* x, const void* g, const void* a,
                                          const void* t, void* partial, void* dw, int B,
                                          int Cin, int Cout, int D, int H, int W, int grid_x,
                                          int grid_y, int grid_z, int threads, int smem,
                                          void* stream) {
  return launch<true>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, grid_x, grid_y, grid_z,
                      threads, smem, stream);
}
