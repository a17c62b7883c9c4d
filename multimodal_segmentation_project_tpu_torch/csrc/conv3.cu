// SAME 3x3x3 convolution on channel-first bf16 volumes: one implicit-GEMM
// body with a compile-time input prologue and a compile-time epilogue.
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   * _fwd_bias_act_kernel (public op conv3x3x3_cf_relu, the eval forward,
//     BatchNorm folded into w and b by the caller): epilogue kBiasRelu,
//     out = bf16(relu(acc + bias)) with the fp32 bias;
//   * _fwd_kernel (public op conv3x3x3_cf, the training forward, and the dx
//     of its backward): epilogue kCastBias, out = bf16(acc) and then, when
//     a bias is given, bf16(out + bf16(bias)): the bias is added in the
//     working dtype after the conv's one cast, as conv3x3x3_cf rounds. The
//     dx is this kernel on the cotangent with the weights flipped
//     spatially and Cin/Cout swapped (the wrapper packs them), no bias;
//   * _fwd_stats_kernel (conv3x3x3_cf_stats, conv0 of the fused training
//     DoubleConv): epilogue kBiasStats, y = bf16(acc + bias) with the fp32
//     bias added before the one cast, and per channel the sums of float(y)
//     and float(y)^2 of that rounded value;
//   * _fwd_prologue_stats_kernel (conv3x3x3_cf_boundary_stats, conv1 of the
//     fused DoubleConv): kBiasStats with the prologue on: the input is
//     staged as bf16(relu(x * a + t)) (conv3_tile.cuh), a, t fp32 per
//     (batch, channel), the halo kept 0;
//   * _fwd_prologue_kernel (conv3x3x3_cf_boundary): kCastBias with the
//     prologue on;
//   * _dx_epilogue_kernel (the backward of both boundary ops): epilogue
//     kDxMask on the dx conv of the cotangent (flipped, transposed
//     weights). With the conv's fp32 result dr, the boundary conv's raw
//     input x and its affine (a, t) at the output coordinates:
//     u = x * a + t, du = u > 0 ? dr : 0, dy = bf16(du * a), and per
//     (batch, channel) the sums of du * x (da) and of du (dt). Its output
//     channels are the boundary conv's INPUT channels; a, t, x are indexed
//     by them.
//
// Layout: x (B, Cin, D, H, W) bf16, bias (Cout,) fp32 or null (kCastBias
// only), out (B, Cout, D, H, W) bf16, a, t (B, Cin) fp32 for the prologue,
// xr (B, Cout, D, H, W) bf16 and a, t (B, Cout) fp32 for kDxMask, all
// contiguous. The weights arrive packed by the wrapper
// (ops/conv3.py:pack_weights) as the kernel's shared-memory image, one slab
// per chunk of 16 input channels: (ceil(Cin/16), 27, 16, Cout16) bf16,
// zero-padded in Cin and in Cout (Cout16 = Cout rounded up to 16).
//
// Design: an implicit GEMM with M = output voxels, N = Cout16 (at most 64)
// and K = 27 * Cin, on the tensor cores through WMMA 16x16x16 bf16
// fragments with fp32 accumulators held in registers. One block of 8 warps
// computes a (TD=2) x (TH=4) x (TW=32) output tile for every output channel;
// warp (t, r) owns row r of plane t as two 16-voxel M fragments. Per chunk
// of 16 input channels the block stages the haloed input tile
// (conv3_tile.cuh, with or without the prologue) and that chunk's weight
// slab, [27][16][Cout16] (55 KB at Cout = 64), copied 16 bytes a thread:
// the K loop over Cin chunks keeps the weights within shared memory (all
// 27*64*64 weights would take 221 KB). Cin = 1 (the first encoder conv) is
// a chunk with 15 zero channels. The fp32 accumulators go through shared
// memory to the epilogue, which writes each output channel's plane
// coalesced: a tile has as many voxels as the block has threads, so pass
// co of the epilogue is channel co with voxel m = thread.
//
// Channel sums across blocks: the TPU kernels carry them across a
// sequential grid; here blocks run in parallel. Each block reduces its
// tile per channel (warp shuffles, then its 8 warps in order) and writes
// one partial per (sum, channel[, batch]); conv3_stats_reduce_kernel then
// sums each run of partials in a fixed order (one block per run, a strided
// sum per thread and a fixed tree). The result is the same bits on every
// run, as conv3_dw.cu's two passes.
//
// What bounds it on an H100: at the 192^3 level the tensor-core work is
// small (98 GFLOP for a 16->16 conv, ~0.1 ms at the bf16 peak), and a
// 16->16 conv must move about 453 MB (x and y, 0.135 ms at 3.35 TB/s); the
// dx epilogue reads g and x and writes dy, about 680 MB (0.203 ms). The
// prologue and the epilogues add a few fp32 operations per staged or
// written element and nothing to the bytes: their point is that the
// activated input, and the dx conv's fp32 dr, never exist in device
// memory. The block stages its haloed input with scalar, bank-conflicted
// shared-memory stores (4 * 6 * 34 staged voxels for 256 outputs) and runs
// staging and MMAs in synchronised phases with nothing in flight between
// them, so it is bound by the staging and its latency, not by FLOPs or
// device memory. Double buffering, TMA and wgmma are later work.
#include <mma.h>

#include "conv3_tile.cuh"

using namespace nvcuda;
using namespace conv3;

namespace {

enum Epilogue { kBiasRelu = 0, kCastBias = 1, kBiasStats = 2, kDxMask = 3 };

constexpr int WARPS = THREADS / 32;
constexpr int RTHREADS = 256;  // threads of the cross-block reduce
static_assert(TM == THREADS, "the epilogue maps one voxel of the tile to each thread");

template <int COUT>
struct ConvSmem {
  static constexpr int w_elems = 27 * CK * COUT;
  static constexpr size_t operand_bytes = size_t(w_elems + X_ELEMS) * sizeof(bf16);
  static constexpr size_t stage_bytes = size_t(COUT) * TM * sizeof(float);
  // per channel, per warp, the two sums of kBiasStats / kDxMask
  static constexpr size_t red_bytes = size_t(COUT) * WARPS * 2 * sizeof(float);
  static constexpr size_t bytes = operand_bytes > stage_bytes + red_bytes
                                      ? operand_bytes : stage_bytes + red_bytes;
};

struct ConvArgs {
  const bf16* x;      // (B, Cin, D, H, W)
  const bf16* w;      // packed weights
  const float* bias;  // (Cout,) or null
  bf16* out;          // (B, Cout, D, H, W)
  const float* pa;    // prologue: (B, Cin)
  const float* pt;
  const bf16* xr;     // kDxMask: the boundary conv's raw input, (B, Cout, D, H, W)
  const float* ea;    // kDxMask: its affine, (B, Cout)
  const float* et;
  float* partial;     // kBiasStats, kDxMask: one value per (run, block)
  int B, Cin, Cout, D, H, W, tiles_w;
};

template <int COUT, int EPI, bool PRO>
__global__ void __launch_bounds__(THREADS) conv3_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = ws + ConvSmem<COUT>::w_elems;
  float* stage = reinterpret_cast<float*>(smem);  // reused after the K loop
  float* red = reinterpret_cast<float*>(smem + ConvSmem<COUT>::stage_bytes);

  constexpr bool SUMS = EPI == kBiasStats || EPI == kDxMask;
  constexpr int NF = COUT / 16;
  constexpr int W_VECS = ConvSmem<COUT>::w_elems / 8;  // 16-byte vectors per slab
  const int Cin = p.Cin, Cout = p.Cout, D = p.D, H = p.H, W = p.W;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int plane = warp / TH;  // output plane of this warp inside the tile
  const int row = warp % TH;    // output row of this warp inside its plane
  const int th_i = blockIdx.x / p.tiles_w;
  const int h0 = th_i * TH;
  const int w0 = (blockIdx.x - th_i * p.tiles_w) * TW;
  const int d0 = blockIdx.y * TD;
  const int b = blockIdx.z;
  const size_t hw = size_t(H) * W;
  const size_t vol = hw * D;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[mf][nf], 0.0f);

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();  // every warp is done with the previous chunk
    const uint4* wsrc = reinterpret_cast<const uint4*>(p.w) + size_t(c0 / CK) * W_VECS;
    uint4* wdst = reinterpret_cast<uint4*>(ws);
    for (int i = tid; i < W_VECS; i += THREADS) wdst[i] = wsrc[i];
    stage_halo<PRO>(xs, p.x, p.pa, p.pt, b, c0, Cin, D, H, W, d0, h0, w0);
    __syncthreads();

#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
          const bf16* arow = xs + tap_offset(plane, row, 0, kd, kh, kw);
          wmma::load_matrix_sync(a0, arow, CK);
          wmma::load_matrix_sync(a1, arow + 16 * CK, CK);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
            wmma::load_matrix_sync(bfrag, ws + tap * CK * COUT + nf * 16, COUT);
            wmma::mma_sync(acc[0][nf], a0, bfrag, acc[0][nf]);
            wmma::mma_sync(acc[1][nf], a1, bfrag, acc[1][nf]);
          }
        }
      }
    }
  }

  __syncthreads();  // the stage aliases the operand tiles
  const int m0 = (plane * TH + row) * TW;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      wmma::store_matrix_sync(stage + nf * 16 * TM + m0 + mf * 16, acc[mf][nf], TM,
                              wmma::mem_col_major);
  __syncthreads();

  // pass co: output channel co, voxel m = tid of the tile
  const int m = tid;
  const int gd = d0 + m / (TH * TW), gh = h0 + (m / TW) % TH, gw = w0 + m % TW;
  const bool inside = gd < D && gh < H && gw < W;
  const size_t voxel = size_t(gd) * hw + size_t(gh) * W + gw;
  for (int co = 0; co < Cout; ++co) {
    const float v = stage[co * TM + m];
    const size_t o = (size_t(b) * Cout + co) * vol + voxel;
    float r0 = 0.0f, r1 = 0.0f;  // this voxel's terms of the two channel sums
    if (inside) {
      if (EPI == kBiasRelu) {
        float u = v + p.bias[co];
        u = u < 0.0f ? 0.0f : u;  // ReLU that keeps a NaN, as jnp.maximum does
        p.out[o] = __float2bfloat16(u);
      } else if (EPI == kCastBias) {
        bf16 y = __float2bfloat16(v);
        if (p.bias != nullptr)
          y = __float2bfloat16(__bfloat162float(y) +
                               __bfloat162float(__float2bfloat16(p.bias[co])));
        p.out[o] = y;
      } else if (EPI == kBiasStats) {
        const bf16 y = __float2bfloat16(v + p.bias[co]);
        p.out[o] = y;
        r0 = __bfloat162float(y);
        r1 = r0 * r0;  // exact: 8 significant bits squared
      } else {  // kDxMask: v is dr
        const float xv = __bfloat162float(p.xr[o]);
        const float a = p.ea[b * Cout + co], t = p.et[b * Cout + co];
        const float du = __fadd_rn(__fmul_rn(xv, a), t) > 0.0f ? v : 0.0f;
        p.out[o] = __float2bfloat16(__fmul_rn(du, a));
        r0 = __fmul_rn(du, xv);  // no FMA contraction into the sums below
        r1 = du;
      }
    }
    if (SUMS) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        r0 += __shfl_xor_sync(0xffffffffu, r0, s);
        r1 += __shfl_xor_sync(0xffffffffu, r1, s);
      }
      if (lane == 0) {
        red[(co * WARPS + warp) * 2] = r0;
        red[(co * WARPS + warp) * 2 + 1] = r1;
      }
    }
  }

  if (SUMS) {
    __syncthreads();
    const int nblk = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int j = tid; j < 2 * Cout; j += THREADS) {  // j = which sum * Cout + channel
      const int co = j % Cout, k = j / Cout;
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += red[(co * WARPS + w) * 2 + k];
      // the partials of one output are contiguous: kBiasStats sums over the
      // batch too, (k, co) outputs of (b, block) partials; kDxMask has
      // (k, b, co) outputs of (block) partials
      const size_t run =
          EPI == kBiasStats ? size_t(j) * p.B + b : (size_t(k) * p.B + b) * Cout + co;
      p.partial[run * nblk + blk] = s;
    }
  }
}

// out[r] = the sum of partial[r * len : (r + 1) * len], one block per run,
// in a fixed order: thread i sums elements i, i + 256, ... and a fixed
// tree sums the threads.
__global__ void __launch_bounds__(RTHREADS)
conv3_stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int len) {
  __shared__ float s[RTHREADS];
  const float* run = partial + size_t(blockIdx.x) * len;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < len; i += RTHREADS) acc += run[i];
  s[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int h = RTHREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

// sums: (2, Cout) for kBiasStats, (2, B, Cout) for kDxMask; null otherwise
template <int COUT, int EPI, bool PRO>
cudaError_t launch(const ConvArgs& args, float* sums, cudaStream_t stream) {
  const int smem = int(ConvSmem<COUT>::bytes);
  cudaError_t err = cudaFuncSetAttribute(conv3_kernel<COUT, EPI, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (args.H + TH - 1) / TH;
  dim3 grid(args.tiles_w * tiles_h, (args.D + TD - 1) / TD, args.B);
  conv3_kernel<COUT, EPI, PRO><<<grid, THREADS, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kBiasStats || EPI == kDxMask)) return err;
  const int nblk = int(grid.x * grid.y);
  const int runs = EPI == kBiasStats ? 2 * args.Cout : args.B * 2 * args.Cout;
  const int len = EPI == kBiasStats ? args.B * nblk : nblk;
  conv3_stats_reduce_kernel<<<runs, RTHREADS, 0, stream>>>(args.partial, sums, len);
  return cudaGetLastError();
}

template <int EPI, bool PRO>
int dispatch(ConvArgs args, float* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  args.tiles_w = (args.W + TW - 1) / TW;
  switch ((args.Cout + 15) / 16) {
    case 1: return launch<16, EPI, PRO>(args, sums, s);
    case 2: return launch<32, EPI, PRO>(args, sums, s);
    case 3: return launch<48, EPI, PRO>(args, sums, s);
    case 4: return launch<64, EPI, PRO>(args, sums, s);
    default: return int(cudaErrorInvalidValue);
  }
}

ConvArgs conv_args(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
                   int Cout, int D, int H, int W) {
  ConvArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.B = B, a.Cin = Cin, a.Cout = Cout, a.D = D, a.H = H, a.W = W;
  return a;
}

}  // namespace

MMSEG_API int mmseg_conv3_bias_relu(const void* x, const void* w, const void* bias, void* out,
                                    int B, int Cin, int Cout, int D, int H, int W,
                                    void* stream) {
  if (bias == nullptr) return int(cudaErrorInvalidValue);
  return dispatch<kBiasRelu, false>(conv_args(x, w, bias, out, B, Cin, Cout, D, H, W), nullptr,
                                    stream);
}

// bias may be null (the dx use): then out = bf16(acc).
MMSEG_API int mmseg_conv3(const void* x, const void* w, const void* bias, void* out, int B,
                          int Cin, int Cout, int D, int H, int W, void* stream) {
  return dispatch<kCastBias, false>(conv_args(x, w, bias, out, B, Cin, Cout, D, H, W), nullptr,
                                    stream);
}

// Kernel 12: the conv of bf16(relu(x * a + t)), cast, then the bias in bf16.
MMSEG_API int mmseg_conv3_prologue(const void* x, const void* w, const void* bias,
                                   const void* a, const void* t, void* out, int B, int Cin,
                                   int Cout, int D, int H, int W, void* stream) {
  if (bias == nullptr || a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.pa = static_cast<const float*>(a);
  args.pt = static_cast<const float*>(t);
  return dispatch<kCastBias, true>(args, nullptr, stream);
}

// Kernel 3: y = bf16(conv + bias) and stats (2, Cout) = (sum y, sum y^2);
// partial holds 2 * Cout * B * (blocks per batch element) floats.
MMSEG_API int mmseg_conv3_stats(const void* x, const void* w, const void* bias, void* out,
                                void* partial, void* stats, int B, int Cin, int Cout, int D,
                                int H, int W, void* stream) {
  if (bias == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.partial = static_cast<float*>(partial);
  return dispatch<kBiasStats, false>(args, static_cast<float*>(stats), stream);
}

// Kernel 4: kernel 3 on bf16(relu(x * a + t)).
MMSEG_API int mmseg_conv3_prologue_stats(const void* x, const void* w, const void* bias,
                                         const void* a, const void* t, void* out,
                                         void* partial, void* stats, int B, int Cin, int Cout,
                                         int D, int H, int W, void* stream) {
  if (bias == nullptr || a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.pa = static_cast<const float*>(a);
  args.pt = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  return dispatch<kBiasStats, true>(args, static_cast<float*>(stats), stream);
}

// Kernel 5: g (B, Cg, D, H, W) with the flipped, transposed weights packed
// for Cin = Cg, Cout = Cx; x (B, Cx, D, H, W) and a, t (B, Cx) of the
// boundary conv -> dy (B, Cx, D, H, W) and dadt (2, B, Cx) = (da, dt);
// partial holds B * 2 * Cx * (blocks per batch element) floats.
MMSEG_API int mmseg_conv3_dx_epilogue(const void* g, const void* w, const void* x,
                                      const void* a, const void* t, void* dy, void* partial,
                                      void* dadt, int B, int Cg, int Cx, int D, int H, int W,
                                      void* stream) {
  if (x == nullptr || a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(g, w, nullptr, dy, B, Cg, Cx, D, H, W);
  args.xr = static_cast<const bf16*>(x);
  args.ea = static_cast<const float*>(a);
  args.et = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  return dispatch<kDxMask, false>(args, static_cast<float*>(dadt), stream);
}
