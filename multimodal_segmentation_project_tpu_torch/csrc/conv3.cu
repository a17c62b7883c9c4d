// SAME 3x3x3 convolution on channel-first bf16 volumes: one implicit-GEMM
// body with a compile-time epilogue.
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
//     spatially and Cin/Cout swapped (the wrapper packs them), no bias.
//
// Layout: x (B, Cin, D, H, W) bf16, bias (Cout,) fp32 or null (kCastBias
// only), out (B, Cout, D, H, W) bf16, all contiguous. The weights arrive
// packed by the wrapper (ops/conv3.py:pack_weights) as the kernel's
// shared-memory image, one slab per chunk of 16 input channels:
// (ceil(Cin/16), 27, 16, Cout16) bf16, zero-padded in Cin and in Cout
// (Cout16 = Cout rounded up to 16).
//
// Design: an implicit GEMM with M = output voxels, N = Cout16 (at most 64)
// and K = 27 * Cin, on the tensor cores through WMMA 16x16x16 bf16
// fragments with fp32 accumulators held in registers. One block of 8 warps
// computes a (TD=2) x (TH=4) x (TW=32) output tile for every output channel;
// warp (t, r) owns row r of plane t as two 16-voxel M fragments. Per chunk
// of 16 input channels the block stages the haloed input tile
// (conv3_tile.cuh) and that chunk's weight slab, [27][16][Cout16] (55 KB at
// Cout = 64), copied 16 bytes a thread: the K loop over Cin chunks keeps
// the weights within shared memory (all 27*64*64 weights would take
// 221 KB). Cin = 1 (the first encoder conv) is a chunk with 15 zero
// channels. The fp32 accumulators go through shared memory to the
// epilogue, which writes each output channel's plane coalesced.
//
// What bounds it on an H100: at the 192^3 level the tensor-core work is
// small (98 GFLOP for a 16->16 conv, ~0.1 ms at the bf16 peak). The block
// stages its haloed input with scalar, bank-conflicted shared-memory stores
// (4 * 6 * 34 staged voxels for 256 outputs) and runs staging and MMAs in
// synchronised phases with nothing in flight between them, so it is bound
// by the staging and its latency, not by FLOPs or device memory. Double
// buffering, TMA and wgmma are later work.
#include <mma.h>

#include "conv3_tile.cuh"

using namespace nvcuda;
using namespace conv3;

namespace {

enum Epilogue { kBiasRelu = 0, kCastBias = 1 };

template <int COUT>
struct ConvSmem {
  static constexpr int w_elems = 27 * CK * COUT;
  static constexpr size_t operand_bytes = size_t(w_elems + X_ELEMS) * sizeof(bf16);
  static constexpr size_t stage_bytes = size_t(COUT) * TM * sizeof(float);
  static constexpr size_t bytes = operand_bytes > stage_bytes ? operand_bytes : stage_bytes;
};

template <int COUT, int EPI>
__global__ void __launch_bounds__(THREADS)
conv3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
             const float* __restrict__ bias, bf16* __restrict__ out, int Cin, int Cout, int D,
             int H, int W, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = ws + ConvSmem<COUT>::w_elems;
  float* stage = reinterpret_cast<float*>(smem);  // reused after the K loop

  constexpr int NF = COUT / 16;
  constexpr int W_VECS = ConvSmem<COUT>::w_elems / 8;  // 16-byte vectors per slab
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int plane = warp / TH;  // output plane of this warp inside the tile
  const int row = warp % TH;    // output row of this warp inside its plane
  const int th_i = blockIdx.x / tiles_w;
  const int h0 = th_i * TH;
  const int w0 = (blockIdx.x - th_i * tiles_w) * TW;
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
    const uint4* wsrc = reinterpret_cast<const uint4*>(wpk) + size_t(c0 / CK) * W_VECS;
    uint4* wdst = reinterpret_cast<uint4*>(ws);
    for (int i = tid; i < W_VECS; i += THREADS) wdst[i] = wsrc[i];
    stage_halo(xs, x, b, c0, Cin, D, H, W, d0, h0, w0);
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

  for (int i = tid; i < Cout * TM; i += THREADS) {
    const int co = i / TM;
    const int m = i - co * TM;
    const int c = m % TW;
    const int r = (m / TW) % TH;
    const int gd = d0 + m / (TH * TW), gh = h0 + r, gw = w0 + c;
    if (gd < D && gh < H && gw < W) {
      bf16 o;
      if (EPI == kBiasRelu) {
        float v = stage[co * TM + m] + bias[co];
        v = v < 0.0f ? 0.0f : v;  // ReLU that keeps a NaN, as jnp.maximum does
        o = __float2bfloat16(v);
      } else {
        o = __float2bfloat16(stage[co * TM + m]);
        if (bias != nullptr)
          o = __float2bfloat16(__bfloat162float(o) +
                               __bfloat162float(__float2bfloat16(bias[co])));
      }
      out[(size_t(b) * Cout + co) * vol + size_t(gd) * hw + size_t(gh) * W + gw] = o;
    }
  }
}

template <int COUT, int EPI>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
                   int Cout, int D, int H, int W, cudaStream_t stream) {
  const int smem = int(ConvSmem<COUT>::bytes);
  cudaError_t err = cudaFuncSetAttribute(conv3_kernel<COUT, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (D + TD - 1) / TD, B);
  conv3_kernel<COUT, EPI><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), Cin, Cout, D, H, W, tiles_w);
  return cudaGetLastError();
}

template <int EPI>
int dispatch(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
             int Cout, int D, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Cout + 15) / 16) {
    case 1: return launch<16, EPI>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    case 2: return launch<32, EPI>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    case 3: return launch<48, EPI>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    case 4: return launch<64, EPI>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

MMSEG_API int mmseg_conv3_bias_relu(const void* x, const void* w, const void* bias, void* out,
                                    int B, int Cin, int Cout, int D, int H, int W,
                                    void* stream) {
  if (bias == nullptr) return int(cudaErrorInvalidValue);
  return dispatch<kBiasRelu>(x, w, bias, out, B, Cin, Cout, D, H, W, stream);
}

// bias may be null (the dx use): then out = bf16(acc).
MMSEG_API int mmseg_conv3(const void* x, const void* w, const void* bias, void* out, int B,
                          int Cin, int Cout, int D, int H, int W, void* stream) {
  return dispatch<kCastBias>(x, w, bias, out, B, Cin, Cout, D, H, W, stream);
}
