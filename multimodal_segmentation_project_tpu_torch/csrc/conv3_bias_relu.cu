// SAME 3x3x3 convolution + bias + ReLU on channel-first bf16 volumes, with
// BatchNorm already folded into w and b by the caller (the eval forward).
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   _fwd_bias_act_kernel (public op conv3x3x3_cf_relu).
//
// Layout: x (B, Cin, D, H, W) bf16, bias (Cout,) fp32, out (B, Cout, D, H, W)
// bf16, all contiguous. The weights arrive packed by the wrapper
// (ops/conv3.py:pack_weights) as the kernel's shared-memory image, one slab
// per chunk of 16 input channels: (ceil(Cin/16), 27, 16, Cout16) bf16,
// zero-padded in Cin and in Cout (Cout16 = Cout rounded up to 16).
//
// Design: an implicit GEMM with M = output voxels, N = Cout16 (at most 64)
// and K = 27 * Cin, on the tensor cores through WMMA 16x16x16 bf16
// fragments with fp32 accumulators held in registers. One block of 8 warps
// computes a (TD=2) x (TH=4) x (TW=32) output tile for every output channel;
// warp (t, r) owns row r of plane t as two 16-voxel M fragments. Per chunk
// of 16 input channels the block stages
//   * the haloed input tile [TD+2][TH+2][TW+2][16] in shared memory, channel
//     minor, so that for any tap (kd, kh, kw) the A fragment of 16
//     consecutive voxels is a plain row-major 16x16 tile (ldm = 16): no
//     im2col copy. Loads outside the volume are masked to zero, which is
//     the SAME halo; no padded copy of x exists. Two output planes share
//     the four staged planes.
//   * that chunk's weight slab, [27][16][Cout16] (55 KB at Cout = 64), copied
//     16 bytes a thread: the K loop over Cin chunks keeps the weights within
//     shared memory (all 27*64*64 weights would take 221 KB).
// Cin = 1 (the first encoder conv) is a chunk with 15 zero channels.
// Epilogue: the fp32 accumulators go through shared memory, the fp32 bias
// is added, ReLU, and the one rounding to bf16, as the TPU kernel rounds.
//
// What bounds it on an H100: at the 192^3 level the tensor-core work is
// small (98 GFLOP for a 16->16 conv, ~0.1 ms at the bf16 peak). The block
// stages its haloed input with scalar, bank-conflicted shared-memory stores
// (4 * 6 * 34 staged voxels for 256 outputs) and runs staging and MMAs in
// synchronised phases with nothing in flight between them, so it is bound
// by the staging and its latency, not by FLOPs or device memory. Double
// buffering, TMA and wgmma are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TD = 2;         // output depth planes per block
constexpr int TH = 4;         // output rows per plane
constexpr int TW = 32;        // output columns per row
constexpr int TM = TD * TH * TW;  // output voxels per block (GEMM M)
constexpr int CK = 16;        // input channels per K chunk
constexpr int DR = TD + 2;    // haloed tile planes
constexpr int HR = TH + 2;    // haloed tile rows
constexpr int WR = TW + 2;    // haloed tile columns
constexpr int THREADS = 32 * TD * TH;  // one warp per output row

template <int COUT>
struct ConvSmem {
  static constexpr int w_elems = 27 * CK * COUT;
  static constexpr int x_elems = DR * HR * WR * CK;
  static constexpr size_t operand_bytes = size_t(w_elems + x_elems) * sizeof(bf16);
  static constexpr size_t stage_bytes = size_t(COUT) * TM * sizeof(float);
  static constexpr size_t bytes = operand_bytes > stage_bytes ? operand_bytes : stage_bytes;
};

template <int COUT>
__global__ void __launch_bounds__(THREADS)
conv3_bias_relu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       int Cin, int Cout, int D, int H, int W, int tiles_w) {
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
    for (int i = tid; i < ConvSmem<COUT>::x_elems; i += THREADS) {
      const int xx = i % WR;
      int r = i / WR;
      const int yy = r % HR;
      r /= HR;
      const int zz = r % DR;
      const int ci = r / DR;
      const int gd = d0 + zz - 1, gh = h0 + yy - 1, gw = w0 + xx - 1;
      bf16 v = bf16_zero();
      if (c0 + ci < Cin && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = x[(size_t(b) * Cin + c0 + ci) * vol + size_t(gd) * hw + size_t(gh) * W + gw];
      xs[((zz * HR + yy) * WR + xx) * CK + ci] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
          const bf16* arow = xs + (((plane + kd) * HR + row + kh) * WR + kw) * CK;
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
      float v = stage[co * TM + m] + bias[co];
      v = v < 0.0f ? 0.0f : v;  // ReLU that keeps a NaN, as jnp.maximum does
      out[(size_t(b) * Cout + co) * vol + size_t(gd) * hw + size_t(gh) * W + gw] =
          __float2bfloat16(v);
    }
  }
}

template <int COUT>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
                   int Cout, int D, int H, int W, cudaStream_t stream) {
  const int smem = int(ConvSmem<COUT>::bytes);
  cudaError_t err = cudaFuncSetAttribute(conv3_bias_relu_kernel<COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (D + TD - 1) / TD, B);
  conv3_bias_relu_kernel<COUT><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), Cin, Cout, D, H, W, tiles_w);
  return cudaGetLastError();
}

}  // namespace

MMSEG_API int mmseg_conv3_bias_relu(const void* x, const void* w, const void* bias, void* out,
                                    int B, int Cin, int Cout, int D, int H, int W,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Cout + 15) / 16) {
    case 1: return launch<16>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    case 2: return launch<32>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    case 3: return launch<48>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    case 4: return launch<64>(x, w, bias, out, B, Cin, Cout, D, H, W, s);
    default: return int(cudaErrorInvalidValue);
  }
}
