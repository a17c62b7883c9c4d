// Weight gradient of the SAME 3x3x3 convolution on channel-first bf16
// volumes, in fp32:
//
//   dW[kd, kh, kw, ci, co] = sum over b, v of x[b, ci, v + (kd, kh, kw) - 1] * g[b, co, v]
//
// with x zero outside the volume (the SAME halo).
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   _dw_kernel_shared (the dW of conv3x3x3_cf's backward, _conv_dw_shared).
//
// Layout: x (B, Cin, D, H, W) bf16, g (B, Cout, D, H, W) bf16, dW
// (27, Cin, Cout) fp32 = (3, 3, 3, Cin, Cout), all contiguous. The wrapper
// allocates the fp32 scratch `partial` of nblk * ceil(Cin/16) * 27 * 16 *
// Cout16 values (ops/conv3.py:dw_partial_blocks picks nblk).
//
// Design: a GEMM with M = 27 * Cin (tap, input channel), N = Cout and
// K = the voxels, on the tensor cores through WMMA 16x16x16 bf16 fragments
// with fp32 accumulators in registers. The TPU kernel accumulates one
// output block across a sequential grid; here blocks run in parallel, so
// the sum is split in two passes that give the same bits on every run:
//   1. conv3_dw_partial_kernel: grid (nblk, Cin chunks of 16). Block k
//      walks the output tiles k, k + nblk, k + 2 nblk, ... (the tile of the
//      forward kernel, 2 x 4 x 32 voxels). Per tile it stages the haloed
//      input tile of its 16 channels (conv3_tile.cuh) and the cotangent
//      tile [Cout16][256 voxels] (zero past Cout and outside the volume).
//      Warp w owns the taps w, w + 8, w + 16, w + 24 (< 27); for each tap
//      and each 16-voxel step the A fragment (16 channels x 16 voxels) is
//      the staged tile read column-major at the tap's offset, with no
//      im2col copy, and B is the cotangent tile. At the end each block
//      writes its (27, 16, Cout16) partial sums.
//   2. conv3_dw_reduce_kernel: one thread per dW element sums the nblk
//      partials in block order.
//
// What bounds it on an H100: at 16 -> 16 on a 192^3 volume it does 98
// GFLOP on the tensor cores and reads 453 MB once, a bound of about
// 0.14 ms. Like the forward kernel it stages with scalar shared-memory
// stores and runs staging and MMAs in synchronised phases, so it is bound
// by the staging and its latency. At Cout = 64 the accumulators take 128
// registers a thread, so one 256-thread block fits on an SM.
#include <mma.h>

#include "conv3_tile.cuh"

using namespace nvcuda;
using namespace conv3;

namespace {

constexpr int GLD = TM + 8;  // leading dimension of the staged cotangent tile
constexpr int NT = 4;        // taps per warp: w, w + 8, w + 16, w + 24
constexpr int RTHREADS = 256;

template <int COUT>
constexpr size_t dw_smem_bytes() {
  return size_t(X_ELEMS + COUT * GLD) * sizeof(bf16);
}

template <int COUT>
__global__ void __launch_bounds__(THREADS)
conv3_dw_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        float* __restrict__ partial, int Cin, int Cout, int D, int H, int W,
                        int tiles_w, int tiles_h, int tiles_d, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + X_ELEMS;

  constexpr int NF = COUT / 16;
  const int warp = threadIdx.x >> 5;
  const int chunk = blockIdx.y;
  const int c0 = chunk * CK;
  const size_t hw = size_t(H) * W;
  const size_t vol = hw * D;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT][NF];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[j][nf], 0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tw = t % tiles_w;
    int r = t / tiles_w;
    const int th = r % tiles_h;
    r /= tiles_h;
    const int td = r % tiles_d;
    const int b = r / tiles_d;
    const int d0 = td * TD, h0 = th * TH, w0 = tw * TW;

    __syncthreads();  // every warp is done with the previous tile
    stage_halo(xs, x, b, c0, Cin, D, H, W, d0, h0, w0);
    for (int i = threadIdx.x; i < COUT * TM; i += THREADS) {
      const int co = i / TM;
      const int m = i - co * TM;
      const int gd = d0 + m / (TH * TW), gh = h0 + (m / TW) % TH, gw = w0 + m % TW;
      bf16 v = bf16_zero();
      if (co < Cout && gd < D && gh < H && gw < W)
        v = g[(size_t(b) * Cout + co) * vol + size_t(gd) * hw + size_t(gh) * W + gw];
      gs[co * GLD + m] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ks = 0; ks < TM / 16; ++ks) {  // 16 voxels per step, W fastest
      const int half = ks & 1;
      const int row = (ks >> 1) % TH;
      const int plane = (ks >> 1) / TH;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[NF];
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        wmma::load_matrix_sync(bfr[nf], gs + nf * 16 * GLD + ks * 16, GLD);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tap = warp + 8 * j;
        if (tap < 27) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, xs + tap_offset(plane, row, half, tap / 9, (tap / 3) % 3,
                                                    tap % 3), CK);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) wmma::mma_sync(acc[j][nf], a, bfr[nf], acc[j][nf]);
        }
      }
    }
  }

  float* out = partial + (size_t(blockIdx.x) * gridDim.y + chunk) * 27 * CK * COUT;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int tap = warp + 8 * j;
    if (tap < 27) {
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        wmma::store_matrix_sync(out + size_t(tap) * CK * COUT + nf * 16, acc[j][nf], COUT,
                                wmma::mem_row_major);
    }
  }
}

__global__ void __launch_bounds__(RTHREADS)
conv3_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int nblk,
                       int nchunk, int Cin, int Cout, int cout16) {
  const int i = blockIdx.x * RTHREADS + threadIdx.x;
  if (i >= 27 * Cin * Cout) return;
  const int co = i % Cout;
  const int r = i / Cout;
  const int ci = r % Cin;
  const int tap = r / Cin;
  const size_t stride = size_t(nchunk) * 27 * CK * cout16;  // one block's partials
  const float* p = partial + ((size_t(ci / CK) * 27 + tap) * CK + ci % CK) * cout16 + co;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += p[k * stride];
  dw[i] = s;
}

template <int COUT>
cudaError_t launch(const void* x, const void* g, void* partial, void* dw, int B, int Cin,
                   int Cout, int D, int H, int W, int nblk, cudaStream_t stream) {
  const int smem = int(dw_smem_bytes<COUT>());
  cudaError_t err = cudaFuncSetAttribute(conv3_dw_partial_kernel<COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH, tiles_d = (D + TD - 1) / TD;
  const int n_tiles = B * tiles_d * tiles_h * tiles_w;
  const int nchunk = (Cin + CK - 1) / CK;
  conv3_dw_partial_kernel<COUT><<<dim3(nblk, nchunk), THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(partial),
      Cin, Cout, D, H, W, tiles_w, tiles_h, tiles_d, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = 27 * Cin * Cout;
  conv3_dw_reduce_kernel<<<(n_out + RTHREADS - 1) / RTHREADS, RTHREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), nblk, nchunk, Cin, Cout,
      COUT);
  return cudaGetLastError();
}

}  // namespace

MMSEG_API int mmseg_conv3_dw(const void* x, const void* g, void* partial, void* dw, int B,
                             int Cin, int Cout, int D, int H, int W, int nblk, void* stream) {
  if (nblk < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Cout + 15) / 16) {
    case 1: return launch<16>(x, g, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    case 2: return launch<32>(x, g, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    case 3: return launch<48>(x, g, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    case 4: return launch<64>(x, g, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    default: return int(cudaErrorInvalidValue);
  }
}
