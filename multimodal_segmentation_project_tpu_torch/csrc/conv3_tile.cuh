// The output tile and haloed input tile shared by the 3x3x3 conv kernels
// (conv3.cu: forward and dx; conv3_dw.cu: weight gradient).
//
// A block covers TD x TH x TW output voxels of one batch element. Per
// chunk of CK = 16 input channels it stages the haloed input tile
// [TD+2][TH+2][TW+2][16] in shared memory, channel minor, so that for any
// tap (kd, kh, kw) the 16 channels of 16 consecutive voxels along W are a
// contiguous 16x16 bf16 tile: row-major (voxel, channel) for a WMMA A
// fragment of the forward, column-major (channel, voxel) for the dW
// product. Loads outside the volume, and channels past Cin, are zero: that
// is the SAME halo, and no padded copy of x exists.
#pragma once

#include "common.cuh"

namespace conv3 {

constexpr int TD = 2;         // output depth planes per block
constexpr int TH = 4;         // output rows per plane
constexpr int TW = 32;        // output columns per row
constexpr int TM = TD * TH * TW;  // output voxels per block
constexpr int CK = 16;        // input channels per chunk
constexpr int DR = TD + 2;    // haloed tile planes
constexpr int HR = TH + 2;    // haloed tile rows
constexpr int WR = TW + 2;    // haloed tile columns
constexpr int X_ELEMS = DR * HR * WR * CK;
constexpr int THREADS = 32 * TD * TH;  // one warp per output row

// Stage channels [c0, c0 + 16) of the haloed input tile whose output
// corner is (d0, h0, w0) in batch element b.
__device__ __forceinline__ void stage_halo(bf16* __restrict__ xs, const bf16* __restrict__ x,
                                           int b, int c0, int Cin, int D, int H, int W,
                                           int d0, int h0, int w0) {
  const size_t hw = size_t(H) * W;
  const size_t vol = hw * D;
  for (int i = threadIdx.x; i < X_ELEMS; i += THREADS) {
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
}

// Element offset in the staged tile of the first of the 16 voxels that
// output row (plane, row), half `half`, reads at tap (kd, kh, kw).
__device__ __forceinline__ int tap_offset(int plane, int row, int half, int kd, int kh, int kw) {
  return (((plane + kd) * HR + row + kh) * WR + half * 16 + kw) * CK;
}

}  // namespace conv3
