// The output tile, the operand layouts and the input staging of the
// forward 3x3x3 conv body (conv3.cu: the forward, its fused variants and
// the dx; and conv3_dw.cu, the weight gradient). It includes conv3_tile.cuh;
// from there this header takes only the prologue's rounding.
//
// A block covers TD x TH x TW output voxels of one batch element: TD * TH
// output rows of TW = 16 voxels along W, each row one m16 tile of the
// implicit GEMM. Per chunk of CK = 16 input channels the MMAs read:
//   * the haloed input tile, X_VOX = (TD+2)(TH+2)(TW+2) voxels, channel
//     minor: voxel v is a 32-byte row of its 16 channels;
//   * the weight slab, 27 * COUT rows of 32 bytes: row (tap, cout) holds
//     the 16 input channels of the chunk (the wrapper's packing,
//     ops/conv3.py:pack_weights, is this image before the swizzle).
// Both are read by ldmatrix, eight 16-byte rows per 8x8 matrix. A 32-byte
// row pitch puts rows r and r + 4 on the same banks, so the two 16-byte
// halves of a row swap places where bit 2 of the row index is set
// (swz()): any eight consecutive rows then fill all 32 banks once. That
// holds for the A operand at every tap shift (kw moves the rows by one
// voxel, not by a 16-byte multiple) and for the B operand.
//
// Global memory is W-minor and the operand tile is channel-minor, so the
// input goes through a raw tile first, W-minor as in global memory: per
// staged row (channel, plane, row) the 16 voxels [w0, w0 + 16) and the
// pairs (w0 - 2, w0 - 1), (w0 + 16, w0 + 17) around them, of which the
// conv reads w0 - 1 and w0 + 16. When W is a multiple of 8 and x is
// 16-byte aligned, every piece is one cp.async (16 or 4 bytes, zero-filled
// outside the volume and past Cin); otherwise the same pieces are loaded
// 2 bytes at a time and stored by the threads. One transform pass then
// writes the channel-minor tile, one 4-byte word (two channels) per voxel,
// through the prologue when PRO is set, on voxels inside the volume only:
// the SAME halo stays 0.
#pragma once

#include "conv3_tile.cuh"

namespace conv3f {

constexpr int TD = 4;              // output depth planes per block
constexpr int TH = 8;              // output rows per plane
constexpr int TW = 16;             // output columns per row: one m16 tile
constexpr int TM = TD * TH * TW;   // output voxels per block
constexpr int CK = 16;             // input channels per chunk
constexpr int DR = TD + 2;         // haloed tile planes
constexpr int HR = TH + 2;         // haloed tile rows
constexpr int WR = TW + 2;         // haloed tile columns
constexpr int X_VOX = DR * HR * WR;
constexpr int ROW_BYTES = 2 * CK;  // one staged voxel or weight row
constexpr int MF = 2;              // output rows (m16 tiles) per warp
constexpr int WARPS = TD * TH / MF;
constexpr int THREADS = 32 * WARPS;
constexpr int PAIRS = CK / 2;      // channel pairs per staged row
constexpr int RAW_ROWS = DR * HR;  // staged rows per channel
constexpr int RAW_MID_BYTES = RAW_ROWS * CK * 2 * TW;  // [row][channel] x 16 voxels
constexpr int RAW_EDGE_BYTES = RAW_ROWS * CK * 8;      // [row][channel] x 2 pairs
constexpr int RAW_BYTES = RAW_MID_BYTES + RAW_EDGE_BYTES;
static_assert(TW == 16, "an output row is one m16 tile");

// Byte offset of half `half` (channels 8 half .. 8 half + 7) of staged row r.
__device__ __forceinline__ uint32_t swz(int r, int half) {
  return uint32_t(r) * ROW_BYTES + (uint32_t(half ^ ((r >> 2) & 1)) << 4);
}

// Byte offset in the raw tile of 16-byte piece g (voxels w0 + 8 g ..) of
// staged row rc = row * CK + channel. The low bits of the piece index take
// (piece >> 3) & 3, so that the eight channel pairs of one row, which the
// transform reads at once, land on eight different groups of banks.
__device__ __forceinline__ uint32_t raw_mid(int rc, int g) {
  const uint32_t q = uint32_t(rc) * 2 + g;
  return (q ^ ((q >> 3) & 3)) << 4;
}
__device__ __forceinline__ uint32_t raw_edge(int rc, int right) {
  return RAW_MID_BYTES + uint32_t(rc) * 8 + 4 * right;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct TileAt {
  int b, c0, Cin, D, H, W, d0, h0, w0;
};

// Issue the raw tile of channels [c0, c0 + 16) into raw (a shared address
// for cp.async, raw_g the same memory for plain stores). vec: W is a
// multiple of 8 and x is 16-byte aligned, so each piece is aligned and
// lies wholly inside or wholly outside the volume.
__device__ __forceinline__ void load_raw(uint32_t raw, unsigned char* raw_g,
                                         const bf16* __restrict__ x, const TileAt& t, bool vec) {
  const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);
  for (int u = threadIdx.x; u < RAW_ROWS * CK * 4; u += THREADS) {
    const int rc = u >> 2, piece = u & 3;  // pieces 0, 1: voxels w0 + 8 piece ..; 2, 3: pairs
    const int row = rc / CK, c = t.c0 + rc % CK;
    const int gd = t.d0 + row / HR - 1, gh = t.h0 + row % HR - 1;
    const bool ok = c < t.Cin && gd >= 0 && gd < t.D && gh >= 0 && gh < t.H;
    const unsigned short* src =
        ok ? xu + ((size_t(t.b) * t.Cin + c) * t.D + gd) * size_t(t.H) * t.W + size_t(gh) * t.W
           : xu;
    const int w_first = piece < 2 ? t.w0 + 8 * piece : piece == 2 ? t.w0 - 2 : t.w0 + TW;
    const int n = piece < 2 ? 8 : 2;
    const uint32_t dst = piece < 2 ? raw_mid(rc, piece) : raw_edge(rc, piece - 2);
    if (vec) {
      const bool in = ok && w_first >= 0 && w_first + n <= t.W;
      const void* s = in ? src + w_first : xu;
      if (piece < 2) cp_async16(raw + dst, s, in);
      else cp_async4(raw + dst, s, in);
    } else {
      unsigned short* d = reinterpret_cast<unsigned short*>(raw_g + dst);
      for (int e = 0; e < n; ++e) {
        const int gw = w_first + e;
        d[e] = ok && gw >= 0 && gw < t.W ? src[gw] : (unsigned short)0;
      }
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Staged column xx (0 .. WR - 1, voxel w0 - 1 + xx) of one channel's raw
// row: mid[0..1] its 16 voxels, edge its two pairs.
__device__ __forceinline__ unsigned short column(const uint4 (&mid)[2], const uint2& edge,
                                                 int xx) {
  if (xx == 0) return (unsigned short)(edge.x >> 16);        // w0 - 1
  if (xx == WR - 1) return (unsigned short)(edge.y & 0xffffu);  // w0 + 16
  const int k = xx - 1;
  return (unsigned short)(word_of(mid[k >> 3], (k & 7) >> 1) >> (16 * (k & 1)));
}

// Write the raw tile channel minor into xs (swizzled rows), through the
// prologue when PRO: bf16(relu(x * a + t)) on voxels inside the volume.
template <bool PRO>
__device__ __forceinline__ void transform(unsigned char* __restrict__ xs,
                                          const unsigned char* __restrict__ raw,
                                          const float* __restrict__ pa,
                                          const float* __restrict__ pt, const TileAt& t) {
  for (int item = threadIdx.x; item < RAW_ROWS * PAIRS; item += THREADS) {
    const int pair = item % PAIRS, row = item / PAIRS;
    uint4 mid[2][2];
    uint2 edge[2];
    float a[2] = {0.0f, 0.0f}, sh[2] = {0.0f, 0.0f};
    bool ok[2] = {false, false};  // PRO: the channel exists and the row is inside
    const int gd = t.d0 + row / HR - 1, gh = t.h0 + row % HR - 1;
    const bool row_in = gd >= 0 && gd < t.D && gh >= 0 && gh < t.H;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const int rc = row * CK + 2 * pair + ch;
      mid[ch][0] = *reinterpret_cast<const uint4*>(raw + raw_mid(rc, 0));
      mid[ch][1] = *reinterpret_cast<const uint4*>(raw + raw_mid(rc, 1));
      edge[ch] = *reinterpret_cast<const uint2*>(raw + raw_edge(rc, 0));
      const int c = t.c0 + 2 * pair + ch;
      if (PRO) {
        ok[ch] = row_in && c < t.Cin;
        if (ok[ch]) a[ch] = pa[t.b * t.Cin + c], sh[ch] = pt[t.b * t.Cin + c];
      }
    }
    // The four rows a warp writes at once are consecutive: rows 2 and 3
    // (mod 4) write column xx + 1 where rows 0 and 1 write xx, so that the
    // four 32-byte voxels land on four different groups of banks.
    const int skew = (row >> 1) & 1;
    const uint32_t lane_bytes = uint32_t(pair & 3) * 4;
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int xx = skew ? (i + 1) % WR : i;
      const int gw = t.w0 - 1 + xx;
      uint32_t v[2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        unsigned short u = skew ? column(mid[ch], edge[ch], (i + 1) % WR)
                                : column(mid[ch], edge[ch], i);
        if (PRO && ok[ch] && gw >= 0 && gw < t.W)
          u = __bfloat16_as_ushort(conv3::prologue(__ushort_as_bfloat16(u), a[ch], sh[ch]));
        v[ch] = u;
      }
      const int vox = row * WR + xx;
      *reinterpret_cast<uint32_t*>(xs + swz(vox, pair >> 2) + lane_bytes) = v[0] | (v[1] << 16);
    }
  }
}

}  // namespace conv3f
