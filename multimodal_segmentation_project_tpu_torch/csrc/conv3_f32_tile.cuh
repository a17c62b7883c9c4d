// The staged input tile of the fp32 3x3x3 conv bodies (conv3_f32.cu: the
// forward, its fused variants and the dx; conv3_dw_f32.cu: the weight
// gradient), and the fused block's input prologue on it.
//
// A block's output tile is TD x TH x TW = 4 x 8 x 16 voxels of one batch
// element (a TW that divides 48, 96 and 192). Its haloed input is staged
// W-minor as in device memory, so cp.async copies it as it is: per channel
// ROWS = (TD + 2)(TH + 2) rows (plane, row) at a pitch of PITCH = 20
// floats, voxels [w0, w0 + 16) at 0..15, w0 - 1 at LEFT = 16 and w0 + 16 at
// RIGHT = 17, zero-filled outside the volume (the SAME halo) and past Cin;
// 16 bytes a piece where W % 4 == 0 and x is 16-byte aligned (each piece
// then lies wholly inside or outside the volume), else 4. The pitch (5 x 16
// bytes) puts the 16-byte reads of 8 consecutive rows on 8 different
// groups of banks.
//
// The prologue (the fused block's boundary conv and its weight gradient)
// rewrites a landed stage in place as relu(x * a + t), a, t fp32 per
// (batch, channel), x * a + t rounded after each operation (no FMA
// contraction, as the plain version computes it; a contracted u could flip
// the dx mask of the backward at u ~ 0, a whole dr * a at one voxel), on
// the staged voxels inside the volume and below Cin only: the halo and the
// zero-filled channels stay 0 (relu(t) is not 0 where t > 0).
#pragma once

#include "common.cuh"

namespace conv3f32 {

constexpr int TD = 4;               // output depth planes per tile
constexpr int TH = 8;               // output rows per plane
constexpr int TW = 16;              // output columns per row
constexpr int DR = TD + 2;          // haloed tile planes
constexpr int HR = TH + 2;          // haloed tile rows
constexpr int ROWS = DR * HR;       // staged rows per input channel
constexpr int PITCH = 20;           // floats per staged row
constexpr int LEFT = 16;            // the staged row's voxel w0 - 1
constexpr int RIGHT = 17;           // and w0 + 16
constexpr int THREADS = 256;        // threads of a block of either body
static_assert(PITCH % 4 == 0 && (PITCH / 4) % 2 == 1, "16-byte rows on distinct bank groups");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue (not commit) the haloed input of channels [c0, c0 + NCH) of batch
// element b around the output tile at (d0, h0, w0) of x (B, Cin, D, H, W)
// into the stage at shared address st. vec: W % 4 == 0 and x is 16-byte
// aligned. Per staged row, pieces 0..3 are the voxels w0 + 4 k .. w0 + 4 k
// + 3, 4 the voxel w0 - 1, 5 the voxel w0 + 16.
template <int NCH>
__device__ __forceinline__ void issue_input(uint32_t st, const float* x, int Cin, int D, int H,
                                            int W, int b, int c0, int d0, int h0, int w0,
                                            bool vec) {
  for (int i = threadIdx.x; i < NCH * ROWS * 6; i += THREADS) {
    const int piece = i % 6, cr = i / 6;  // cr = channel * ROWS + row
    const int c = c0 + cr / ROWS, row = cr % ROWS;
    const int gd = d0 - 1 + row / HR, gh = h0 - 1 + row % HR;
    const bool ok = c < Cin && gd >= 0 && gd < D && gh >= 0 && gh < H;
    const float* src =
        ok ? x + ((size_t(b) * Cin + c) * D + gd) * size_t(H) * W + size_t(gh) * W : x;
    const uint32_t dst = st + uint32_t(cr * PITCH) * 4u;
    if (piece < 4) {
      const int w = w0 + 4 * piece;
      if (vec) {
        const bool in = ok && w < W;
        cp_async16(dst + 16u * piece, in ? src + w : x, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = ok && w + e < W;
          cp_async4(dst + 4u * (4 * piece + e), in ? src + w + e : x, in);
        }
      }
    } else {
      const int w = piece == 4 ? w0 - 1 : w0 + TW;
      const bool in = ok && w >= 0 && w < W;
      cp_async4(dst + 4u * (piece == 4 ? LEFT : RIGHT), in ? src + w : x, in);
    }
  }
}

// The prologue's value of one staged voxel: x * a + t rounded after each
// operation, ReLU that keeps a NaN (as jnp.maximum does).
__device__ __forceinline__ float prologue(float v, float a, float t) {
  const float u = __fadd_rn(__fmul_rn(v, a), t);
  return u < 0.0f ? 0.0f : u;
}

// relu(x * a + t) in place on the landed stage xs that issue_input<NCH>
// filled for the same (b, c0, d0, h0, w0), with pa, pt (B, Cin); the
// pieces outside the volume or past Cin stay 0.
template <int NCH>
__device__ __forceinline__ void prologue_input(float* xs, const float* pa, const float* pt,
                                               int Cin, int D, int H, int W, int b, int c0,
                                               int d0, int h0, int w0) {
  for (int i = threadIdx.x; i < NCH * ROWS * 6; i += THREADS) {
    const int piece = i % 6, cr = i / 6;  // cr = channel * ROWS + row
    const int c = c0 + cr / ROWS, row = cr % ROWS;
    const int gd = d0 - 1 + row / HR, gh = h0 - 1 + row % HR;
    if (c >= Cin || gd < 0 || gd >= D || gh < 0 || gh >= H) continue;
    const float a = pa[b * Cin + c], t = pt[b * Cin + c];
    float* r = xs + cr * PITCH;
    if (piece < 4) {
      const int w = w0 + 4 * piece;
      float4 q = reinterpret_cast<float4*>(r)[piece];
      if (w < W) q.x = prologue(q.x, a, t);
      if (w + 1 < W) q.y = prologue(q.y, a, t);
      if (w + 2 < W) q.z = prologue(q.z, a, t);
      if (w + 3 < W) q.w = prologue(q.w, a, t);
      reinterpret_cast<float4*>(r)[piece] = q;
    } else {
      const int w = piece == 4 ? w0 - 1 : w0 + TW;
      float& v = r[piece == 4 ? LEFT : RIGHT];
      if (w >= 0 && w < W) v = prologue(v, a, t);
    }
  }
}

}  // namespace conv3f32
