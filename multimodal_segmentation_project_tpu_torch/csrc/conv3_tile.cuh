// The input prologue shared by the 3x3x3 conv kernels (conv3_fwd_tile.cuh:
// the forward body's staging, which the weight-gradient body uses too).
//
// The optional prologue (PRO = true) stages bf16(max(x * a + t, 0)) in
// place of x, with fp32 a, t per (batch, channel): the preceding conv's
// training-mode BatchNorm, ReLU and Dropout3d folded into one affine. It
// runs only on voxels inside the volume, so the halo stays 0 (relu(t) is
// not 0 where t > 0).
#pragma once

#include "common.cuh"

namespace conv3 {

// The prologue's value of one voxel: x * a + t rounded after each fp32
// operation (no FMA contraction, as the plain version computes it), ReLU
// that keeps a NaN (as jnp.maximum does), one cast.
__device__ __forceinline__ bf16 prologue(bf16 v, float a, float t) {
  float u = __fadd_rn(__fmul_rn(__bfloat162float(v), a), t);
  u = u < 0.0f ? 0.0f : u;
  return __float2bfloat16(u);
}

}  // namespace conv3
