// The fp32 3x3x3 conv bodies' shared helpers (conv3_f32.cu: the forward,
// its fused variants and the dx; conv3_dw_f32.cu: the weight gradient):
// the cp.async pieces of their fallback staging, and the fused block's
// input prologue.
//
// The prologue (the fused block's boundary conv and its weight gradient)
// is relu(x * a + t), a, t fp32 per (batch, channel), x * a + t rounded
// after each operation (no FMA contraction, as the plain version computes
// it; a contracted u could flip the dx mask of the backward at u ~ 0, a
// whole dr * a at one voxel). The bodies apply it on the staged voxels
// inside the volume and below Cin only: the halo and the zero-filled
// channels stay 0 (relu(t) is not 0 where t > 0).
#pragma once

#include "common.cuh"

namespace conv3f32 {

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The prologue's value of one staged voxel: x * a + t rounded after each
// operation, ReLU that keeps a NaN (as jnp.maximum does).
__device__ __forceinline__ float prologue(float v, float a, float t) {
  const float u = __fadd_rn(__fmul_rn(v, a), t);
  return u < 0.0f ? 0.0f : u;
}

}  // namespace conv3f32
