// Shared helpers for the hand-written Hopper kernels of the port.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_build.py): device pointers and the CUDA stream arrive as void*,
// sizes as int. An entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MMSEG_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16((unsigned short)0); }
