// Element access and warp reductions shared by the port's kernels.
//
// Every kernel computes in float32; ld()/st() convert from and to the
// storage type (float or bf16) with the intrinsics, so the kernels build
// under any of nvcc's half/bf16 conversion settings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cdc {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Butterfly sum over the 32 lanes: every lane gets the same total, and the
// order of the additions is fixed, so the result is deterministic.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace cdc
