// Element access and warp reductions shared by the port's kernels.
//
// Every kernel computes in float32; ld()/st() convert from and to the
// storage type (float or bf16) with the intrinsics, so the kernels build
// under any of nvcc's half/bf16 conversion settings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cdc {

// The widest code (T shards, and r <= T parity rows) any kernel takes.
constexpr int MAX_T = 16;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// The stored element itself (no conversion), through the read-only path.
__device__ __forceinline__ float ldraw(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldraw(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Store v at out[i] as bfloat16 (bf16 != 0) or float32: the output type
// of a kernel whose output follows its input's storage type.
__device__ __forceinline__ void st_as(void* out, int bf16, int64_t i,
                                      float v) {
  if (bf16)
    st(static_cast<__nv_bfloat16*>(out) + i, v);
  else
    static_cast<float*>(out)[i] = v;
}

// V consecutive elements of storage type TV held in registers as they were
// loaded (R), 16 bytes at a time (4 float32 or 8 bf16) or one element:
// load/store move the raw vector through one 16-byte access; get/set read
// and write element q (a constant after unrolling) as float32, set
// rounding to bf16 to nearest even.
template <int V, typename TV>
struct VecIO;
template <>
struct VecIO<1, float> {
  using R = float;
  static __device__ __forceinline__ R load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const R& r) {
    *p = r;
  }
  static __device__ __forceinline__ float get(const R& r, int) { return r; }
  static __device__ __forceinline__ void set(R& r, int, float v) { r = v; }
};
template <>
struct VecIO<1, __nv_bfloat16> {
  using R = __nv_bfloat16;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p) {
    return ldraw(p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const R& r) {
    *p = r;
  }
  static __device__ __forceinline__ float get(const R& r, int) {
    return __bfloat162float(r);
  }
  static __device__ __forceinline__ void set(R& r, int, float v) {
    r = __float2bfloat16(v);
  }
};
template <>
struct VecIO<4, float> {
  using R = float4;
  static __device__ __forceinline__ R load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const R& r) {
    *reinterpret_cast<float4*>(p) = r;
  }
  static __device__ __forceinline__ float get(const R& r, int q) {
    return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  }
  static __device__ __forceinline__ void set(R& r, int q, float v) {
    if (q == 0) r.x = v;
    else if (q == 1) r.y = v;
    else if (q == 2) r.z = v;
    else r.w = v;
  }
};
template <>
struct VecIO<8, __nv_bfloat16> {
  using R = uint4;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const R& r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
  static __device__ __forceinline__ uint32_t word(const R& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
  // bf16 is the high half of a float32: widening is exact
  static __device__ __forceinline__ float get(const R& r, int q) {
    const uint32_t w = word(r, q >> 1);
    return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void set(R& r, int q, float v) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(v));
    uint32_t w = word(r, q >> 1);
    w = (q & 1) ? ((w & 0x0000ffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
    const int i = q >> 1;
    if (i == 0) r.x = w;
    else if (i == 1) r.y = w;
    else if (i == 2) r.z = w;
    else r.w = w;
  }
};

// Butterfly sum over the 32 lanes: every lane gets the same total, and the
// order of the additions is fixed, so the result is deterministic.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace cdc
