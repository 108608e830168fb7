// RMSNorm of each row, sm_90a: out = x * rsqrt(mean(x^2) + eps) * gamma.
//
// Replaces the TPU kernel rmsnorm_pallas (src/repro/kernels/rmsnorm.py).
// In the port it runs every norm of the serving round: the two of each
// transformer block and the final one (models/common.rmsnorm on a CUDA
// tensor), in one launch each instead of about six PyTorch ops.
//
// What bounds it: at decode sizes (a few rows of d = 4096) the latency of
// the launch and of the row's loads; beyond that the bytes (x read once,
// gamma once, out written once).
// What the design does about it:
//  * a block of 256 threads owns a row (on the H100 as fast as 128 a
//    row, faster than 512 or one row a warp: PERF.md). In the register
//    instantiations (NV > 0) each thread issues all its NV 16-byte loads
//    of the row (float4, or 8 bf16) -- and, while they fit in registers,
//    those of gamma -- before its first FMA, so the row costs one memory
//    latency, not d / 256 of them;
//    the row stays in registers and is scaled from there and stored with
//    16-byte stores: x is read once;
//  * the sum of squares is added per thread in a fixed order, then by a
//    butterfly within each warp and across the 8 warps in warp order
//    through shared memory (double-buffered: one barrier a row), so the
//    result is deterministic;
//  * rows whose d or stride is not a whole number of 16-byte vectors, or
//    whose d exceeds the registers (NV = 0), take the scalar instantiation:
//    the same reduction over a loop of 8 independent loads a thread, and a
//    second pass over the row;
//  * math in float32 whatever the storage type (float32 or bf16), cast
//    back to x's type, as the reference computes it.
#include "scalar.cuh"

namespace cdc {

// 16 bytes of the storage type: load, unpack to float32, pack and store.
template <typename TV>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  using R = float4;
  __device__ static R load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void unpack(const R& r, float (&f)[N]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  using R = uint4;
  __device__ static R load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const R& r, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[N]) {
    R r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<R*>(p) = r;
  }
};

constexpr int RMS_THREADS = 256;    // threads a row (one row a block)
constexpr int RMS_WARPS = RMS_THREADS / 32;
constexpr int RMS_MAX_VALUES = 128;  // values of the row a thread holds

template <typename TV, int NV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel(const TV* __restrict__ x, const float* __restrict__ gamma,
               TV* __restrict__ out, int rows, int d, int64_t ldx,
               float eps) {
  using P = Pack<TV>;
  constexpr int E = P::N;
  // gamma rides with x's loads while both fit in 64 registers
  constexpr bool EARLY_G = NV > 0 && NV * E <= 32;
  __shared__ float part[2][RMS_WARPS];
  const int t = threadIdx.x, lane = t & 31, wr = t >> 5;
  int phase = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const TV* xr = x + row * ldx;
    TV* orow = out + row * d;
    typename P::R v[NV > 0 ? NV : 1];
    float4 gv[EARLY_G ? NV * E / 4 : 1];
    float ss = 0.f;
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = (t + j * RMS_THREADS) * E;
        if (i < d) v[j] = P::load(xr + i);
        else v[j] = typename P::R{};
      }
      if constexpr (EARLY_G) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int i = (t + j * RMS_THREADS) * E;
#pragma unroll
          for (int q = 0; q < E / 4; ++q)
            gv[j * (E / 4) + q] =
                i < d ? __ldg(reinterpret_cast<const float4*>(gamma + i) + q)
                      : float4{};
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float f[E];
        P::unpack(v[j], f);
#pragma unroll
        for (int q = 0; q < E; ++q) ss = fmaf(f[q], f[q], ss);
      }
    } else {
      for (int i0 = t; i0 < d; i0 += 8 * RMS_THREADS) {
        float a[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = i0 + q * RMS_THREADS;
          a[q] = i < d ? ld(xr + i) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) ss = fmaf(a[q], a[q], ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) part[phase][wr] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < RMS_WARPS; ++w) ss += part[phase][w];
    phase ^= 1;
    const float inv = rsqrtf(ss / (float)d + eps);
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = (t + j * RMS_THREADS) * E;
        if (i >= d) continue;
        float f[E], gf[E];
        P::unpack(v[j], f);
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          float4 g4;
          if constexpr (EARLY_G)
            g4 = gv[j * (E / 4) + q];
          else
            g4 = __ldg(reinterpret_cast<const float4*>(gamma + i) + q);
          gf[4 * q] = g4.x;
          gf[4 * q + 1] = g4.y;
          gf[4 * q + 2] = g4.z;
          gf[4 * q + 3] = g4.w;
        }
#pragma unroll
        for (int q = 0; q < E; ++q) f[q] = f[q] * inv * gf[q];
        P::store(orow + i, f);
      }
    } else {
      for (int i = t; i < d; i += RMS_THREADS)
        st(orow + i, ld(xr + i) * inv * __ldg(gamma + i));
    }
  }
}

template <typename TV, int NV>
static int launch(const void* x, const float* gamma, void* out, int rows,
                  int d, long long ldx, float eps, cudaStream_t s) {
  if constexpr (NV * Pack<TV>::N > RMS_MAX_VALUES) {
    return (int)cudaErrorInvalidValue;
  } else {
    const dim3 grid(rows < 1048576 ? rows : 1048576);
    rmsnorm_kernel<TV, NV><<<grid, RMS_THREADS, 0, s>>>(
        static_cast<const TV*>(x), gamma, static_cast<TV*>(out), rows, d,
        ldx, eps);
    return (int)cudaGetLastError();
  }
}

// The instantiations: NV in {0 (scalar), 1, 2, 4, 8, 16, 32} 16-byte
// vectors a thread, up to RMS_MAX_VALUES values.
template <typename TV>
static int pick_nv(int nv, const void* x, const float* gamma, void* out,
                   int rows, int d, long long ldx, float eps,
                   cudaStream_t s) {
  switch (nv) {
    case 0:
      return launch<TV, 0>(x, gamma, out, rows, d, ldx, eps, s);
    case 1:
      return launch<TV, 1>(x, gamma, out, rows, d, ldx, eps, s);
    case 2:
      return launch<TV, 2>(x, gamma, out, rows, d, ldx, eps, s);
    case 4:
      return launch<TV, 4>(x, gamma, out, rows, d, ldx, eps, s);
    case 8:
      return launch<TV, 8>(x, gamma, out, rows, d, ldx, eps, s);
    case 16:
      return launch<TV, 16>(x, gamma, out, rows, d, ldx, eps, s);
    case 32:
      return launch<TV, 32>(x, gamma, out, rows, d, ldx, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cdc

// C interface (loaded with ctypes). x [rows, d] with contiguous rows at
// stride ldx (elements) and out [rows, d] contiguous, of one storage type
// (bf16 = 1: bfloat16, else float32); gamma [d] float32. nv is the plan of
// kernels/rmsnorm.py: rmsnorm_plan; a plan the kernel cannot run
// (nv vectors of 16 bytes a thread that miss d, a d or stride that is not
// whole vectors, a base that is not 16-byte aligned) returns
// cudaErrorInvalidValue. Otherwise the cudaError_t of the launch.
extern "C" int cdc_rmsnorm(const void* x, const float* gamma, void* out,
                           int rows, int d, long long ldx, float eps,
                           int bf16, int nv, void* stream) {
  using namespace cdc;
  if (rows < 1 || d < 1 || ldx < d || nv < 0)
    return (int)cudaErrorInvalidValue;
  if (nv > 0) {
    const int e = bf16 ? 8 : 4;
    const bool ok = d % e == 0 && ldx % e == 0 &&
                    (long long)nv * RMS_THREADS * e >= d &&
                    ((uintptr_t)x | (uintptr_t)out | (uintptr_t)gamma) % 16 ==
                        0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pick_nv<__nv_bfloat16>(nv, x, gamma, out, rows, d, ldx, eps, s);
  return pick_nv<float>(nv, x, gamma, out, rows, d, ldx, eps, s);
}
