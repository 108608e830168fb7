// Gradient of the row RMSNorm, sm_90a: for y = x * rstd * gamma with
// rstd = rsqrt(mean(x^2) + eps),
//   dx     = rstd * (dy * gamma) - x * rstd^3 * mean(dy * gamma * x)
//   dgamma = sum over rows of dy * x * rstd.
//
// Replaces no TPU kernel: the reference trains through its plain rmsnorm
// (src/repro/models/common.py:155) and lets jax.grad differentiate it. The
// port runs its forward norms through kernel 6 (csrc/rmsnorm.cu), whose
// output has no autograd history, so kernels/rmsnorm.py wraps it in a
// torch.autograd.Function whose backward is this kernel.
//
// What bounds it: bytes. x and dy are read once and dx written once (3
// rows x d float32 values a row); the arithmetic is ~10 flops an element.
// What the design does about it:
//  * rows pass (rmsnorm_bwd_rows): a block of 256 threads walks rows
//    (row = block, block + grid, ...). In the register instantiations (NV
//    > 0) each thread issues all its NV 16-byte loads of the row's x and dy
//    before its first FMA, keeps them in registers, and gamma in registers
//    for the whole walk (read once a block); the two row sums (x^2 and
//    dy*gamma*x) are reduced by a butterfly in each warp, then across the
//    8 warps in warp order through double-buffered shared memory (one
//    barrier a row). dx is stored with 16-byte stores;
//  * dgamma without atomics: each thread adds dy*x*rstd of its columns over
//    the block's rows in registers, in row order, and the block writes its
//    partial sums to its own row of a float32 scratch [blocks, d]; the
//    columns pass (rmsnorm_bwd_cols) adds the blocks' rows in a fixed order
//    (warp w takes blocks w, w + 8, ...; then the 8 warps in warp order).
//    The grid is fixed by the wrapper from rows alone, so two calls on the
//    same inputs give the same bits;
//  * rows whose d or stride is not a whole number of 16-byte vectors, or
//    whose d exceeds the registers (NV = 0), take the scalar instantiation:
//    two passes over the row a thread, the partial sums kept in the
//    block's scratch row (read and written only by the thread that owns
//    the column, so still no atomics).
// float32 only: the reference trains in float32.
#include "scalar.cuh"

namespace cdc {

constexpr int BWD_THREADS = 256;    // threads a block (RMS_THREADS)
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_NV = 8;       // 16-byte vectors a thread holds
constexpr int COLS_BLOCK = 32;      // columns a block of the second pass

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Both row sums over the block, in a fixed order; buf is the phase's half
// of the double buffer.
__device__ __forceinline__ void block_sums(float& a, float& b,
                                           float (*buf)[BWD_WARPS]) {
  const int lane = threadIdx.x & 31, wr = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    buf[0][wr] = a;
    buf[1][wr] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < BWD_WARPS; ++w) {
    a += buf[0][w];
    b += buf[1][w];
  }
}

template <int NV>
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_rows(const float* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ part, int rows, int d, int64_t ldx,
                 float eps) {
  __shared__ float red[2][2][BWD_WARPS];
  const int t = threadIdx.x;
  float* prow = part + (int64_t)blockIdx.x * d;
  const float inv_d = 1.f / (float)d;
  int phase = 0;
  if constexpr (NV > 0) {
    float4 g[NV], acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = (t + j * BWD_THREADS) * 4;
      g[j] = i < d ? ld4(gamma + i) : float4{};
      acc[j] = float4{};
    }
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
      const float* xr = x + row * ldx;
      const float* dyr = dy + row * d;
      float4 xv[NV], dv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = (t + j * BWD_THREADS) * 4;
        xv[j] = i < d ? ld4(xr + i) : float4{};
        dv[j] = i < d ? ld4(dyr + i) : float4{};
      }
      float ss = 0.f, sd = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xq = comp(xv[j], q);
          ss = fmaf(xq, xq, ss);
          sd = fmaf(comp(dv[j], q) * comp(g[j], q), xq, sd);
        }
      }
      block_sums(ss, sd, red[phase]);
      phase ^= 1;
      const float rstd = rsqrtf(ss * inv_d + eps);
      const float c = rstd * rstd * rstd * (sd * inv_d);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = (t + j * BWD_THREADS) * 4;
        if (i >= d) continue;
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xq = comp(xv[j], q), dq = comp(dv[j], q);
          o[q] = rstd * (dq * comp(g[j], q)) - xq * c;
        }
        *reinterpret_cast<float4*>(dx + row * d + i) =
            make_float4(o[0], o[1], o[2], o[3]);
        acc[j].x = fmaf(dv[j].x * xv[j].x, rstd, acc[j].x);
        acc[j].y = fmaf(dv[j].y * xv[j].y, rstd, acc[j].y);
        acc[j].z = fmaf(dv[j].z * xv[j].z, rstd, acc[j].z);
        acc[j].w = fmaf(dv[j].w * xv[j].w, rstd, acc[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = (t + j * BWD_THREADS) * 4;
      if (i < d) *reinterpret_cast<float4*>(prow + i) = acc[j];
    }
  } else {
    for (int i = t; i < d; i += BWD_THREADS) prow[i] = 0.f;
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
      const float* xr = x + row * ldx;
      const float* dyr = dy + row * d;
      float ss = 0.f, sd = 0.f;
      for (int i0 = t; i0 < d; i0 += 4 * BWD_THREADS) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q * BWD_THREADS;
          a[q] = i < d ? __ldg(xr + i) : 0.f;
          b[q] = i < d ? __ldg(dyr + i) * __ldg(gamma + i) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ss = fmaf(a[q], a[q], ss);
          sd = fmaf(b[q], a[q], sd);
        }
      }
      block_sums(ss, sd, red[phase]);
      phase ^= 1;
      const float rstd = rsqrtf(ss * inv_d + eps);
      const float c = rstd * rstd * rstd * (sd * inv_d);
      for (int i = t; i < d; i += BWD_THREADS) {
        const float xq = __ldg(xr + i), dq = __ldg(dyr + i);
        dx[row * d + i] = rstd * (dq * __ldg(gamma + i)) - xq * c;
        prow[i] = fmaf(dq * xq, rstd, prow[i]);
      }
    }
  }
}

// dgamma[col] = sum over b of part[b, col], in a fixed order.
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_cols(const float* __restrict__ part, float* __restrict__ dgamma,
                 int blocks, int d) {
  __shared__ float s[BWD_WARPS][COLS_BLOCK + 1];
  const int lane = threadIdx.x & 31, wr = threadIdx.x >> 5;
  const int col = blockIdx.x * COLS_BLOCK + lane;
  float a = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int b = wr; b < blocks; b += BWD_WARPS)
      a += __ldg(part + (int64_t)b * d + col);
  }
  s[wr][lane] = a;
  __syncthreads();
  if (wr == 0 && col < d) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) sum += s[w][lane];
    dgamma[col] = sum;
  }
}

template <int NV>
static int launch(const float* x, const float* gamma, const float* dy,
                  float* dx, float* dgamma, float* part, int rows, int d,
                  long long ldx, float eps, int blocks, cudaStream_t s) {
  rmsnorm_bwd_rows<NV><<<blocks, BWD_THREADS, 0, s>>>(
      x, gamma, dy, dx, part, rows, d, ldx, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int cols = (d + COLS_BLOCK - 1) / COLS_BLOCK;
  rmsnorm_bwd_cols<<<cols, BWD_THREADS, 0, s>>>(part, dgamma, blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace cdc

// C interface (loaded with ctypes). float32 throughout: x [rows, d] with
// contiguous rows at stride ldx (elements), gamma [d], dy and dx [rows, d]
// contiguous, dgamma [d], part [blocks, d] scratch (1 <= blocks <= rows;
// every row of it is written). nv is the plan of kernels/rmsnorm.py:
// rmsnorm_bwd_plan, 16-byte vectors a thread in {0 (scalar), 1, 2, 4, 8};
// a plan the kernel cannot run (vectors that miss d, a d or stride that is
// not whole vectors, a base that is not 16-byte aligned) returns
// cudaErrorInvalidValue. Otherwise the cudaError_t of the two launches.
extern "C" int cdc_rmsnorm_bwd(const float* x, const float* gamma,
                               const float* dy, float* dx, float* dgamma,
                               float* part, int rows, int d, long long ldx,
                               float eps, int blocks, int nv, void* stream) {
  using namespace cdc;
  if (rows < 1 || d < 1 || ldx < d || blocks < 1 || blocks > rows)
    return (int)cudaErrorInvalidValue;
  if (nv > 0) {
    const bool ok = nv <= BWD_MAX_NV && d % 4 == 0 && ldx % 4 == 0 &&
                    (long long)nv * BWD_THREADS * 4 >= d &&
                    ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)dy |
                     (uintptr_t)dx | (uintptr_t)part) % 16 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 0:
      return launch<0>(x, gamma, dy, dx, dgamma, part, rows, d, ldx, eps,
                       blocks, s);
    case 1:
      return launch<1>(x, gamma, dy, dx, dgamma, part, rows, d, ldx, eps,
                       blocks, s);
    case 2:
      return launch<2>(x, gamma, dy, dx, dgamma, part, rows, d, ldx, eps,
                       blocks, s);
    case 4:
      return launch<4>(x, gamma, dy, dx, dgamma, part, rows, d, ldx, eps,
                       blocks, s);
    case 8:
      return launch<8>(x, gamma, dy, dx, dgamma, part, rows, d, ldx, eps,
                       blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
