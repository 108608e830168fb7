// RMSNorm of each row, sm_90a: out = x * rsqrt(mean(x^2) + eps) * gamma.
//
// Replaces the TPU kernel rmsnorm_pallas (src/repro/kernels/rmsnorm.py).
// In the port it runs every norm of the serving round: the two of each
// transformer block and the final one (models/common.rmsnorm on a CUDA
// tensor), in one launch each instead of about six PyTorch ops.
//
// What bounds it: two passes over a row with a reduction between them; at
// decode sizes (a few rows of d = 4096) the launch itself, and beyond
// that the bytes (x read once, gamma once, out written once).
// What the design does about it:
//  * one block of 256 threads per row: the sum of squares is taken per
//    thread over a fixed stride, then by a butterfly within each warp and
//    over the 8 warps in warp order, so the result is deterministic;
//  * the second pass re-reads the row, which a block just brought into L1;
//  * math in float32 whatever the storage type (float32 or bf16), cast
//    back to x's type, as the reference computes it.
#include "scalar.cuh"

namespace cdc {

constexpr int RMS_THREADS = 256;
constexpr int RMS_WARPS = RMS_THREADS / 32;

template <typename TV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel(const TV* __restrict__ x, const float* __restrict__ gamma,
               TV* __restrict__ out, int rows, int d, int64_t ldx,
               float eps) {
  __shared__ float part[RMS_WARPS];
  __shared__ float inv_s;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const TV* xr = x + row * ldx;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += RMS_THREADS) {
      const float v = ld(xr + i);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < RMS_WARPS; ++w) tot += part[w];
      inv_s = rsqrtf(tot / (float)d + eps);
    }
    __syncthreads();
    const float inv = inv_s;
    TV* orow = out + (int64_t)row * d;
    for (int i = threadIdx.x; i < d; i += RMS_THREADS)
      st(orow + i, ld(xr + i) * inv * __ldg(gamma + i));
    __syncthreads();  // part / inv_s are reused by the next row
  }
}

}  // namespace cdc

// C interface (loaded with ctypes). x [rows, d] with contiguous rows at
// stride ldx (elements) and out [rows, d] contiguous, of one storage type
// (bf16 = 1: bfloat16, else float32); gamma [d] float32. Returns the
// cudaError_t of the launch.
extern "C" int cdc_rmsnorm(const void* x, const float* gamma, void* out,
                           int rows, int d, long long ldx, float eps,
                           int bf16, void* stream) {
  using namespace cdc;
  if (rows < 1 || d < 1 || ldx < d) return (int)cudaErrorInvalidValue;
  const dim3 grid(rows < 1048576 ? rows : 1048576);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rmsnorm_kernel<__nv_bfloat16><<<grid, RMS_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), gamma,
        static_cast<__nv_bfloat16*>(out), rows, d, ldx, eps);
  else
    rmsnorm_kernel<float><<<grid, RMS_THREADS, 0, s>>>(
        static_cast<const float*>(x), gamma, static_cast<float*>(out), rows,
        d, ldx, eps);
  return (int)cudaGetLastError();
}
