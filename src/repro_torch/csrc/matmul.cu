// Blocked GEMM with float32 accumulation, sm_90a: out = x @ w.
//
// Replaces the TPU kernel matmul_pallas (src/repro/kernels/matmul.py),
// whose 128 x 128 MXU tiles accumulate across a sequential k grid axis in
// the output block. Here a block owns a 64 x 64 output tile and loops
// over k itself in steps of 16 (Hopper's blocks run in no order, so
// nothing is carried between them), each of its 256 threads holding a
// 4 x 4 register tile of float32 sums.
//
// What bounds it: at 512^3 the float32 operations (4 us at 67 TFLOP/s on
// CUDA cores); at few rows against a large w (4 x 4096 @ 4096 x 4096),
// the bytes of w (64 MB, 20 us at 3.35 TB/s).
// What the design does about it, simply: x and w tiles are staged in
// shared memory (each element read from device memory once per tile row /
// column), the next k step's tile is loaded into registers while the
// current one is multiplied, and ragged m, n and k are bounds checks
// (zeros past the edge), not padding. FMA on CUDA cores; wgmma and TMA
// are left for a later change.
// Storage float32 or bf16 in (x and w alike) and out; the sums are float32.
#include "scalar.cuh"

namespace cdc {

constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 16, MM_THREADS = 256;
constexpr int MM_LOADS = MM_BM * MM_BK / MM_THREADS;  // 4 per operand

template <typename TI>
__device__ __forceinline__ void mm_fetch(const TI* __restrict__ x,
                                         const TI* __restrict__ w, int M,
                                         int N, int K, int row0, int col0,
                                         int k0, float (&xr)[MM_LOADS],
                                         float (&wr)[MM_LOADS]) {
#pragma unroll
  for (int i = 0; i < MM_LOADS; ++i) {
    const int idx = threadIdx.x + i * MM_THREADS;
    const int r = row0 + idx / MM_BK, kx = k0 + idx % MM_BK;
    xr[i] = (r < M && kx < K) ? ld(x + (int64_t)r * K + kx) : 0.f;
    const int kw = k0 + idx / MM_BN, c = col0 + idx % MM_BN;
    wr[i] = (kw < K && c < N) ? ld(w + (int64_t)kw * N + c) : 0.f;
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(MM_THREADS)
matmul_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
              TO* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[MM_BK][MM_BM + 4];   // x tile, k-major
  __shared__ float wsh[MM_BK][MM_BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * MM_BM, col0 = blockIdx.x * MM_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xr[MM_LOADS], wr[MM_LOADS];
  mm_fetch(x, w, M, N, K, row0, col0, 0, xr, wr);
  for (int k0 = 0; k0 < K; k0 += MM_BK) {
#pragma unroll
    for (int i = 0; i < MM_LOADS; ++i) {
      const int idx = threadIdx.x + i * MM_THREADS;
      xs[idx % MM_BK][idx / MM_BK] = xr[i];
      wsh[idx / MM_BN][idx % MM_BN] = wr[i];
    }
    __syncthreads();
    if (k0 + MM_BK < K)
      mm_fetch(x, w, M, N, K, row0, col0, k0 + MM_BK, xr, wr);
#pragma unroll
    for (int kk = 0; kk < MM_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wsh[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) st(out + (int64_t)r * N + c, acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
static int launch(const void* x, const void* w, void* out, int M, int N,
                  int K, cudaStream_t strm) {
  const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  matmul_kernel<TI, TO><<<grid, MM_THREADS, 0, strm>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w),
      static_cast<TO*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace cdc

// C interface (loaded with ctypes). x [M, K] and w [K, N] contiguous, of
// one storage type (in_bf16); out [M, N] of type out_bf16. Returns the
// cudaError_t of the launch.
extern "C" int cdc_matmul(const void* x, const void* w, void* out, int M,
                          int N, int K, int in_bf16, int out_bf16,
                          void* stream) {
  using namespace cdc;
  if (M < 1 || N < 1 || K < 1 || (M + MM_BM - 1) / MM_BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (in_bf16)
    return out_bf16 ? launch<bf, bf>(x, w, out, M, N, K, s)
                    : launch<bf, float>(x, w, out, M, N, K, s);
  return out_bf16 ? launch<float, bf>(x, w, out, M, N, K, s)
                  : launch<float, float>(x, w, out, M, N, K, s);
}
