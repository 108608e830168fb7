// r = 1 Eq. 12 decode of stacked shard outputs, sm_90a.
//
// Replaces the TPU kernel cdc_decode_pallas
// (src/repro/kernels/cdc_decode.py): y [T, m, n] shard outputs, the sum
// parity p [m, n] and a [T] mask with at most one False ->
//   out[t] = y[t] * v[t] + (1 - v[t]) * (p - sum_s y[s] * v[s]).
// Dead shards are zeroed by MULTIPLY, as the reference kernel and its
// oracle write it: a NaN in a dead shard propagates to every output of
// its element, exactly as the plain version's does.
//
// What bounds it: one elementwise pass with no reuse, so bytes: T + 1
// values read and T written per element (the multiply semantics read the
// dead shard too).
// What the design does about it: the [m, n] plane is flat (any m and n,
// no padding); one thread per element walks the T shards at stride m * n,
// so neighbouring threads read and write neighbouring addresses of every
// shard; the shard sum is taken in ascending t.
// Storage float32 or bf16 (the output has y's type); the math is float32.
#include "scalar.cuh"

namespace cdc {

constexpr int DEC_THREADS = 256;

template <int T, typename TV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const TV* __restrict__ y, const TV* __restrict__ p,
              TV* __restrict__ out, int64_t n, unsigned valid_bits) {
  const int64_t stride = (int64_t)gridDim.x * DEC_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * DEC_THREADS + threadIdx.x; i < n;
       i += stride) {
    float z[T];
    float tot = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float v = ((valid_bits >> t) & 1u) ? 1.f : 0.f;
      z[t] = ld(y + t * n + i) * v;
      tot += z[t];
    }
    const float miss = ld(p + i) - tot;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float v = ((valid_bits >> t) & 1u) ? 1.f : 0.f;
      st(out + t * n + i, z[t] + (1.f - v) * miss);
    }
  }
}

template <typename TV>
static int launch(const void* y, const void* p, void* out, int T, int64_t n,
                  unsigned valid_bits, cudaStream_t strm) {
  const int64_t blocks = (n + DEC_THREADS - 1) / DEC_THREADS;
  const dim3 grid((unsigned)(blocks < 65536 ? blocks : 65536));
  const TV* yy = static_cast<const TV*>(y);
  const TV* pp = static_cast<const TV*>(p);
  TV* o = static_cast<TV*>(out);
#define DEC_CASE(TT)                                                          \
  case TT:                                                                    \
    decode_kernel<TT, TV><<<grid, DEC_THREADS, 0, strm>>>(yy, pp, o, n,       \
                                                          valid_bits);        \
    break;
  switch (T) {
    DEC_CASE(2)
    DEC_CASE(4)
    DEC_CASE(8)
    DEC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEC_CASE
  return (int)cudaGetLastError();
}

}  // namespace cdc

// C interface (loaded with ctypes). y [T, n], p [n] and out [T, n]
// contiguous, of one storage type (bf16 = 1: bfloat16, else float32); T in
// {2, 4, 8, 16}; returns the cudaError_t of the launch.
extern "C" int cdc_decode(const void* y, const void* p, void* out, int T,
                          long long n, unsigned valid_bits, int bf16,
                          void* stream) {
  using namespace cdc;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(y, p, out, T, n, valid_bits, s)
              : launch<float>(y, p, out, T, n, valid_bits, s);
}
