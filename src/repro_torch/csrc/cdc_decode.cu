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
// What the design does about it:
//  * the [m, n] plane is flat (any m and n, no padding); each thread owns
//    V consecutive elements of it (V = 4 float32 or 8 bf16: 16-byte loads
//    and stores of every shard, the parity and the output) and issues all
//    T + 1 loads of a vector before its first arithmetic, so an SM keeps
//    tens of kilobytes in flight;
//  * one vector a thread, in blocks of 64 threads: at the small shapes of
//    its callers (a few thousand vectors) that spreads the loads over the
//    most SMs, and at 2048 rows it measured 5-8% faster on the H100 than a
//    grid of the card's resident blocks walking the vectors in a
//    grid-stride loop (PERF.md);
//  * a plane that is no whole number of vectors, or a misaligned view,
//    takes the same kernel at V = 1;
//  * the shard sum is taken in ascending t, the outputs rebuilt in the
//    registers that held the loads;
//  * T = 2, 4, 8 and 16 have their own instantiations; every other
//    T <= 16 takes the generic one, T a runtime value and the per-shard
//    registers MAX_T wide (unrolled loops, the first T used).
// Storage float32 or bf16 (the output has y's type); the math is float32.
#include "scalar.cuh"

namespace cdc {

constexpr int DEC_THREADS = 64;

// TT: the code width of an instantiation, or 0 for the generic one (T
// from the arguments).
template <int TT, int V, typename TV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const TV* __restrict__ y, const TV* __restrict__ p,
              TV* __restrict__ out, int64_t n, int T_arg,
              unsigned valid_bits) {
  using IO = VecIO<V, TV>;
  constexpr int TM = TT ? TT : MAX_T;
  const int T = TT ? TT : T_arg;
  float vm[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) vm[t] = ((valid_bits >> t) & 1u) ? 1.f : 0.f;
  const int64_t i = (int64_t)blockIdx.x * DEC_THREADS + threadIdx.x;
  if (i < n / V) {
    const int64_t e0 = i * V;
    typename IO::R r[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t)
      if (t < T) r[t] = IO::load(y + t * n + e0);
    const typename IO::R rp = IO::load(p + e0);
    float miss[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      float tot = 0.f;
#pragma unroll
      for (int t = 0; t < TM; ++t)
        if (t < T) tot += IO::get(r[t], q) * vm[t];
      miss[q] = IO::get(rp, q) - tot;
    }
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      if (t >= T) break;
#pragma unroll
      for (int q = 0; q < V; ++q)
        IO::set(r[t], q, IO::get(r[t], q) * vm[t] + (1.f - vm[t]) * miss[q]);
      IO::store(out + t * n + e0, r[t]);
    }
  }
}

template <int TT, typename TV>
static int run(int vec, const void* y, const void* p, void* out, int64_t n,
               int T, unsigned valid_bits, cudaStream_t strm) {
  constexpr int V = 16 / (int)sizeof(TV);
  if (vec != 1 && vec != V) return (int)cudaErrorInvalidValue;
  auto kern = vec == V ? decode_kernel<TT, V, TV> : decode_kernel<TT, 1, TV>;
  const int64_t blocks = (n / vec + DEC_THREADS - 1) / DEC_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, DEC_THREADS, 0, strm>>>(
      static_cast<const TV*>(y), static_cast<const TV*>(p),
      static_cast<TV*>(out), n, T, valid_bits);
  return (int)cudaGetLastError();
}

template <typename TV>
static int dispatch(int T, int vec, const void* y, const void* p, void* out,
                    int64_t n, unsigned valid_bits, cudaStream_t strm) {
  switch (T) {
    case 2:
      return run<2, TV>(vec, y, p, out, n, T, valid_bits, strm);
    case 4:
      return run<4, TV>(vec, y, p, out, n, T, valid_bits, strm);
    case 8:
      return run<8, TV>(vec, y, p, out, n, T, valid_bits, strm);
    case 16:
      return run<16, TV>(vec, y, p, out, n, T, valid_bits, strm);
    default:
      return T >= 2 && T <= MAX_T
                 ? run<0, TV>(vec, y, p, out, n, T, valid_bits, strm)
                 : (int)cudaErrorInvalidValue;
  }
}

}  // namespace cdc

// C interface (loaded with ctypes). y [T, n], p [n] and out [T, n]
// contiguous, of one storage type (bf16 = 1: bfloat16, else float32);
// 2 <= T <= 16; vec 1, or 16 bytes' worth when n is whole vectors and the
// bases are 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int cdc_decode(const void* y, const void* p, void* out, int T,
                          long long n, unsigned valid_bits, int bf16,
                          int vec, void* stream) {
  using namespace cdc;
  const int V = bf16 ? 8 : 4;
  if (n < 1 ||
      (vec != 1 && (vec != V || n % V != 0 ||
                    ((uintptr_t)y | (uintptr_t)p | (uintptr_t)out) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(T, vec, y, p, out, n, valid_bits, s)
              : dispatch<float>(T, vec, y, p, out, n, valid_bits, s);
}
