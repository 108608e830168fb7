// Eq. 12 decode + merge of already-computed shard outputs, sm_90a.
//
// Replaces the TPU kernel cdc_decode_merge_pallas
// (src/repro/kernels/cdc_matmul.py): ys [T, rows, m_l] shard outputs and
// the parity outputs -> the merged [rows, T, m_l] activation, at most one
// shard dead. Dead shards are zeroed by SELECT and rebuilt from the
// column's parity equation esel[c] scaled by coef[c], with the same
// device function (eq12_decode in coded_tile.cuh) as the coded GEMM's
// epilogue, so both kernels decode with one piece of arithmetic.
//
// What bounds it: one elementwise pass with no reuse, so bytes: the live
// shards' outputs and (when a shard is dead) the one selected parity
// output are read once, the T merged outputs written once.
// What the design does about it:
//  * a dead shard's outputs are never read (they may be garbage), and the
//    parity is read only when a shard is dead, one equation per column;
//  * the parity is read in place in either layout: dedicated [r, rows,
//    m_l], or the folded slots [T, rows, r * m_l / T] through the
//    folded_slot_map arithmetic (column c of parity j -> slot
//    (c / wd + j + 1) % T, column j * wd + c % wd), so no unfold copy;
//  * one thread per (row, column): neighbouring threads read and write
//    neighbouring columns of every shard; ragged rows and m_l are bounds
//    checks, not padding.
// Storage float32 or bf16 (the output has ys' type); the math is float32.
#include "coded_tile.cuh"

namespace cdc {

constexpr int DM_THREADS = 256;

template <int T, typename TV>
__global__ void __launch_bounds__(DM_THREADS)
decode_merge_kernel(const TV* __restrict__ ys, const TV* __restrict__ par,
                    const float* __restrict__ gen,
                    const int* __restrict__ esel,
                    const float* __restrict__ coef, TV* __restrict__ out,
                    int rows, int m_l, int R, int folded,
                    unsigned valid_bits) {
  const int c = blockIdx.x * DM_THREADS + threadIdx.x;
  if (c >= m_l) return;
  constexpr unsigned all = (1u << T) - 1u;
  const bool any_dead = (valid_bits & all) != all;
  const int e = any_dead ? esel[c] : 0;
  const int wd = m_l / T;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    float y[T];
#pragma unroll
    for (int t = 0; t < T; ++t)
      y[t] = ((valid_bits >> t) & 1u)
                 ? ld(ys + ((int64_t)t * rows + row) * m_l + c)
                 : 0.f;
    float o[T];
    if (any_dead) {
      int64_t pi;
      if (folded) {
        const int slot = (c / wd + e + 1) % T;
        pi = ((int64_t)slot * rows + row) * (R * wd) + e * wd + c % wd;
      } else {
        pi = ((int64_t)e * rows + row) * m_l + c;
      }
      eq12_decode<T>(y, ld(par + pi), gen + e * T, coef[c], valid_bits, o);
    } else {
#pragma unroll
      for (int t = 0; t < T; ++t) o[t] = y[t];
    }
    TV* orow = out + (int64_t)row * T * m_l + c;
#pragma unroll
    for (int t = 0; t < T; ++t) st(orow + (int64_t)t * m_l, o[t]);
  }
}

template <typename TV>
static int launch(const void* ys, const void* par, const float* gen,
                  const int* esel, const float* coef, void* out, int rows,
                  int m_l, int T, int R, int folded, unsigned valid_bits,
                  cudaStream_t strm) {
  const dim3 grid((m_l + DM_THREADS - 1) / DM_THREADS,
                  rows < 65535 ? rows : 65535);
  const TV* y = static_cast<const TV*>(ys);
  const TV* p = static_cast<const TV*>(par);
  TV* o = static_cast<TV*>(out);
#define DM_CASE(TT)                                                      \
  case TT:                                                               \
    decode_merge_kernel<TT, TV><<<grid, DM_THREADS, 0, strm>>>(            \
        y, p, gen, esel, coef, o, rows, m_l, R, folded, valid_bits);     \
    break;
  switch (T) {
    DM_CASE(2)
    DM_CASE(4)
    DM_CASE(8)
    DM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DM_CASE
  return (int)cudaGetLastError();
}

}  // namespace cdc

// C interface (loaded with ctypes). ys [T, rows, m_l], the parity
// (dedicated [R, rows, m_l] or folded [T, rows, R * m_l / T]) and out
// [rows, T, m_l] contiguous, of one storage type (bf16 = 1: bfloat16, else
// float32); gen [R, T], esel [m_l], coef [m_l] on the device. T in {2, 4,
// 8, 16}; returns the cudaError_t of the launch.
extern "C" int cdc_decode_merge(const void* ys, const void* par,
                                const float* gen, const int* esel,
                                const float* coef, void* out, int rows,
                                int m_l, int T, int R, int folded,
                                unsigned valid_bits, int bf16,
                                void* stream) {
  using namespace cdc;
  if (rows < 1 || m_l < 1 || R < 1 || (folded && m_l % T != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(ys, par, gen, esel, coef, out, rows,
                                      m_l, T, R, folded, valid_bits, s)
              : launch<float>(ys, par, gen, esel, coef, out, rows, m_l, T, R,
                              folded, valid_bits, s);
}
