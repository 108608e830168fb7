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
//  * each thread owns a group of V consecutive columns of one row (V = 4
//    float32 or 8 bf16): one 16-byte load from each live shard, all issued
//    before the first arithmetic, and one 16-byte store to each of the T
//    merged outputs, rebuilt in the registers that held the loads;
//  * with every shard valid the pass is a pure relayout [T, rows, m_l] ->
//    [rows, T, m_l]: esel, coef and the parity are not touched;
//  * with a dead shard, the dead shard's outputs are never read (they may
//    be garbage), the group's esel and coef are read once, and its parity
//    is one 16-byte load of the group's first equation, which every column
//    shares in the folded layout (a group never straddles a slice); a
//    column whose equation differs reads its own;
//  * the parity is read in place in either layout: dedicated [r, rows,
//    m_l], or the folded slots [T, rows, r * m_l / T] through the
//    folded_slot_map arithmetic (column c of parity j -> slot
//    (c / wd + j + 1) % T, column j * wd + c % wd), computed once a group;
//  * one (row, group) a thread, in blocks of 64 threads (the launch that
//    measured fastest, as for kernel 5); ragged m_l (or slice width) and
//    misaligned views take the same kernel at V = 1;
//  * T = 2, 4, 8 and 16 have their own instantiations; every other
//    T <= 16 takes the generic one, T a runtime value and the per-shard
//    registers MAX_T wide (unrolled loops, the first T used).
// Storage float32 or bf16 (the output has ys' type); the math is float32.
#include "coded_tile.cuh"

namespace cdc {

constexpr int DM_THREADS = 64;

// TT: the code width of an instantiation, or 0 for the generic one (T
// from the arguments).
template <int TT, int V, typename TV>
__global__ void __launch_bounds__(DM_THREADS)
decode_merge_kernel(const TV* __restrict__ ys, const TV* __restrict__ par,
                    const float* __restrict__ gen,
                    const int* __restrict__ esel,
                    const float* __restrict__ coef, TV* __restrict__ out,
                    int rows, int m_l, int T_arg, int R, int folded,
                    unsigned valid_bits) {
  using IO = VecIO<V, TV>;
  constexpr int TM = TT ? TT : MAX_T;
  const int T = TT ? TT : T_arg;
  const unsigned all = (1u << T) - 1u;
  const bool any_dead = (valid_bits & all) != all;
  const int groups = m_l / V, wd = folded ? m_l / T : 1;
  const int64_t i = (int64_t)blockIdx.x * DM_THREADS + threadIdx.x;
  if (i < (int64_t)rows * groups) {
    const int row = (int)(i / groups);
    const int c = (int)(i - (int64_t)row * groups) * V;
    typename IO::R r[TM] = {};
#pragma unroll
    for (int t = 0; t < TM; ++t)
      if (t < T && ((valid_bits >> t) & 1u))
        r[t] = IO::load(ys + ((int64_t)t * rows + row) * m_l + c);
    TV* orow = out + (int64_t)row * T * m_l + c;
    if (any_dead) {
      // the group's equations and coefficients; the parity of column c + q
      // of equation e is one 16-byte load for the group's first equation,
      // a scalar load where a column's equation differs
      int e[V];
      float cf[V], pv[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        e[q] = __ldg(esel + c + q);
        cf[q] = __ldg(coef + c + q);
      }
      const int s = c / wd;
      auto pidx = [=](int eq, int col) -> int64_t {
        if (!folded) return ((int64_t)eq * rows + row) * m_l + col;
        const int slot = (s + eq + 1) % T;
        return ((int64_t)slot * rows + row) * (R * wd) + eq * wd + col % wd;
      };
      const typename IO::R rp = IO::load(par + pidx(e[0], c));
#pragma unroll
      for (int q = 0; q < V; ++q)
        pv[q] = e[q] == e[0] ? IO::get(rp, q) : ld(par + pidx(e[q], c + q));
#pragma unroll
      for (int q = 0; q < V; ++q) {
        float y[TM], o[TM];
#pragma unroll
        for (int t = 0; t < TM; ++t)
          if (t < T) y[t] = ((valid_bits >> t) & 1u) ? IO::get(r[t], q) : 0.f;
        eq12_decode<TM>(y, pv[q], gen + e[q] * T, cf[q], valid_bits, o, T);
#pragma unroll
        for (int t = 0; t < TM; ++t)
          if (t < T) IO::set(r[t], q, o[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TM; ++t)
      if (t < T) IO::store(orow + (int64_t)t * m_l, r[t]);
  }
}

template <int TT, typename TV>
static int run(int vec, const void* ys, const void* par, const float* gen,
               const int* esel, const float* coef, void* out, int rows,
               int m_l, int T, int R, int folded, unsigned valid_bits,
               cudaStream_t strm) {
  constexpr int V = 16 / (int)sizeof(TV);
  if (vec != 1 && vec != V) return (int)cudaErrorInvalidValue;
  auto kern = vec == V ? decode_merge_kernel<TT, V, TV>
                       : decode_merge_kernel<TT, 1, TV>;
  const int64_t blocks =
      ((int64_t)rows * (m_l / vec) + DM_THREADS - 1) / DM_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, DM_THREADS, 0, strm>>>(
      static_cast<const TV*>(ys), static_cast<const TV*>(par), gen, esel,
      coef, static_cast<TV*>(out), rows, m_l, T, R, folded, valid_bits);
  return (int)cudaGetLastError();
}

template <typename TV>
static int dispatch(int T, int vec, const void* ys, const void* par,
                    const float* gen, const int* esel, const float* coef,
                    void* out, int rows, int m_l, int R, int folded,
                    unsigned valid_bits, cudaStream_t strm) {
#define DM_CASE(TT)                                                        \
  case TT:                                                                 \
    return run<TT, TV>(vec, ys, par, gen, esel, coef, out, rows, m_l, T, R, \
                       folded, valid_bits, strm);
  switch (T) {
    DM_CASE(2)
    DM_CASE(4)
    DM_CASE(8)
    DM_CASE(16)
    default:
      return T >= 2 && T <= MAX_T
                 ? run<0, TV>(vec, ys, par, gen, esel, coef, out, rows, m_l,
                              T, R, folded, valid_bits, strm)
                 : (int)cudaErrorInvalidValue;
  }
#undef DM_CASE
}

}  // namespace cdc

// C interface (loaded with ctypes). ys [T, rows, m_l], the parity
// (dedicated [R, rows, m_l] or folded [T, rows, R * m_l / T]) and out
// [rows, T, m_l] contiguous, of one storage type (bf16 = 1: bfloat16, else
// float32); gen [R, T], esel [m_l], coef [m_l] on the device. 2 <= T <= 16,
// 1 <= R <= T; vec 1, or 16 bytes' worth when m_l (and, folded, m_l / T) is
// whole vectors and the bases are 16-byte aligned. Returns the cudaError_t
// of the launch.
extern "C" int cdc_decode_merge(const void* ys, const void* par,
                                const float* gen, const int* esel,
                                const float* coef, void* out, int rows,
                                int m_l, int T, int R, int folded,
                                unsigned valid_bits, int bf16, int vec,
                                void* stream) {
  using namespace cdc;
  const int V = bf16 ? 8 : 4;
  if (rows < 1 || m_l < 1 || R < 1 || R > T || (folded && m_l % T != 0) ||
      (vec != 1 &&
       (vec != V || m_l % V != 0 || (folded && (m_l / T) % V != 0) ||
        ((uintptr_t)ys | (uintptr_t)par | (uintptr_t)out) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(T, vec, ys, par, gen, esel, coef,
                                        out, rows, m_l, R, folded,
                                        valid_bits, s)
              : dispatch<float>(T, vec, ys, par, gen, esel, coef, out, rows,
                                m_l, R, folded, valid_bits, s);
}
