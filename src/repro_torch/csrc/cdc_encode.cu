// Offline CDC parity encode, sm_90a: shards and parity stored as float32
// or bf16 (the parity in the shards' type), float32 math.
//
// Replaces the TPU kernel cdc_encode_pallas (src/repro/kernels/cdc_encode.py):
// parity[j] = sum_i gen[j, i] * W_i over the T column shards W_i [k, m_l]
// of a weight, for j < r, accumulated in float32 in ascending i.
//
// What bounds it: a contraction of only T <= 16 per output element, so it
// is bound by the bytes it moves -- T * k * m_l weights read once and
// r * k * m_l parities written once (granite-3-8b, one layer's wq..w3 at
// T=4, r=2: 780 MB, ~0.23 ms at 3.35 TB/s).
// What the design does about it:
//  * the shards are read IN PLACE from the raw weight: shard i is the
//    weight at column offset i * m_l (stride ld_t), rows at stride ld_k,
//    stacked layers at stride ld_l, so no permuted copy of the weight is
//    made; a stacked [L, k, m] leaf is ONE launch (grid.y over L);
//  * each thread owns VEC consecutive columns of one row: 16-byte loads
//    (4 float32 or 8 bf16 columns) wherever the shard reads are whole
//    vectors (row, shard and layer strides, m_l and the base), else one
//    column; a warp reads 512 contiguous bytes of every shard;
//  * the parity is written straight into the layout the stepper holds:
//    dedicated [r, k, m_l], or the folded slots [T, k, r * m_l / T] through
//    the same folded_slot_map arithmetic kernel 1 reads them with (column
//    c of parity j -> slot (c / wd + j + 1) % T, column j * wd + c % wd),
//    so no fold copy is made either. Where a folded slice is no whole
//    number of vectors (granite's 89-column slices at T = 12) the reads
//    stay 16 bytes wide and each column of the vector goes to its own
//    slot and offset;
//  * a thread issues the loads of all T shards before its first FMA (T
//    loads in flight, not one: a runtime T of the generic instantiations
//    only predicates them), then forms one parity row at a time from the
//    values in registers, so only VEC sums are live: the generic
//    instantiations keep 8 (T <= 8) or 16 (T <= 16) loaded vectors, not
//    MAX_T x MAX_T sums;
//  * the generator rides in the kernel's parameter space (constant bank),
//    rows MAX_T apart, so every unrolled index into it is a constant;
//  * no atomics and a fixed summation order (ascending i, from zero):
//    encoding the same weights twice gives the same bits;
//  * the codes of the serving paths and the cost study have their own
//    instantiations; every other 2 <= T <= 16, 1 <= r <= T takes a
//    generic one, T and r runtime values.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar.cuh"

namespace cdc_enc {

using cdc::VecIO;

constexpr int THREADS = 256;
using cdc::MAX_T;

struct Gen {
  float g[MAX_T * MAX_T];  // row j at g[j * MAX_T]
};

// One thread: VEC consecutive columns starting at c of row `row` of layer
// blockIdx.y. For VEC > 1 the wrapper guarantees m_l % VEC == 0 and
// 16-byte aligned rows, shard and layer offsets. TT, RR: the code of an
// instantiation, or 0, 0 for a generic one (T <= TG and R <= T from the
// arguments).
template <int TT, int RR, int TG, int VEC, typename TV>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const TV* __restrict__ w, TV* __restrict__ out,
              const __grid_constant__ Gen gen, int k, int m_l, int64_t ld_t,
              int64_t ld_k, int64_t ld_l, int folded, int T_arg, int R_arg) {
  constexpr int TM = TT ? TT : TG, RM = TT ? RR : TG;
  const int T = TT ? TT : T_arg, R = TT ? RR : R_arg;
  const int nv = m_l / VEC + (m_l % VEC != 0);
  const uint32_t item = blockIdx.x * THREADS + threadIdx.x;
  if (item >= (uint32_t)k * (uint32_t)nv) return;
  const int row = (int)(item / (uint32_t)nv);
  const int c = (int)(item % (uint32_t)nv) * VEC;
  const int64_t l = blockIdx.y;
  const TV* src = w + l * ld_l + (int64_t)row * ld_k + c;

  using IO = VecIO<VEC, TV>;
  typename IO::R v[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (i < T) v[i] = IO::load(src + i * ld_t);

  const int wd = folded ? m_l / T : 1, s = c / wd, o = c % wd;
  const bool whole = wd % VEC == 0;      // the vector inside one slice
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    if (j >= R) break;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (i < T)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = fmaf(gen.g[j * MAX_T + i], IO::get(v[i], e), acc[e]);
    if (!folded) {
      typename IO::R p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) IO::set(p, e, acc[e]);
      IO::store(out + ((l * R + j) * k + row) * m_l + c, p);
    } else if (whole) {
      typename IO::R p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) IO::set(p, e, acc[e]);
      const int slot = (s + j + 1) % T;
      IO::store(
          out + ((l * T + slot) * k + row) * (int64_t)(R * wd) + j * wd + o,
          p);
    } else {
      // column by column: each to the slot and offset of its own slice
      int ss = s, oo = o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int slot = (ss + j + 1) % T;
        cdc::st(out + ((l * T + slot) * k + row) * (int64_t)(R * wd) +
                    j * wd + oo,
                acc[e]);
        if (++oo == wd) {
          oo = 0;
          ++ss;
        }
      }
    }
  }
}

template <int TT, int RR, int TG, typename TV>
static int launch(int vec, dim3 grid, cudaStream_t st, const void* w,
                  void* out, const Gen& gen, int k, int m_l, int64_t ld_t,
                  int64_t ld_k, int64_t ld_l, int folded, int T, int R) {
  constexpr int V = 16 / (int)sizeof(TV);
  const TV* wi = static_cast<const TV*>(w);
  TV* o = static_cast<TV*>(out);
  if (vec == V && m_l % V == 0)
    encode_kernel<TT, RR, TG, V, TV><<<grid, THREADS, 0, st>>>(
        wi, o, gen, k, m_l, ld_t, ld_k, ld_l, folded, T, R);
  else if (vec == 1)
    encode_kernel<TT, RR, TG, 1, TV><<<grid, THREADS, 0, st>>>(
        wi, o, gen, k, m_l, ld_t, ld_k, ld_l, folded, T, R);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int TT, int RR, int TG>
static int launch_t(int bf16, int vec, dim3 grid, cudaStream_t st,
                    const void* w, void* out, const Gen& gen, int k, int m_l,
                    int64_t ld_t, int64_t ld_k, int64_t ld_l, int folded,
                    int T, int R) {
  return bf16 ? launch<TT, RR, TG, __nv_bfloat16>(vec, grid, st, w, out, gen,
                                                  k, m_l, ld_t, ld_k, ld_l,
                                                  folded, T, R)
              : launch<TT, RR, TG, float>(vec, grid, st, w, out, gen, k, m_l,
                                          ld_t, ld_k, ld_l, folded, T, R);
}

}  // namespace cdc_enc

// C interface (loaded with ctypes). w and out are bf16 when bf16 != 0,
// else float32; vec is 1 or 16 bytes' worth (4 float32, 8 bf16; m_l a
// multiple of it). gen_host is a host array [R, T] of float32; returns the
// cudaError_t of the launch. Cases: T in {2, 4, 8} with 1 <= R <= T, and
// T = 16 with 1 <= R <= 4, each its own instantiation; every other 2 <= T
// <= 16, 1 <= R <= T a generic one (T <= 8 or T <= 16); anything else
// returns cudaErrorInvalidValue. The case key T * 32 + R is unique because
// R <= 16 < 32.
extern "C" int cdc_encode(const void* w, void* out, const float* gen_host,
                          int L, int k, int T, int R, int m_l, long long ld_t,
                          long long ld_k, long long ld_l, int folded,
                          int vec, int bf16, void* stream) {
  using namespace cdc_enc;
  if (T < 2 || T > MAX_T || R < 1 || R > T || vec < 1)
    return (int)cudaErrorInvalidValue;
  Gen gen{};
  for (int j = 0; j < R; ++j)
    for (int i = 0; i < T; ++i) gen.g[j * MAX_T + i] = gen_host[j * T + i];
  const int64_t nv = m_l / vec + (m_l % vec != 0);
  const int64_t items = (int64_t)k * nv;
  if (items >= (int64_t)1 << 31 || L > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((items + THREADS - 1) / THREADS), L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENC_CASE(TT, RR)                                                \
  case TT * 32 + RR:                                                    \
    return launch_t<TT, RR, 0>(bf16, vec, grid, st, w, out, gen, k, m_l, \
                               ld_t, ld_k, ld_l, folded, T, R);
  switch (T * 32 + R) {
    ENC_CASE(2, 1)
    ENC_CASE(2, 2)
    ENC_CASE(4, 1)
    ENC_CASE(4, 2)
    ENC_CASE(4, 3)
    ENC_CASE(4, 4)
    ENC_CASE(8, 1)
    ENC_CASE(8, 2)
    ENC_CASE(8, 3)
    ENC_CASE(8, 4)
    ENC_CASE(8, 5)
    ENC_CASE(8, 6)
    ENC_CASE(8, 7)
    ENC_CASE(8, 8)
    ENC_CASE(16, 1)
    ENC_CASE(16, 2)
    ENC_CASE(16, 3)
    ENC_CASE(16, 4)
    default:
      return T <= 8 ? launch_t<0, 0, 8>(bf16, vec, grid, st, w, out, gen, k,
                                        m_l, ld_t, ld_k, ld_l, folded, T, R)
                    : launch_t<0, 0, MAX_T>(bf16, vec, grid, st, w, out, gen,
                                            k, m_l, ld_t, ld_k, ld_l, folded,
                                            T, R);
  }
#undef ENC_CASE
}
