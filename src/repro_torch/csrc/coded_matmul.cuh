// Fused coded matmul + Eq. 12 decode + merge, sm_90a: weights stored as
// float32 or bf16, x and the output as float32 or bf16, float32 math.
// Each translation unit cdc_coded_matmul*.cu instantiates a set of (T, R)
// cases and storage types (CDC_CODED_CASES, CDC_CODED_TYPES) and becomes
// its own library, so that nvcc builds the sets in parallel; the
// cdc_coded_matmul_any*.cu units (CDC_CODED_ANY) hold the generic
// instantiation that takes every other code, 2 <= T <= 16 and 1 <= R <= T,
// with T and R as runtime values.
//
// Replaces the TPU kernel cdc_coded_matmul_pallas
// (src/repro/kernels/cdc_matmul.py): x [rows, k] against the T column
// shards of w [k, T*m_l] and the r parity shards, dead shards zeroed by
// SELECT, the missing shard rebuilt per column from parity equation
// esel[c] scaled by coef[c], written straight into the merged
// [rows, T, m_l] layout; optionally with the preceding rmsnorm folded in.
//
// What bounds it: in decode rows <= n_slots, so each weight element is
// used for a handful of FMAs -- the kernel is bound by the bytes of the
// (T + r) * k * m_l weights it reads (granite-3-8b w1: 4 + 2 shards of
// 4096 x 3200 float32 = 315 MB, ~94 us at 3.35 TB/s; half in bf16).
// What the design does about it:
//  * the weights stream through the mainloop of stream_tile.cuh: a
//    producer warp keeps 32 KB stages in flight, each stage one TMA
//    box [ks, bn] per stream (S = T + r copies on one mbarrier), and one
//    consumer warp per stream does the FMAs from shared memory with
//    16-byte reads. The tensor maps (w as [k, T*m_l]; folded parity as
//    [T, k, r*wd]; dedicated as [r, k, m_l]) are encoded per launch;
//  * the weights are read in place: shard t is w at column offset t*m_l,
//    and folded parity j of column c is read from slice s = c / wd of
//    slot (s + j + 1) % T. A column tile never straddles a slice (the
//    launch plan cuts each slice into equal tiles), so every stream's row
//    segment is contiguous;
//  * rows <= 4 take RB = 4 (no FMAs, registers or staging spent on rows
//    that do not exist), 5-8 rows RB = 8, more RB = 16 and row blocks;
//  * the launch plan (kernels/cdc_matmul.py: coded_plan) splits k so that
//    (tiles x row blocks x splits) fills whole waves of the resident
//    blocks this C interface reports. Each split decodes its own partial
//    sums (the decode is linear, and a dead shard is removed by select,
//    so partials decode exactly) into a workspace, and the last block of
//    a tile adds the splits in split order -- one launch, deterministic;
//  * a copy must start on a 16-byte boundary: where a slice or shard
//    width is half a 16-byte vector off (granite's 50-column slices at T =
//    16), every box row is one vector wider (`lead`) and starts at the
//    boundary before its tile, and the stream's consumer reads its rows
//    half a vector in, in 8-byte halves;
//  * shapes whose segments or strides are not multiples of 8 bytes, or
//    whose row strides are not multiples of 16 (granite's w1 and w3 at T =
//    12: 89-column slices, parity rows of 712 bytes), take the same kernel
//    with box rows that hold each row from its first 16-byte granule on
//    (stream_tile.cuh: produce, consume_shifted): w's shards still by
//    one TMA box a stage, started at the granule, and rows no tensor map
//    can take (the parity's) granule by granule by the consumer warps,
//    a row a warp, with cp.async arriving on the same mbarrier; the
//    consumers read each row at its own offset;
//  * bf16 weights travel as bf16 (bf16 tensor maps, a stage of 32 KB holds
//    twice the k rows) and widen to float32 in the consumers' registers;
//  * the generic instantiation reads T and R from its arguments. Up to 16
//    streams it keeps one consumer warp a stream; beyond (r = T at T = 16
//    is 32 streams: one warp each would be 33 warps, past a block's 1024
//    threads and the register file) a warp owns two streams (up to 24)
//    or three, consuming each from every stage with its own accumulators.
//    Its per-shard arrays are MAX_T wide, used up to T, in unrolled loops
//    (registers).
#pragma once

#include <type_traits>

#include "coded_tile.cuh"
#include "stream_tile.cuh"

namespace cdc {

struct CodedArgs {
  const void* x;      // float32 or bf16 (x_bf16); out has x's type
  const void* w;      // the storage type W of the instantiation
  const void* pw;
  const float* gen;
  const int* esel;
  const float* coef;
  const float* gamma;
  float eps;
  void* out;
  float* ws;
  int* sem;
  int rows, k, m_l;
  int64_t ldw;
  int folded;
  unsigned valid_bits;
  int bn, tps, wd, nrb, ksplit, kchunk, ks;
  int x_bf16;
  int lead;           // elements a box row may start before its tile
  int T, R;           // the code (read by the generic instantiation only)
  int wmap, pmap;     // row copies: w's, the parity's rows by tensor map
};

// The generic instantiation: a consumer warp owns one stream up to 16
// streams, two up to 24 and three up to 32 (at most 16, 12 and 11
// consumer warps), so that its accumulators fit the registers that its
// thread count leaves each thread (ptxas: 96 at 17 warps, 128 at 13, 170
// at 12). 16-row blocks hold at most 12 streams (rb_fits).
__host__ __device__ constexpr int streams_per_warp(int S) {
  return S <= 16 ? 1 : S <= 24 ? 2 : 3;
}
__host__ __device__ constexpr int any_consumer_warps(int NSPW, int RB) {
  return NSPW == 1 ? (RB == 16 ? 12 : 16) : NSPW == 2 ? 12 : 11;
}

// One block: the column tile of every stream over one k range. TT, RR: the
// code (T, R) of an instantiation, or 0, 0 for the generic one, which reads
// T <= MAX_T and R <= T from the arguments and gives each consumer warp
// NSPW streams. Two blocks per SM below 10 streams and 16 rows; beyond, a
// cap of 65536 / (2 * threads) registers would spill.
template <int TT, int RR, int NSPW, int RB, bool ASYNC, typename W>
__global__ void __launch_bounds__(
    TT ? 32 * (TT + RR + 1) : 32 * (any_consumer_warps(NSPW, RB) + 1),
    (TT && RB < 16 && TT + RR < 10) ? 2 : 1)
coded_stream_kernel(const CodedArgs a,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_p) {
  constexpr int TM = TT ? TT : MAX_T;            // arrays over the shards
  const int T = TT ? TT : a.T, S = T + (TT ? RR : a.R);
  const int NCW = (S + NSPW - 1) / NSPW;         // consumer warps
  const int NC = 32 * NCW, NT = NC + 32;
  using G = stream::Geo<RB>;
  constexpr int BNS = G::BN, CPL = G::CPL;
  extern __shared__ __align__(128) float smem[];
  W* ring = reinterpret_cast<W*>(smem);
  float* xs = smem + G::RING;
  float* inv = xs + G::XS;
  uint64_t* full = reinterpret_cast<uint64_t*>(inv + 16);
  uint64_t* empty = full + G::NSTAGE;

  // unit -> (row block, column tile, split), row blocks fastest (they share
  // a tile's weights in L2), then tiles (blocks resident together read
  // neighbouring segments of the same k rows: DRAM page locality)
  const int u = blockIdx.x;
  const int rbi = u % a.nrb, rest = u / a.nrb;
  const int tiles = (a.folded ? T : 1) * a.tps;
  const int tile = rest % tiles, split = rest / tiles;
  const int slice = tile / a.tps, o0 = (tile % a.tps) * a.bn;
  const int width = min(a.bn, a.wd - o0);
  const int c0 = slice * a.wd + o0;          // shard-local first column
  const int r0 = rbi * RB;
  const int kb0 = split * a.kchunk, kb1 = min(a.k, kb0 + a.kchunk);
  constexpr int V = stream::vec_elems<W>();
  const int pitch = stream::pitch_of<W>(a.bn) + a.lead;   // a box row
  const int sreg = stream::box_elems<W>(a.ks, pitch);
  const int warp = threadIdx.x >> 5;
  // the first column of stream s's tile in its map's inner dimension, and
  // how far past the 16-byte boundary before it (0 unless lead)
  const int m_l = a.m_l, wd = a.wd, folded = a.folded, lead = a.lead;
  auto first_col = [=](int s) -> int {
    return s < T ? s * m_l + c0 : folded ? (s - T) * wd + o0 : c0;
  };

  // row copies: each consumer thread's copies arrive on `full` too
  stream::ring_init<G::NSTAGE>(full, empty, NCW, ASYNC ? 1 : 1 + NC);
  float acc[NSPW][RB][CPL];
#pragma unroll
  for (int i = 0; i < NSPW; ++i)
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[i][rr][q] = 0.f;
  // the lambdas capture scalars by value: no local lives in memory
  const int pld = a.folded ? (S - T) * a.wd : a.m_l;   // the parity's row
  const int k = a.k;
  const int64_t ldw = a.ldw;
  const W* w = static_cast<const W*>(a.w);
  const W* pw = static_cast<const W*>(a.pw);
  // stream s's row kk of the tile (the row-copy instantiation's copies)
  auto src = [=](int s, int kk) -> const W* {
    if (s < T) return w + (int64_t)kk * ldw + (int64_t)s * m_l + c0;
    const int j = s - T;
    if (folded) {
      const int slot = (slice + j + 1) % T;
      return pw + ((int64_t)slot * k + kk) * pld + j * wd + o0;
    }
    return pw + ((int64_t)j * k + kk) * pld + c0;
  };
  // the streams u0 .. u0 + U - 1 no tensor map takes (row copies: w's
  // shards, the parity's or both) the consumers copy
  const int u0 = a.wmap ? T : 0;
  const int U = (a.wmap ? 0 : T) + (a.pmap ? 0 : S - T);
  if (warp == NCW) {
    const CUtensorMap* mw = &tm_w;
    const CUtensorMap* mp = &tm_p;
    auto issue = [=](int s, int k0, W* dst, uint64_t* bar) {
      const int col = first_col(s), c = lead ? col - col % V : col;
      if (s < T) {
        stream::tma_2d(dst, mw, c, k0, bar);
      } else if (folded) {
        const int j = s - T;
        stream::tma_3d(dst, mp, c, k0, (slice + j + 1) % T, bar);
      } else {
        stream::tma_3d(dst, mp, c, k0, s - T, bar);
      }
    };
    stream::produce<G::NSTAGE>(S, u0, U, issue, ring, full, empty, kb0, kb1,
                               a.ks, pitch, sreg);
  } else {
    if (a.x_bf16)
      stream::stage_x<RB>(static_cast<const __nv_bfloat16*>(a.x), a.rows,
                          a.k, r0, kb0, kb1, a.gamma, a.eps, xs, inv, NC);
    else
      stream::stage_x<RB>(static_cast<const float*>(a.x), a.rows, a.k, r0,
                          kb0, kb1, a.gamma, a.eps, xs, inv, NC);
    if constexpr (!ASYNC) {
      stream::consume_shifted<RB, NSPW>(ring, full, empty, xs, warp, NCW, S,
                                        kb0, kb1, a.ks, pitch, sreg, width,
                                        u0, U, warp, NCW, src, acc);
    } else if constexpr (TT != 0) {
      stream::consume<RB>(ring, full, empty, xs, warp, kb0, kb1, a.ks, pitch,
                          sreg, acc[0], lead ? first_col(warp) % V : 0);
    } else {
      auto shift = [=](int s) -> int { return lead ? first_col(s) % V : 0; };
      stream::consume_multi<RB, NSPW>(ring, full, empty, xs, warp, NCW, S,
                                      kb0, kb1, a.ks, pitch, sreg, acc,
                                      shift);
    }
  }
  __syncthreads();        // every stage consumed: reuse ring and staging
  float* tot = smem;      // [S][RB][BN] <= G::RING + G::XS
  if (warp < NCW) {
#pragma unroll
    for (int i = 0; i < NSPW; ++i)
      if (warp + i * NCW < S)
        stream::store_acc<RB, W, !ASYNC>(tot, warp + i * NCW, acc[i]);
  }
  __syncthreads();

  // epilogue: one (row, column) of the tile per thread and step
  const int64_t m = (int64_t)T * a.m_l;
  for (int i = threadIdx.x; i < RB * width; i += NT) {
    const int rr = i / width, cl = i - rr * width;
    const int row = r0 + rr, c = c0 + cl;
    if (row >= a.rows) continue;
    float y[TM], o[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t)
      if (t < T) y[t] = tot[(t * RB + rr) * BNS + cl];
    const int e = a.esel[c];
    eq12_decode<TM>(y, tot[((T + e) * RB + rr) * BNS + cl], a.gen + e * T,
                    a.coef[c], a.valid_bits, o, T);
    if (a.ksplit == 1) {
#pragma unroll
      for (int t = 0; t < TM; ++t)
        if (t < T)
          st_as(a.out, a.x_bf16, (int64_t)row * m + (int64_t)t * a.m_l + c,
                o[t]);
    } else {
      float* dst = a.ws + ((int64_t)split * a.rows + row) * m + c;
#pragma unroll
      for (int t = 0; t < TM; ++t)
        if (t < T) dst[(int64_t)t * a.m_l] = o[t];
    }
  }
  if (a.ksplit == 1) return;
  int* tile_sem = a.sem + tile * a.nrb + rbi;
  if (!arrive_last(tile_sem, a.ksplit)) return;
  // the tile's (row, shard) segments of `width` columns, split by split
  const int rows = a.rows;
  auto off = [=](int it) -> int64_t {
    const int rr = it / T, t = it - rr * T, row = r0 + rr;
    return row < rows ? (int64_t)row * m + (int64_t)t * m_l + c0 : -1;
  };
  void* out = a.out;
  const int obf = a.x_bf16;
  auto store = [=](int64_t o, float v) { st_as(out, obf, o, v); };
  // 16-byte reads of the partials where every tile starts on a vector
  if (ASYNC && lead == 0)
    stream::add_splits<true>(a.ws, (int64_t)a.rows * m, a.ksplit, RB * T,
                             width, off, store, NT);
  else
    stream::add_splits<false>(a.ws, (int64_t)a.rows * m, a.ksplit, RB * T,
                              width, off, store, NT);
  if (threadIdx.x == 0) *tile_sem = 0;
}

// Launch (grid > 0) or report the resident blocks per SM (*occ) of one
// instantiation for the code (T, R). The dynamic shared memory limit is
// raised once per instantiation.
template <int TT, int RR, int NSPW, int RB, bool ASYNC, typename W>
static int run(int T, int R, const CodedArgs& a, const CUtensorMap& tm_w,
               const CUtensorMap& tm_p, int grid, cudaStream_t st,
               int* occ) {
  const int NT = 32 * ((T + R + NSPW - 1) / NSPW + 1);
  using G = stream::Geo<RB>;
  constexpr int smem = G::SMEM;
  static_assert(TT == 0 || stream::rb_fits(RB, TT + RR),
                "the epilogue's sums fit the ring and the staging");
  auto kern = coded_stream_kernel<TT, RR, NSPW, RB, ASYNC, W>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  if (occ != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, NT,
                                                              smem);
  kern<<<grid, NT, smem, st>>>(a, tm_w, tm_p);
  return (int)cudaGetLastError();
}

template <int TT, int RR, int NSPW, typename W>
static int pick(int T, int R, int rb, int async, const CodedArgs& a,
                const CUtensorMap& mw, const CUtensorMap& mp, int grid,
                cudaStream_t st, int* occ) {
#define CDC_RUN(RBV)                                                       \
  return async ? run<TT, RR, NSPW, RBV, true, W>(T, R, a, mw, mp, grid, st, \
                                                 occ)                      \
               : run<TT, RR, NSPW, RBV, false, W>(T, R, a, mw, mp, grid,   \
                                                  st, occ);
  if (!stream::rb_fits(rb, T + R)) return (int)cudaErrorInvalidValue;
  if (rb == 4) { CDC_RUN(4) }
  // 8 rows hold at most 24 streams, 16 rows 12: never three streams a
  // warp, or two
  if constexpr (NSPW < 3) {
    if (rb == 8) { CDC_RUN(8) }
  }
  if constexpr (NSPW == 1 && (TT == 0 || stream::rb_fits(16, TT + RR))) {
    if (rb == 16) { CDC_RUN(16) }
  }
#undef CDC_RUN
  return (int)cudaErrorInvalidValue;
}

// The translation unit's cases (T, R) of storage type W, and with
// CDC_CODED_ANY the generic instantiation for every other 2 <= T <=
// MAX_T, 1 <= R <= T; anything else returns cudaErrorInvalidValue. The
// case key T * 32 + R is unique because R <= MAX_T < 32.
template <typename W>
static int dispatch_w(int T, int R, int rb, int async, const CodedArgs& a,
                      const CUtensorMap& mw, const CUtensorMap& mp, int grid,
                      cudaStream_t st, int* occ) {
#define CDC_CASE(TT, RR) \
  case TT * 32 + RR:     \
    return pick<TT, RR, 1, W>(T, R, rb, async, a, mw, mp, grid, st, occ);
  switch (T * 32 + R) {
    CDC_CODED_CASES(CDC_CASE)
    default:
      break;
  }
#undef CDC_CASE
#ifdef CDC_CODED_ANY
  if (T >= 2 && T <= MAX_T && R >= 1 && R <= T) {
    switch (streams_per_warp(T + R)) {
      case 1:
        return pick<0, 0, 1, W>(T, R, rb, async, a, mw, mp, grid, st, occ);
      case 2:
        return pick<0, 0, 2, W>(T, R, rb, async, a, mw, mp, grid, st, occ);
      default:
        return pick<0, 0, 3, W>(T, R, rb, async, a, mw, mp, grid, st, occ);
    }
  }
#endif
  return (int)cudaErrorInvalidValue;
}

static int dispatch(int T, int R, int w_bf16, int rb, int async,
                    const CodedArgs& a, const CUtensorMap& mw,
                    const CUtensorMap& mp, int grid, cudaStream_t st,
                    int* occ) {
#define CDC_TYPE(WT)                                                 \
  if (w_bf16 == (int)std::is_same<WT, __nv_bfloat16>::value)         \
    return dispatch_w<WT>(T, R, rb, async, a, mw, mp, grid, st, occ);
  CDC_CODED_TYPES(CDC_TYPE)
#undef CDC_TYPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdc

// C interface (loaded with ctypes).
//
// cdc_coded_matmul_occupancy: resident blocks per SM of the instantiation
// (T, R, w_bf16, rb, async), or minus the cudaError_t.
extern "C" int cdc_coded_matmul_occupancy(int T, int R, int w_bf16, int rb,
                                          int async) {
  int occ = 0;
  const CUtensorMap none{};
  const int err = cdc::dispatch(T, R, w_bf16, rb, async, cdc::CodedArgs{},
                                none, none, 0, nullptr, &occ);
  return err != 0 ? -err : occ;
}

// Elements by which a box row is wider than its tile: on the copy engine a
// vector where a slice or shard width is no whole number of 16-byte
// vectors (the box starts at the boundary before its tile); on the row
// copies always a vector (a row's granules start up to 15 bytes before
// it).
static int coded_lead(int V, int async, int m_l, int wd) {
  return !async || m_l % V || wd % V ? V : 0;
}

template <typename W>
static bool coded_plan_ok(int rows, int k, int T, int R, int m_l,
                          long long ldw, int folded, int rb, int async,
                          int bn, int tps, int wd, int nrb, int ksplit,
                          int kchunk, int ks, const void* w, const void* pw) {
  using namespace cdc;
  constexpr int V = stream::vec_elems<W>();
  const int S = T + R;
  const int pitch = stream::pitch_of<W>(bn) + coded_lead(V, async, m_l, wd);
  const int n_slices = folded ? T : 1;
  const int pstride = folded ? R * wd : m_l;   // the parity's row
  return rows >= 1 && k >= 1 && m_l >= 1 && bn >= 1 &&
         bn <= stream::bn_max(rb) && pitch <= 256 &&
         S <= 2 * MAX_T && stream::rb_fits(rb, S) && ks >= 1 && ks <= 256 &&
         S * stream::box_elems<W>(ks, pitch) <= stream::stage_elems<W>() &&
         kchunk >= 1 && kchunk <= stream::kmax(rb) &&
         (int64_t)ksplit * kchunk >= k &&
         (int64_t)(ksplit - 1) * kchunk < k && nrb * rb >= rows &&
         (int64_t)tps * bn >= wd && (int64_t)(tps - 1) * bn < wd &&
         wd * n_slices == m_l &&
         (!async || (bn % V == 0 && ldw % V == 0 && pstride % V == 0 &&
                     wd % (V / 2) == 0 && m_l % (V / 2) == 0 &&
                     ((uintptr_t)w | (uintptr_t)pw) % 16 == 0));
}

// cdc_coded_matmul: one launch of the plan (rb, async, bn, tps, wd, nrb,
// ksplit, kchunk, ks) from kernels/cdc_matmul.py: coded_plan. x and out are
// bf16 when x_bf16 (else float32), w and pw when w_bf16. A plan the kernel
// cannot run returns cudaErrorInvalidValue; otherwise the cudaError_t of
// the launch.
extern "C" int cdc_coded_matmul(
    const void* x, int x_bf16, const void* w, const void* pw, int w_bf16,
    const float* gen, const int* esel, const float* coef, const float* gamma,
    float eps, void* out, float* ws, int* sem, int rows, int k, int T, int R,
    int m_l, long long ldw, int folded, unsigned valid_bits, int rb,
    int async, int bn, int tps, int wd, int nrb, int ksplit, int kchunk,
    int ks, void* stream) {
  using namespace cdc;
  const int n_slices = folded ? T : 1;
  const bool ok =
      w_bf16 ? coded_plan_ok<__nv_bfloat16>(rows, k, T, R, m_l, ldw, folded,
                                            rb, async, bn, tps, wd, nrb,
                                            ksplit, kchunk, ks, w, pw)
             : coded_plan_ok<float>(rows, k, T, R, m_l, ldw, folded, rb,
                                    async, bn, tps, wd, nrb, ksplit, kchunk,
                                    ks, w, pw);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int lead = coded_lead(w_bf16 ? 8 : 4, async, m_l, wd);
  // the row copies take a stream's rows by tensor map where its base and
  // row stride are whole 16-byte units (granite's w at T = 12), else by
  // cp.async (its folded parity: rows of 712 bytes)
  const int e = w_bf16 ? 2 : 4;
  const int pstride = folded ? R * wd : m_l;
  const int wmap = async || ((uintptr_t)w % 16 == 0 && ldw * e % 16 == 0);
  const int pmap = async || ((uintptr_t)pw % 16 == 0 &&
                             (int64_t)pstride * e % 16 == 0);
  const CodedArgs a{x,   w,         pw,   gen, esel, coef,  gamma,
                    eps, out,       ws,   sem, rows, k,     m_l,
                    ldw, folded,    valid_bits,      bn,    tps,
                    wd,  nrb,       ksplit,          kchunk, ks, x_bf16,
                    lead, T,        R,   wmap, pmap};
  const long long grid = (long long)n_slices * tps * nrb * ksplit;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap mw{}, mp{};
  {
    // the box's inner extent is the pitch: whole 16-byte vectors
    const int pitch = lead + (w_bf16 ? stream::pitch_of<__nv_bfloat16>(bn)
                                     : stream::pitch_of<float>(bn));
    const cuuint32_t box[3] = {(cuuint32_t)pitch, (cuuint32_t)ks, 1};
    const cuuint64_t wdims[2] = {(cuuint64_t)T * m_l, (cuuint64_t)k};
    const cuuint64_t wstr[1] = {(cuuint64_t)ldw * e};
    const cuuint64_t inner = (cuuint64_t)pstride;
    const cuuint64_t pdims[3] = {inner, (cuuint64_t)k, (cuuint64_t)(folded
                                                                  ? T : R)};
    const cuuint64_t pstr[2] = {inner * e, inner * e * k};
    if ((wmap && !stream::encode_map(&mw, w, 2, wdims, wstr, box, w_bf16)) ||
        (pmap && !stream::encode_map(&mp, pw, 3, pdims, pstr, box, w_bf16)))
      return (int)cudaErrorInvalidValue;
  }
  return dispatch(T, R, w_bf16, rb, async, a, mw, mp, (int)grid,
                  static_cast<cudaStream_t>(stream), nullptr);
}
