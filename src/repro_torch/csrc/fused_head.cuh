// Fused coded LM head + Eq. 12 decode + greedy argmax, sm_90a: weights
// stored as float32 or bf16, x as float32 or bf16, float32 math. Each
// translation unit cdc_fused_head*.cu instantiates a set of T and storage
// types (CDC_HEAD_TS, CDC_HEAD_TYPES) and becomes its own library; with
// CDC_HEAD_ANY (cdc_fused_head_any.cu) the generic instantiation takes
// every other 2 <= T <= 16 as a runtime value (T + 1 <= 17 consumer
// warps, its per-shard arrays MAX_T wide in unrolled loops).
//
// Replaces the TPU kernel cdc_fused_head_argmax_pallas
// (src/repro/kernels/cdc_decode.py): the T head-shard GEMMs and the
// sum-parity GEMM, Eq. 12 recovery of <= 1 dead shard by MULTIPLY with the
// mask (as that kernel does), merged ids >= vocab pushed to -1e30, and the
// argmax over the merged vocabulary with ties going to the smallest id.
// The [b, vocab] logits never reach device memory.
//
// What bounds it: the bytes of the head shards and the parity
// ((T + 1) * k * m_l float32: 1.0 GB for granite-3-8b at T = 4, ~300 us
// at 3.35 TB/s); b is the number of decode slots, a few FMAs per weight.
// What the design does about it:
//  * the weights stream through the mainloop of stream_tile.cuh, as in
//    kernel 1: a producer warp keeps 32 KB stages in flight, each stage
//    one TMA box [ks, bn] per stream (S = T + 1: the T head shards and the
//    sum parity), and one consumer warp per stream does the FMAs from
//    shared memory with 16-byte reads;
//  * the head shards are read in place: column shards of lm_head.w
//    (shard_stride <= ldw) through ONE 2-D tensor map [k, (T - 1) *
//    shard_stride + m_l], each box at column s * shard_stride + c0. A box
//    of a shard's last tile (m_l = 12292 is not a multiple of the tile)
//    runs into the next shard past m_l, zeros past the last one; those
//    columns are never read back. Shards stored one after another take a
//    3-D map [T, k, m_l]. The parity [k, m_l] goes through a 2-D map;
//  * the launch plan (kernels/cdc_decode.py: head_plan) splits k so that
//    (tiles x row blocks x splits) fills whole waves of the resident
//    blocks. Each split writes its S raw partial sums to a workspace; the
//    last split of a (tile, row block) adds them in split order, then
//    decodes, masks and writes the tile's per-row (max, id); the last
//    tile of a row block reduces those in tile order with the same tie
//    rule. One launch, deterministic; with one split no workspace;
//  * shapes whose segments or strides are not multiples of 16 bytes take
//    the same kernel with the consumer warps copying the streams' k rows
//    granule by granule by cp.async and reading each row at its own offset
//    (stream_tile.cuh: consume_shifted);
//  * bf16 weights travel as bf16 and widen to float32 in the consumers'
//    registers. A copy must start on a 16-byte boundary, so where column
//    shards start between two (a bf16 head of m_l = 12292) every box row
//    is 8 elements wider (`lead`) and starts at the boundary before its
//    tile; the consumer of a shard that starts 4 elements past one reads
//    its rows 4 elements in, in 8-byte halves.
#pragma once

#include <type_traits>

#include "coded_tile.cuh"
#include "stream_tile.cuh"

namespace cdc {

constexpr float NEG_INF_LOGIT = -1e30f;

struct HeadArgs {
  const void* x;      // float32 or bf16 (x_bf16)
  const void* w;      // the storage type W of the instantiation
  const void* pw;
  float* ws;          // [ksplit][tiles * nrb][S * RB * BN] raw partials
  float* part_val;    // [tiles, b] per-tile max
  int* part_idx;      // [tiles, b] per-tile argmax
  int* sem;           // [tiles * nrb] split counters, then [nrb] tile ones
  int* tok;
  float* vmax;
  int b, k, m_l;
  int64_t shard_stride, ldw, ldp;
  int vocab;
  unsigned valid_bits;
  int rows_outer;     // column shards, one 2-D map (else [T, k, m_l])
  int bn, tps, nrb, ksplit, kchunk, ks;
  int x_bf16;
  int lead;           // elements a box row may start before its tile
  int T;              // the code width (read by the generic instantiation)
};

// TT: the code width of an instantiation, or 0 for the generic one, which
// reads T <= MAX_T from the arguments.
// The generic one's 16-row blocks hold at most 12 streams (rb_fits): 13
// warps, and the registers that leaves each thread.
template <int TT, int RB, bool ASYNC, typename W>
__global__ void __launch_bounds__(32 * (TT ? TT + 2 : RB == 16 ? 13
                                                              : MAX_T + 2),
                                  (TT && RB < 16 && TT + 1 < 10) ? 2 : 1)
head_stream_kernel(const HeadArgs a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_p) {
  constexpr int TM = TT ? TT : MAX_T;            // arrays over the shards
  const int T = TT ? TT : a.T;
  const int S = T + 1, NC = 32 * S, NT = 32 * (S + 1), NW = S + 1;
  using G = stream::Geo<RB>;
  constexpr int BNS = G::BN, CPL = G::CPL;
  extern __shared__ __align__(128) float smem[];
  W* ring = reinterpret_cast<W*>(smem);
  float* xs = smem + G::RING;
  float* inv = xs + G::XS;
  uint64_t* full = reinterpret_cast<uint64_t*>(inv + 16);
  uint64_t* empty = full + G::NSTAGE;

  // unit -> (row block, column tile, split), row blocks fastest, as in
  // stream_plan.StreamPlan.units
  const int u = blockIdx.x;
  const int rbi = u % a.nrb, rest = u / a.nrb;
  const int tile = rest % a.tps, split = rest / a.tps;
  const int c0 = tile * a.bn, width = min(a.bn, a.m_l - c0);
  const int r0 = rbi * RB;
  const int kb0 = split * a.kchunk, kb1 = min(a.k, kb0 + a.kchunk);
  constexpr int V = stream::vec_elems<W>();
  const int pitch = stream::pitch_of<W>(a.bn) + a.lead;   // a box row
  const int sreg = stream::box_elems<W>(a.ks, pitch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // row copies: each consumer thread's copies arrive on `full` too
  stream::ring_init<G::NSTAGE>(full, empty, S, ASYNC ? 1 : 1 + NC);
  float acc[1][RB][CPL];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[0][rr][q] = 0.f;
  const int64_t ldw = a.ldw, sstr = a.shard_stride, ldp = a.ldp;
  const W* w = static_cast<const W*>(a.w);
  const W* pw = static_cast<const W*>(a.pw);
  // stream s's row kk of the tile (the row-copy instantiation's copies)
  auto src = [=](int s, int kk) -> const W* {
    return s < T ? w + (int64_t)s * sstr + (int64_t)kk * ldw + c0
                 : pw + (int64_t)kk * ldp + c0;
  };
  if (warp == S) {
    const int rows_outer = a.rows_outer;
    const CUtensorMap* mw = &tm_w;
    const CUtensorMap* mp = &tm_p;
    auto issue = [=](int s, int k0, W* dst, uint64_t* bar) {
      if (s >= T)
        stream::tma_2d(dst, mp, c0, k0, bar);
      else if (rows_outer)     // the vector boundary at or before it
        stream::tma_2d(dst, mw, (int)((s * sstr + c0) / V * V), k0, bar);
      else
        stream::tma_3d(dst, mw, c0, k0, s, bar);
    };
    // row copies: no tensor map, the consumers copy every stream's rows
    stream::produce<G::NSTAGE>(S, ASYNC ? S : 0, ASYNC ? 0 : S, issue, ring,
                               full, empty, kb0, kb1, a.ks, pitch, sreg);
  } else {
    if (a.x_bf16)
      stream::stage_x<RB>(static_cast<const __nv_bfloat16*>(a.x), a.b, a.k,
                          r0, kb0, kb1, nullptr, 0.f, xs, inv, NC);
    else
      stream::stage_x<RB>(static_cast<const float*>(a.x), a.b, a.k, r0, kb0,
                          kb1, nullptr, 0.f, xs, inv, NC);
    if constexpr (ASYNC) {
      const int shift =
          a.lead && warp < T ? (int)((warp * a.shard_stride + c0) % V) : 0;
      stream::consume<RB>(ring, full, empty, xs, warp, kb0, kb1, a.ks, pitch,
                          sreg, acc[0], shift);
    } else {
      stream::consume_shifted<RB, 1>(ring, full, empty, xs, warp, 1, S, kb0,
                                     kb1, a.ks, pitch, sreg, width, 0, S,
                                     warp, S, src, acc);
    }
  }
  __syncthreads();        // every stage consumed: reuse ring and staging
  float* tot = smem;      // [S][RB][BNS] <= G::RING + G::XS
  if (warp < S) stream::store_acc<RB, W, !ASYNC>(tot, warp, acc[0]);
  __syncthreads();

  const int rows_here = min(RB, a.b - r0);
  if (a.ksplit > 1) {
    // this split's raw sums of the S streams, [S * RB][BNS] per unit
    constexpr int V = ASYNC ? 4 : 1;
    const int64_t plane = (int64_t)a.tps * a.nrb * S * RB * BNS;
    const int64_t base = (int64_t)(tile * a.nrb + rbi) * S * RB * BNS;
    float* dst = a.ws + split * plane + base;
    const int wv = width / V, items = S * RB;
    for (int i = threadIdx.x; i < items * wv; i += NT) {
      const int it = i / wv, c = (i - it * wv) * V;
      if (it % RB >= rows_here) continue;
      if (ASYNC)
        *reinterpret_cast<float4*>(dst + it * BNS + c) =
            *reinterpret_cast<const float4*>(tot + it * BNS + c);
      else
        dst[it * BNS + c] = tot[it * BNS + c];
    }
    int* split_sem = a.sem + tile * a.nrb + rbi;
    if (!arrive_last(split_sem, a.ksplit)) return;
    // the last split adds every split's sums in split order into tot
    auto off = [=](int it) -> int64_t {
      return it % RB < rows_here ? base + (int64_t)it * BNS : -1;
    };
    auto store = [=](int64_t o, float v) { tot[o - base] = v; };
    stream::add_splits<ASYNC>(a.ws, plane, a.ksplit, items, width, off,
                              store, NT);
    __syncthreads();
    if (threadIdx.x == 0) *split_sem = 0;
  }

  // epilogue: warp w owns rows w, w + NW, ...; each lane decodes columns
  // lane, lane + 32, ... of every shard (multiply by the mask, as the
  // reference does), masks ids >= vocab, and the warp reduces (max, id)
  for (int rr = warp; rr < rows_here; rr += NW) {
    float best = -INFINITY;
    int bid = 0x7fffffff;
    for (int c = lane; c < width; c += 32) {
      float yz[TM];
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if (t >= T) break;
        const float vm = ((a.valid_bits >> t) & 1u) ? 1.f : 0.f;
        yz[t] = tot[(t * RB + rr) * BNS + c] * vm;
        sum += yz[t];
      }
      const float miss = tot[(T * RB + rr) * BNS + c] - sum;
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if (t >= T) break;
        const float vm = ((a.valid_bits >> t) & 1u) ? 1.f : 0.f;
        const int gid = t * a.m_l + c0 + c;
        const float logit =
            gid < a.vocab ? yz[t] + (1.f - vm) * miss : NEG_INF_LOGIT;
        argmax_merge(best, bid, logit, gid);
      }
    }
    warp_argmax(best, bid);
    if (lane == 0) {
      a.part_val[(int64_t)tile * a.b + r0 + rr] = best;
      a.part_idx[(int64_t)tile * a.b + r0 + rr] = bid;
    }
  }

  // the last tile of this row block reduces the tiles' (max, id)
  int* row_sem = a.sem + a.tps * a.nrb + rbi;
  if (!arrive_last(row_sem, a.tps)) return;
  for (int rr = warp; rr < rows_here; rr += NW) {
    const int row = r0 + rr;
    float best = -INFINITY;
    int bid = 0x7fffffff;
    for (int i = lane; i < a.tps; i += 32)
      argmax_merge(best, bid, __ldcg(a.part_val + (int64_t)i * a.b + row),
                   __ldcg(a.part_idx + (int64_t)i * a.b + row));
    warp_argmax(best, bid);
    if (lane == 0) {
      a.tok[row] = bid;
      a.vmax[row] = best;
    }
  }
  if (threadIdx.x == 0) *row_sem = 0;
}

// Launch (grid > 0) or report the resident blocks per SM (*occ) of one
// instantiation at code width T. The dynamic shared memory limit is raised
// once per instantiation.
template <int TT, int RB, bool ASYNC, typename W>
static int run(int T, const HeadArgs& a, const CUtensorMap& tm_w,
               const CUtensorMap& tm_p, int grid, cudaStream_t st,
               int* occ) {
  const int NT = 32 * (T + 2);
  using G = stream::Geo<RB>;
  constexpr int smem = G::SMEM;
  static_assert(TT == 0 || stream::rb_fits(RB, TT + 1),
                "the epilogue's sums fit the ring and the staging");
  auto kern = head_stream_kernel<TT, RB, ASYNC, W>;
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

template <int TT, typename W>
static int pick(int T, int rb, int async, const HeadArgs& a,
                const CUtensorMap& mw, const CUtensorMap& mp, int grid,
                cudaStream_t st, int* occ) {
  if (!stream::rb_fits(rb, T + 1)) return (int)cudaErrorInvalidValue;
  if (rb == 4)
    return async ? run<TT, 4, true, W>(T, a, mw, mp, grid, st, occ)
                 : run<TT, 4, false, W>(T, a, mw, mp, grid, st, occ);
  if (rb == 8)
    return async ? run<TT, 8, true, W>(T, a, mw, mp, grid, st, occ)
                 : run<TT, 8, false, W>(T, a, mw, mp, grid, st, occ);
  if constexpr (TT == 0 || stream::rb_fits(16, TT + 1)) {
    if (rb == 16)
      return async ? run<TT, 16, true, W>(T, a, mw, mp, grid, st, occ)
                   : run<TT, 16, false, W>(T, a, mw, mp, grid, st, occ);
  }
  return (int)cudaErrorInvalidValue;
}

// The translation unit's T of storage type W, and with CDC_HEAD_ANY the
// generic instantiation for every other 2 <= T <= MAX_T; anything else
// returns cudaErrorInvalidValue.
template <typename W>
static int dispatch_w(int T, int rb, int async, const HeadArgs& a,
                      const CUtensorMap& mw, const CUtensorMap& mp, int grid,
                      cudaStream_t st, int* occ) {
#define CDC_CASE(TT) \
  case TT:           \
    return pick<TT, W>(T, rb, async, a, mw, mp, grid, st, occ);
  switch (T) {
    CDC_HEAD_TS(CDC_CASE)
    default:
      break;
  }
#undef CDC_CASE
#ifdef CDC_HEAD_ANY
  if (T >= 2 && T <= MAX_T)
    return pick<0, W>(T, rb, async, a, mw, mp, grid, st, occ);
#endif
  return (int)cudaErrorInvalidValue;
}

static int dispatch(int T, int w_bf16, int rb, int async, const HeadArgs& a,
                    const CUtensorMap& mw, const CUtensorMap& mp, int grid,
                    cudaStream_t st, int* occ) {
#define CDC_TYPE(WT)                                              \
  if (w_bf16 == (int)std::is_same<WT, __nv_bfloat16>::value)      \
    return dispatch_w<WT>(T, rb, async, a, mw, mp, grid, st, occ);
  CDC_HEAD_TYPES(CDC_TYPE)
#undef CDC_TYPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdc

// C interface (loaded with ctypes).
//
// cdc_fused_head_occupancy: resident blocks per SM of the instantiation
// (T, w_bf16, rb, async), or minus the cudaError_t.
extern "C" int cdc_fused_head_occupancy(int T, int w_bf16, int rb,
                                        int async) {
  int occ = 0;
  const CUtensorMap none{};
  const int err = cdc::dispatch(T, w_bf16, rb, async, cdc::HeadArgs{}, none,
                                none, 0, nullptr, &occ);
  return err != 0 ? -err : occ;
}

// cdc_fused_head_argmax: one launch of the plan (rb, async, bn, tps, nrb,
// ksplit, kchunk, ks) from kernels/cdc_decode.py: head_plan. x is bf16 when
// x_bf16 (else float32), w and pw when w_bf16. ws holds ksplit * tps * nrb
// * (T + 1) * rb * bn_max(rb) floats when ksplit > 1; part_val / part_idx
// tps * b; sem tps * nrb + nrb zeroed counters (left zeroed). On the copy
// engine, column shards of one matrix (shard_stride <= ldw) take the 2-D
// map, shards stored one after another the 3-D one. The parity's rows are
// ldp >= m_l apart (on the copy engine whole 16-byte vectors: a bf16
// parity of m_l = 12292 lives in padded rows). A plan the kernel cannot
// run returns cudaErrorInvalidValue; otherwise the cudaError_t of the
// launch.
extern "C" int cdc_fused_head_argmax(
    const void* x, int x_bf16, const void* w, const void* pw, int w_bf16,
    float* ws, float* part_val, int* part_idx, int* sem, int* tok,
    float* vmax, int b, int k, int T, int m_l, long long shard_stride,
    long long ldw, long long ldp, int vocab, unsigned valid_bits, int rb,
    int async, int bn, int tps, int nrb, int ksplit, int kchunk, int ks,
    void* stream) {
  using namespace cdc;
  const int S = T + 1;
  const int V = w_bf16 ? 8 : 4;
  // column shards take the 2-D map, with box rows a vector wider where
  // they start half a vector past a 16-byte boundary; stacked shards the
  // 3-D map [T, k, m_l]
  const int rows_outer = shard_stride <= ldw;
  const int lead = !async || (rows_outer && shard_stride % V) ? V : 0;
  const int pitch = (bn + V - 1) / V * V + lead;
  const int box = w_bf16 ? stream::box_elems<__nv_bfloat16>(ks, pitch)
                         : stream::box_elems<float>(ks, pitch);
  const int stage = w_bf16 ? stream::stage_elems<__nv_bfloat16>()
                           : stream::stage_elems<float>();
  const bool ok =
      b >= 1 && k >= 1 && m_l >= 1 && bn >= 1 && bn <= stream::bn_max(rb) &&
      pitch <= 256 && T <= MAX_T && stream::rb_fits(rb, S) && ks >= 1 &&
      ks <= 256 &&
      S * box <= stage && kchunk >= 1 && kchunk <= stream::kmax(rb) &&
      (int64_t)ksplit * kchunk >= k && (int64_t)(ksplit - 1) * kchunk < k &&
      nrb * rb >= b && (nrb - 1) * rb < b && (int64_t)tps * bn >= m_l &&
      (int64_t)(tps - 1) * bn < m_l && (int64_t)T * m_l < 0x7fffffff &&
      ldp >= m_l &&
      (!async ||
       (bn % V == 0 && m_l % 4 == 0 && ldw % V == 0 && ldp % V == 0 &&
        (rows_outer ? shard_stride % 4 == 0 &&
                          (T - 1) * shard_stride + m_l < 0x7fffffff
                    : m_l % V == 0 && shard_stride % V == 0) &&
        ((uintptr_t)w | (uintptr_t)pw) % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const HeadArgs a{x,     w,        pw,  ws,    part_val,   part_idx,
                   sem,   tok,      vmax, b,    k,          m_l,
                   shard_stride,    ldw, ldp, vocab, valid_bits, rows_outer,
                   bn,    tps,      nrb, ksplit, kchunk,    ks,
                   x_bf16, lead,    T};
  const long long grid = (long long)tps * nrb * ksplit;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap mw{}, mp{};
  if (async) {
    const cuuint64_t e = w_bf16 ? 2 : 4;
    const cuuint32_t box2[2] = {(cuuint32_t)pitch, (cuuint32_t)ks};
    const cuuint64_t pdims[2] = {(cuuint64_t)m_l, (cuuint64_t)k};
    const cuuint64_t pstr[1] = {(cuuint64_t)ldp * e};
    bool good;
    if (rows_outer) {
      const cuuint64_t wdims[2] = {(cuuint64_t)(T - 1) * shard_stride + m_l,
                                   (cuuint64_t)k};
      const cuuint64_t wstr[1] = {(cuuint64_t)ldw * e};
      good = stream::encode_map(&mw, w, 2, wdims, wstr, box2, w_bf16);
    } else {
      const cuuint32_t wbox[3] = {(cuuint32_t)pitch, (cuuint32_t)ks, 1u};
      const cuuint64_t wdims[3] = {(cuuint64_t)m_l, (cuuint64_t)k,
                                   (cuuint64_t)T};
      const cuuint64_t wstr[2] = {(cuuint64_t)ldw * e,
                                  (cuuint64_t)shard_stride * e};
      good = stream::encode_map(&mw, w, 3, wdims, wstr, wbox, w_bf16);
    }
    if (!good || !stream::encode_map(&mp, pw, 2, pdims, pstr, box2, w_bf16))
      return (int)cudaErrorInvalidValue;
  }
  return dispatch(T, w_bf16, rb, async, a, mw, mp, (int)grid,
                  static_cast<cudaStream_t>(stream), nullptr);
}
