// Fused coded LM head + Eq. 12 decode + greedy argmax, float32, sm_90a.
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
//  * the head shards are read in place from lm_head.w through ONE 3-D
//    tensor map with lm_head.w's strides ([k, T, m_l], or [T, k, m_l]
//    for shards stored one after another: the smaller stride inner), so
//    a box never runs into the next shard: m_l = 12292 is not a multiple
//    of the tile, and the copy engine fills the columns past m_l with
//    zeros. The parity [k, m_l] goes through a 2-D map;
//  * the launch plan (kernels/cdc_decode.py: head_plan) splits k so that
//    (tiles x row blocks x splits) fills whole waves of the resident
//    blocks. Each split writes its S raw partial sums to a workspace; the
//    last split of a (tile, row block) adds them in split order, then
//    decodes, masks and writes the tile's per-row (max, id); the last
//    tile of a row block reduces those in tile order with the same tie
//    rule. One launch, deterministic; with one split no workspace;
//  * shapes whose segments or strides are not multiples of 16 bytes take
//    the same kernel with the producer copying by ordinary loads.
#include "coded_tile.cuh"
#include "stream_tile.cuh"

namespace cdc {

constexpr float NEG_INF_LOGIT = -1e30f;

struct HeadArgs {
  const float* x;
  const float* w;
  const float* pw;
  float* ws;          // [ksplit][tiles * nrb][S * RB * BN] raw partials
  float* part_val;    // [tiles, b] per-tile max
  int* part_idx;      // [tiles, b] per-tile argmax
  int* sem;           // [tiles * nrb] split counters, then [nrb] tile ones
  int* tok;
  float* vmax;
  int b, k, m_l;
  int64_t shard_stride, ldw;
  int vocab;
  unsigned valid_bits;
  int rows_outer;     // the shards' map is [k, T, m_l] (else [T, k, m_l])
  int bn, tps, nrb, ksplit, kchunk, ks;
};

template <int T, int RB, bool ASYNC>
__global__ void __launch_bounds__(32 * (T + 2),
                                  (RB < 16 && T + 1 < 10) ? 2 : 1)
head_stream_kernel(const HeadArgs a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_p) {
  constexpr int S = T + 1, NC = 32 * S, NT = 32 * (S + 1), NW = S + 1;
  using G = stream::Geo<RB>;
  constexpr int BNS = G::BN, CPL = G::CPL;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* xs = ring + G::RING;
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
  const int pitch = (a.bn + 3) & ~3, sreg = stream::box_floats(a.ks, pitch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stream::ring_init<G::NSTAGE>(full, empty, S);
  float acc[RB][CPL];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[rr][q] = 0.f;
  if (warp == S) {
    const int m_l = a.m_l, rows_outer = a.rows_outer;
    const int64_t ldw = a.ldw, sstr = a.shard_stride;
    const float* w = a.w;
    const float* pw = a.pw;
    const CUtensorMap* mw = &tm_w;
    const CUtensorMap* mp = &tm_p;
    auto issue = [=](int s, int k0, float* dst, uint64_t* bar) {
      if (s >= T)
        stream::tma_2d(dst, mp, c0, k0, bar);
      else if (rows_outer)
        stream::tma_3d(dst, mw, c0, s, k0, bar);
      else
        stream::tma_3d(dst, mw, c0, k0, s, bar);
    };
    auto src = [=](int s, int kk) -> const float* {
      return s < T ? w + (int64_t)s * sstr + (int64_t)kk * ldw + c0
                   : pw + (int64_t)kk * m_l + c0;
    };
    stream::produce<S, G::NSTAGE, ASYNC>(issue, src, ring, full, empty, kb0,
                                         kb1, a.ks, width, pitch, sreg);
  } else {
    stream::stage_x<RB>(a.x, a.b, a.k, r0, kb0, kb1, nullptr, 0.f, xs, inv,
                        NC);
    stream::consume<RB>(ring, full, empty, xs, warp, kb0, kb1, a.ks, pitch,
                        sreg, acc);
  }
  __syncthreads();        // every stage consumed: reuse ring and staging
  float* tot = ring;      // [S][RB][BNS] <= G::RING + G::XS
  if (warp < S) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int j = 0; j < CPL / 4; ++j)
        *reinterpret_cast<float4*>(tot + (warp * RB + rr) * BNS + lane * 4 +
                                   128 * j) =
            make_float4(acc[rr][4 * j], acc[rr][4 * j + 1],
                        acc[rr][4 * j + 2], acc[rr][4 * j + 3]);
  }
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
      float yz[T];
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float vm = ((a.valid_bits >> t) & 1u) ? 1.f : 0.f;
        yz[t] = tot[(t * RB + rr) * BNS + c] * vm;
        sum += yz[t];
      }
      const float miss = tot[(T * RB + rr) * BNS + c] - sum;
#pragma unroll
      for (int t = 0; t < T; ++t) {
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
// instantiation. The dynamic shared memory limit is raised once per
// instantiation.
template <int T, int RB, bool ASYNC>
static int run(const HeadArgs& a, const CUtensorMap& tm_w,
               const CUtensorMap& tm_p, int grid, cudaStream_t st,
               int* occ) {
  constexpr int NT = 32 * (T + 2);
  using G = stream::Geo<RB>;
  constexpr int smem = G::SMEM;
  static_assert((T + 1) * RB * G::BN <= G::RING + G::XS,
                "the epilogue's sums fit the ring and the staging");
  auto kern = head_stream_kernel<T, RB, ASYNC>;
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

template <int T>
static int pick(int rb, int async, const HeadArgs& a, const CUtensorMap& mw,
                const CUtensorMap& mp, int grid, cudaStream_t st, int* occ) {
  if (rb == 4)
    return async ? run<T, 4, true>(a, mw, mp, grid, st, occ)
                 : run<T, 4, false>(a, mw, mp, grid, st, occ);
  if (rb == 8)
    return async ? run<T, 8, true>(a, mw, mp, grid, st, occ)
                 : run<T, 8, false>(a, mw, mp, grid, st, occ);
  if (rb == 16)
    return async ? run<T, 16, true>(a, mw, mp, grid, st, occ)
                 : run<T, 16, false>(a, mw, mp, grid, st, occ);
  return (int)cudaErrorInvalidValue;
}

// T in {2, 4, 8}; anything else returns cudaErrorInvalidValue.
static int dispatch(int T, int rb, int async, const HeadArgs& a,
                    const CUtensorMap& mw, const CUtensorMap& mp, int grid,
                    cudaStream_t st, int* occ) {
  switch (T) {
    case 2:
      return pick<2>(rb, async, a, mw, mp, grid, st, occ);
    case 4:
      return pick<4>(rb, async, a, mw, mp, grid, st, occ);
    case 8:
      return pick<8>(rb, async, a, mw, mp, grid, st, occ);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cdc

// C interface (loaded with ctypes).
//
// cdc_fused_head_occupancy: resident blocks per SM of the instantiation
// (T, rb, async), or minus the cudaError_t.
extern "C" int cdc_fused_head_occupancy(int T, int rb, int async) {
  int occ = 0;
  const CUtensorMap none{};
  const int err = cdc::dispatch(T, rb, async, cdc::HeadArgs{}, none, none,
                                0, nullptr, &occ);
  return err != 0 ? -err : occ;
}

// cdc_fused_head_argmax_f32: one launch of the plan (rb, async, bn, tps,
// nrb, ksplit, kchunk, ks) from kernels/cdc_decode.py: head_plan. ws holds
// ksplit * tps * nrb * (T + 1) * rb * bn_max(rb) floats when ksplit > 1;
// part_val / part_idx tps * b; sem tps * nrb + nrb zeroed counters (left
// zeroed). A plan the kernel cannot run returns cudaErrorInvalidValue;
// otherwise the cudaError_t of the launch.
extern "C" int cdc_fused_head_argmax_f32(
    const float* x, const float* w, const float* pw, float* ws,
    float* part_val, int* part_idx, int* sem, int* tok, float* vmax, int b,
    int k, int T, int m_l, long long shard_stride, long long ldw, int vocab,
    unsigned valid_bits, int rb, int async, int bn, int tps, int nrb,
    int ksplit, int kchunk, int ks, void* stream) {
  using namespace cdc;
  const int S = T + 1, pitch = (bn + 3) & ~3;
  const bool ok =
      b >= 1 && k >= 1 && m_l >= 1 && bn >= 1 && bn <= stream::bn_max(rb) &&
      ks >= 1 && ks <= 256 &&
      S * stream::box_floats(ks, pitch) <= stream::STAGE_FLOATS &&
      kchunk >= 1 && kchunk <= stream::kmax(rb) &&
      (int64_t)ksplit * kchunk >= k && (int64_t)(ksplit - 1) * kchunk < k &&
      nrb * rb >= b && (nrb - 1) * rb < b && (int64_t)tps * bn >= m_l &&
      (int64_t)(tps - 1) * bn < m_l && (int64_t)T * m_l < 0x7fffffff &&
      (!async || (bn % 4 == 0 && m_l % 4 == 0 && ldw % 4 == 0 &&
                  shard_stride % 4 == 0 &&
                  ((uintptr_t)w | (uintptr_t)pw) % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  // the shards' map puts the smaller of the two strides inner: [k, T, m_l]
  // for lm_head.w's column shards, [T, k, m_l] for stacked shards
  const int rows_outer = shard_stride <= ldw;
  const HeadArgs a{x,     w,        pw,  ws,    part_val,   part_idx,
                   sem,   tok,      vmax, b,    k,          m_l,
                   shard_stride,    ldw, vocab, valid_bits, rows_outer,
                   bn,    tps,      nrb, ksplit, kchunk,    ks};
  const long long grid = (long long)tps * nrb * ksplit;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap mw{}, mp{};
  if (async) {
    const cuuint32_t box[3] = {(cuuint32_t)bn, (cuuint32_t)ks, 1};
    const cuuint32_t wbox[3] = {(cuuint32_t)bn, rows_outer ? 1u : box[1],
                                rows_outer ? box[1] : 1u};
    const cuuint64_t inner = rows_outer ? T : k, outer = rows_outer ? k : T;
    const cuuint64_t wdims[3] = {(cuuint64_t)m_l, inner, outer};
    const cuuint64_t s_in = rows_outer ? shard_stride : ldw;
    const cuuint64_t s_out = rows_outer ? ldw : shard_stride;
    const cuuint64_t wstr[2] = {s_in * 4, s_out * 4};
    const cuuint64_t pdims[2] = {(cuuint64_t)m_l, (cuuint64_t)k};
    const cuuint64_t pstr[1] = {(cuuint64_t)m_l * 4};
    if (!stream::encode_f32(&mw, w, 3, wdims, wstr, wbox) ||
        !stream::encode_f32(&mp, pw, 2, pdims, pstr, box))
      return (int)cudaErrorInvalidValue;
  }
  return dispatch(T, rb, async, a, mw, mp, (int)grid,
                  static_cast<cudaStream_t>(stream), nullptr);
}
