// Blocked GEMM with float32 accumulation, sm_90a: out = x @ w.
//
// Replaces the TPU kernel matmul_pallas (src/repro/kernels/matmul.py),
// whose 128 x 128 MXU tiles accumulate across a sequential k grid axis in
// the output block. Hopper's blocks run in no order, so nothing is
// carried between them: each block loops over its own k range. Two paths,
// chosen by the launch plan (kernels/matmul.py: matmul_plan):
//
//  * few rows (M <= 16, float32 in; granite's Wo at 4 rows): bound by the
//    bytes of w (64 MB at [4096, 4096], 20 us at 3.35 TB/s). w streams
//    through the mainloop of stream_tile.cuh with S = 1: a producer warp
//    keeps 32 KB stages in flight, each one TMA box of w on an
//    mbarrier, one consumer warp does 4 x RB FMAs per 16-byte shared
//    read (RB = 4 for M <= 4, else 8, or 16 for a wide w). k is split so
//    that the grid fills whole waves of the resident blocks; the last
//    block of a tile adds the split partials in split order
//    (deterministic).
//  * square (the coded-cost study's 512^3): bound by the float32
//    operations (4 us at 67 TFLOP/s). 64 x 32 output tiles (128 blocks at
//    512^3), a 3-stage ring of x and w tiles filled by a producer warp
//    with one TMA box each (x's 128-byte rows swizzled, so the consumers'
//    reads of 4 rows hit 4 distinct banks), and 4 consumer warps whose
//    threads each keep a 4 x 4 register tile: per 4 k, four 16-byte reads
//    of x and four of w feed 64 FMAs.
//
// Shapes the copy engine cannot take (a row not a multiple of 16 bytes,
// bf16 storage) run the same kernels copying otherwise: the few-rows
// kernel's consumer warp copies each k row of w granule by granule by
// cp.async (stream_tile.cuh: consume_shifted), the square kernel's
// producer by ordinary loads (bf16 converted to float32 on the way into
// shared memory, zero past the edges). The sums are float32 on CUDA cores;
// out is float32 or bf16.
#include "coded_tile.cuh"
#include "stream_tile.cuh"

namespace cdc {

// ------------------------------------------------------ few rows ------

template <typename TO>
struct RowsArgs {
  const float* x;
  const float* w;
  TO* out;
  float* ws;
  int* sem;
  int M, N, K;
  int bn, nrb, ksplit, kchunk, ks;
};

template <int RB, typename TO, bool ASYNC>
__global__ void __launch_bounds__(64, 1)
matmul_rows_kernel(const RowsArgs<TO> a,
                   const __grid_constant__ CUtensorMap tm_w) {
  using G = stream::Geo<RB>;
  constexpr int CPL = G::CPL;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* xs = ring + G::RING;
  float* inv = xs + G::XS;
  uint64_t* full = reinterpret_cast<uint64_t*>(inv + 16);
  uint64_t* empty = full + G::NSTAGE;

  const int u = blockIdx.x;
  const int rbi = u % a.nrb, rest = u / a.nrb;
  const int tiles = (a.N + a.bn - 1) / a.bn;
  const int tile = rest % tiles, split = rest / tiles;
  const int c0 = tile * a.bn, width = min(a.bn, a.N - c0);
  const int r0 = rbi * RB;
  const int kb0 = split * a.kchunk, kb1 = min(a.K, kb0 + a.kchunk);
  // a box row: the tile in whole vectors, and on the row copies one more
  const int pitch = stream::pitch_of<float>(a.bn) + (ASYNC ? 0 : 4);
  const int sreg = stream::box_elems<float>(a.ks, pitch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // row copies: the consumer's copies arrive on `full` too
  stream::ring_init<G::NSTAGE>(full, empty, 1, ASYNC ? 1 : 33);
  float acc[1][RB][CPL];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[0][rr][q] = 0.f;
  const float* w = a.w;
  const int n = a.N;
  // the tile's row kk of w (the row-copy instantiation's copies)
  auto src = [=](int, int kk) -> const float* {
    return w + (int64_t)kk * n + c0;
  };
  if (warp == 1) {
    const CUtensorMap* mw = &tm_w;
    auto issue = [=](int, int k0, float* dst, uint64_t* bar) {
      stream::tma_2d(dst, mw, c0, k0, bar);
    };
    // row copies: no tensor map, the consumer copies w's rows
    stream::produce<G::NSTAGE>(1, ASYNC ? 1 : 0, ASYNC ? 0 : 1, issue, ring,
                               full, empty, kb0, kb1, a.ks, pitch, sreg);
  } else {
    stream::stage_x<RB>(a.x, a.M, a.K, r0, kb0, kb1, nullptr, 0.f, xs, inv,
                        32);
    if constexpr (ASYNC)
      stream::consume<RB>(ring, full, empty, xs, 0, kb0, kb1, a.ks, pitch,
                          sreg, acc[0]);
    else
      stream::consume_shifted<RB, 1>(ring, full, empty, xs, 0, 1, 1, kb0,
                                     kb1, a.ks, pitch, sreg, width, 0, 1, 0,
                                     1, src, acc);
    // the consumer writes its columns: final (one split) or partial
    const int64_t base = a.ksplit == 1 ? 0 : (int64_t)split * a.M * a.N;
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = stream::acc_col<RB, float, !ASYNC>(lane, q);
        if (r0 + rr < a.M && c < width) {
          const int64_t o = base + (int64_t)(r0 + rr) * a.N + c0 + c;
          if (a.ksplit == 1)
            st(a.out + o, acc[0][rr][q]);
          else
            a.ws[o] = acc[0][rr][q];
        }
      }
    }
  }
  if (a.ksplit == 1) return;
  int* tile_sem = a.sem + tile * a.nrb + rbi;
  if (!arrive_last(tile_sem, a.ksplit)) return;
  const int m = a.M;
  auto off = [=](int rr) -> int64_t {
    return r0 + rr < m ? (int64_t)(r0 + rr) * n + c0 : -1;
  };
  TO* out = a.out;
  auto store = [=](int64_t o, float v) { st(out + o, v); };
  stream::add_splits<ASYNC>(a.ws, (int64_t)a.M * a.N, a.ksplit, RB, width,
                            off, store, 64);
  if (threadIdx.x == 0) *tile_sem = 0;
}

template <int RB, typename TO, bool ASYNC>
static int run_rows(const RowsArgs<TO>& a, const CUtensorMap& tm, int grid,
                    cudaStream_t st, int* occ) {
  constexpr int smem = stream::Geo<RB>::SMEM;
  auto kern = matmul_rows_kernel<RB, TO, ASYNC>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  if (occ != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, 64,
                                                              smem);
  kern<<<grid, 64, smem, st>>>(a, tm);
  return (int)cudaGetLastError();
}

template <typename TO>
static int pick_rows(int rb, int async, const RowsArgs<TO>& a,
                     const CUtensorMap& tm, int grid, cudaStream_t st,
                     int* occ) {
  if (rb == 4)
    return async ? run_rows<4, TO, true>(a, tm, grid, st, occ)
                 : run_rows<4, TO, false>(a, tm, grid, st, occ);
  if (rb == 8)
    return async ? run_rows<8, TO, true>(a, tm, grid, st, occ)
                 : run_rows<8, TO, false>(a, tm, grid, st, occ);
  if (rb == 16)
    return async ? run_rows<16, TO, true>(a, tm, grid, st, occ)
                 : run_rows<16, TO, false>(a, tm, grid, st, occ);
  return (int)cudaErrorInvalidValue;
}

// -------------------------------------------------------- square ------

constexpr int SQ_BM = 64, SQ_BN = 32, SQ_BK = 32, SQ_NS = 3;
constexpr int SQ_CONSUMERS = 128;      // 4 warps; warp 4 produces

// x tiles are [SQ_BM][SQ_BK] with 128-byte rows stored as TMA's 128-byte
// swizzle writes them: 16-byte chunk c of row r sits at chunk c ^ (r & 7).
__device__ __forceinline__ int sq_swz(int r, int kk) {
  return r * SQ_BK + ((((kk >> 2) ^ (r & 7)) << 2) | (kk & 3));
}

template <typename TI, typename TO, bool ASYNC>
__global__ void __launch_bounds__(SQ_CONSUMERS + 32)
matmul_square_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                     TO* __restrict__ out, int M, int N, int K,
                     const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w) {
  __shared__ __align__(1024) float sx[SQ_NS][SQ_BM * SQ_BK];
  __shared__ __align__(128) float sw[SQ_NS][SQ_BK][SQ_BN];
  __shared__ __align__(8) uint64_t full[SQ_NS], empty[SQ_NS];
  const int row0 = blockIdx.y * SQ_BM, col0 = blockIdx.x * SQ_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nst = (K + SQ_BK - 1) / SQ_BK;
  if (tid == 0) {
    for (int i = 0; i < SQ_NS; ++i) {
      stream::mbar_init(&full[i], 1);
      stream::mbar_init(&empty[i], SQ_CONSUMERS / 32);
    }
    stream::mbar_fence_init();
  }
  __syncthreads();

  if (warp == SQ_CONSUMERS / 32) {
    const int mrows = min(SQ_BM, M - row0), wcols = min(SQ_BN, N - col0);
    for (int it = 0; it < nst; ++it) {
      const int s = it % SQ_NS, round = it / SQ_NS;
      const int k0 = it * SQ_BK, nk = min(SQ_BK, K - k0);
      if (round > 0) stream::mbar_wait(&empty[s], (round - 1) & 1);
      if (ASYNC) {
        // whole boxes; elements past M, N or K arrive as zeros
        if (lane == 0) {
          stream::mbar_arrive_tx(&full[s], (uint32_t)((SQ_BM + SQ_BN) *
                                                      SQ_BK * 4));
          stream::tma_2d(&sx[s][0], &tm_x, k0, row0, &full[s]);
          stream::tma_2d(&sw[s][0][0], &tm_w, col0, k0, &full[s]);
        }
      } else {
        for (int i = lane; i < SQ_BM * SQ_BK; i += 32) {
          const int r = i / SQ_BK, kk = i % SQ_BK;
          sx[s][sq_swz(r, kk)] =
              (r < mrows && kk < nk) ? ld(x + (int64_t)(row0 + r) * K + k0 + kk)
                                     : 0.f;
        }
        for (int i = lane; i < SQ_BK * SQ_BN; i += 32) {
          const int kk = i / SQ_BN, c = i % SQ_BN;
          sw[s][kk][c] = (kk < nk && c < wcols)
                             ? ld(w + (int64_t)(k0 + kk) * N + col0 + c)
                             : 0.f;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) stream::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: rows ty + 16 i (i < 4), columns 4 tx .. 4 tx + 3
  const int tx = tid % 8, ty = tid / 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < nst; ++it) {
    const int s = it % SQ_NS;
    const int nk4 = (min(SQ_BK, K - it * SQ_BK) + 3) & ~3;
    stream::mbar_wait(&full[s], (it / SQ_NS) & 1);
    for (int kk = 0; kk < nk4; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &sx[s][sq_swz(ty + 16 * i, kk)]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(&sw[s][kk + q][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(av[q], b[q].x, acc[i][0]);
          acc[i][1] = fmaf(av[q], b[q].y, acc[i][1]);
          acc[i][2] = fmaf(av[q], b[q].z, acc[i][2]);
          acc[i][3] = fmaf(av[q], b[q].w, acc[i][3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) stream::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < N) st(out + (int64_t)r * N + c, acc[i][j]);
    }
  }
}

template <typename TI, typename TO, bool ASYNC>
static int run_square(const void* x, const void* w, void* out, int M, int N,
                      int K, const CUtensorMap& tx, const CUtensorMap& tw,
                      cudaStream_t st) {
  const dim3 grid((N + SQ_BN - 1) / SQ_BN, (M + SQ_BM - 1) / SQ_BM);
  matmul_square_kernel<TI, TO, ASYNC><<<grid, SQ_CONSUMERS + 32, 0, st>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w),
      static_cast<TO*>(out), M, N, K, tx, tw);
  return (int)cudaGetLastError();
}

}  // namespace cdc

// C interface (loaded with ctypes).
//
// cdc_matmul_rows_occupancy: resident blocks per SM of the few-rows
// instantiation (rb, async, out_bf16), or minus the cudaError_t.
extern "C" int cdc_matmul_rows_occupancy(int rb, int async, int out_bf16) {
  using namespace cdc;
  int occ = 0;
  const CUtensorMap none{};
  const int err =
      out_bf16
          ? pick_rows<__nv_bfloat16>(rb, async, {}, none, 0, nullptr, &occ)
          : pick_rows<float>(rb, async, {}, none, 0, nullptr, &occ);
  return err != 0 ? -err : occ;
}

// cdc_matmul_rows: x [M, K] float32 @ w [K, N] float32 (contiguous) -> out
// [M, N] (out_bf16), with the plan (rb, async, bn, nrb, ksplit, kchunk,
// ks) from kernels/matmul.py: matmul_plan; ws [ksplit, M, N] float32 and
// sem [tiles * nrb] zeroed counters when ksplit > 1.
extern "C" int cdc_matmul_rows(const float* x, const float* w, void* out,
                               float* ws, int* sem, int M, int N, int K,
                               int out_bf16, int rb, int async, int bn,
                               int nrb, int ksplit, int kchunk, int ks,
                               void* stream) {
  using namespace cdc;
  const int pitch = stream::pitch_of<float>(bn) + (async ? 0 : 4);
  const int tiles = (N + bn - 1) / bn;
  const bool ok =
      M >= 1 && N >= 1 && K >= 1 && bn >= 1 && bn <= stream::bn_max(rb) &&
      pitch <= 256 &&
      ks >= 1 && ks <= 256 &&
      stream::box_elems<float>(ks, pitch) <= stream::STAGE_FLOATS &&
      kchunk >= 1 && kchunk <= stream::kmax(rb) &&
      (int64_t)ksplit * kchunk >= K && (int64_t)(ksplit - 1) * kchunk < K &&
      nrb * rb >= M &&
      (!async || (bn % 4 == 0 && N % 4 == 0 && (uintptr_t)w % 16 == 0));
  const long long grid = (long long)tiles * nrb * ksplit;
  if (!ok || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tm{};
  if (async) {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t str[1] = {(cuuint64_t)N * 4};
    const cuuint32_t box[2] = {(cuuint32_t)bn, (cuuint32_t)ks};
    if (!stream::encode_map(&tm, w, 2, dims, str, box))
      return (int)cudaErrorInvalidValue;
  }
  if (out_bf16) {
    const RowsArgs<__nv_bfloat16> a{x, w, static_cast<__nv_bfloat16*>(out),
                                    ws, sem, M, N, K, bn, nrb, ksplit,
                                    kchunk, ks};
    return pick_rows(rb, async, a, tm, (int)grid, st, nullptr);
  }
  const RowsArgs<float> a{x,  w,      static_cast<float*>(out), ws, sem, M,
                          N,  K,      bn,  nrb, ksplit, kchunk, ks};
  return pick_rows(rb, async, a, tm, (int)grid, st, nullptr);
}

// cdc_matmul_square: x [M, K] @ w [K, N], both contiguous of one storage
// type (in_bf16), out [M, N] (out_bf16). async (float32 in, K and N
// multiples of 4, 16-byte aligned bases) takes the bulk-copy producer.
extern "C" int cdc_matmul_square(const void* x, const void* w, void* out,
                                 int M, int N, int K, int in_bf16,
                                 int out_bf16, int async, void* stream) {
  using namespace cdc;
  if (M < 1 || N < 1 || K < 1 || (M + SQ_BM - 1) / SQ_BM > 65535 ||
      (async && (in_bf16 || K % 4 != 0 || N % 4 != 0 ||
                 ((uintptr_t)x | (uintptr_t)w) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tx{}, tw{};
  if (async) {
    const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t xs[1] = {(cuuint64_t)K * 4};
    const cuuint32_t xb[2] = {SQ_BK, SQ_BM};
    const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t wst[1] = {(cuuint64_t)N * 4};
    const cuuint32_t wb[2] = {SQ_BN, SQ_BK};
    if (!stream::encode_map(&tx, x, 2, xd, xs, xb, false,
                            CU_TENSOR_MAP_SWIZZLE_128B) ||
        !stream::encode_map(&tw, w, 2, wd, wst, wb))
      return (int)cudaErrorInvalidValue;
  }
  using bf = __nv_bfloat16;
  if (in_bf16)
    return out_bf16
               ? run_square<bf, bf, false>(x, w, out, M, N, K, tx, tw, s)
               : run_square<bf, float, false>(x, w, out, M, N, K, tx, tw, s);
  if (async)
    return out_bf16
               ? run_square<float, bf, true>(x, w, out, M, N, K, tx, tw, s)
               : run_square<float, float, true>(x, w, out, M, N, K, tx, tw,
                                                s);
  return out_bf16
             ? run_square<float, bf, false>(x, w, out, M, N, K, tx, tw, s)
             : run_square<float, float, false>(x, w, out, M, N, K, tx, tw,
                                               s);
}
