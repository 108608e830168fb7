// Weight-streaming mainloop shared by the coded GEMM (kernel 1), the fused
// head (kernel 2) and the few-rows path of the blocked GEMM (kernel 7):
// weights stored as float32 or bf16 (the storage type W), math in float32
// on CUDA cores.
//
// A block owns one column tile (at most 256 columns at RB = 4, 8 a lane;
// 128 otherwise, 4 a lane) of each of S weight streams, for RB in
// {4, 8, 16} rows and one range of k. Warp S is the producer: it keeps a
// ring of shared-memory stages full. Each stage holds a [ks, pitch] box of
// every stream (ks k rows, `pitch` >= the tile's width), each box 128-byte
// aligned. In the asynchronous instantiation each box is ONE TMA tensor
// copy (cp.async.bulk.tensor through a tensor map the C interface encodes
// per launch; rows past k arrive as zeros), all S completing on the
// stage's `full` mbarrier (one arrive.expect_tx per stage carries the byte
// count), so the copy engine handles kilobytes per request, not one row.
// Warp s < S consumes stream s: per k row one 16-byte shared load for each
// 4 of its float32 columns (bf16: one 16-byte load for 8 columns, or 8
// bytes for 4, widened to float32 in registers) and RB/4 16-byte loads of
// the staged activations (RB rows of one k, stored k-major, always
// float32), 4 * RB FMAs per 4 columns; then it releases the stage on its
// `empty` mbarrier (S arrivals). A stage holds 32 KB whatever W is: a bf16
// stage holds twice the k rows of a float32 one. Each warp owns the whole
// k range of its stream, so no sum crosses warps and the order of every
// sum is fixed.
//
// In the row-copy instantiation (shapes the copy engine's boxes cannot
// take whole: a slice, shard or parity row that is no whole number of
// 16-byte vectors, such as the 89-column folded slices of granite's w1 at
// T = 12, whose parity rows are 712 bytes apart) a box row holds its row
// from the 16-byte granule that holds the row's first element on, so the
// row's data starts `shift` elements into it (its source address mod 16,
// which may change from row to row), and box rows are one vector wider
// than the tile. A stream whose base and row stride are whole 16-byte
// units still comes as one TMA box a stage from the producer, started at
// that granule; the other streams' rows the consumer warps copy between
// them, a row a warp, granule by granule with 16-byte cp.async, three
// stages ahead, every thread's copies arriving on the stage's `full`
// barrier (cp.async.mbarrier.arrive.noinc), so no warp waits on its own
// copies and the copying is spread over every sub-partition. The consumers
// read each row at its shift with 4- or 2-byte shared loads, a lane on the
// columns lane, lane + 32, ... (conflict-free), and only the first 128
// columns of a lane's 256 where the tile is that narrow. The sums are the
// same FMAs in the same order as on the copy engine's path.
//
// What it buys on the H100: 32 KB stages, one to three in flight while
// one is consumed, 64-96 KB per SM against the ~32 KB that 3.35 TB/s needs
// at ~0.6 us of latency; the consumers never wait on a load of their own.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "scalar.cuh"

namespace cdc {
namespace stream {

constexpr int STAGE_FLOATS = 8192;               // 32 KB a stage
constexpr int STAGE_BYTES = STAGE_FLOATS * 4;

// Elements of storage type W in a stage, and in one 16-byte vector.
template <typename W>
__host__ __device__ constexpr int stage_elems() {
  return STAGE_BYTES / (int)sizeof(W);
}
template <typename W>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(W);
}

// The geometry of a block with RB rows. A 4-row block (a decode round)
// owns its SM: four stages (three in flight while one is consumed), 1024 k
// of staged activations, tiles of up to 256 columns (8 a lane). 8- and
// 16-row blocks, two to an SM, keep two stages and stage 8192 floats of
// activations (1024 or 512 k), 128 columns (4 a lane). (Measured on the
// H100, a 4-row block that owned its SM beat two that shared it.)
template <int RB>
struct Geo {
  static constexpr int NSTAGE = RB == 4 ? 4 : 2;
  static constexpr int RING = NSTAGE * STAGE_FLOATS;
  static constexpr int XS = RB == 4 ? 4096 : 8192;
  static constexpr int CPL = RB == 4 ? 8 : 4;     // columns a lane
  static constexpr int BN = 32 * CPL;             // widest column tile
  static constexpr int SMEM = (RING + XS + 16) * 4 + 2 * NSTAGE * 8;
};

// A block keeps its streams' float32 column sums ([S][RB][BN]) for its
// epilogue in the ring and the staging: with 16 rows that holds at most 12
// streams, with 8 rows 24 and with 4 rows 36, so wider codes take blocks
// of fewer rows.
__host__ __device__ constexpr bool rb_fits(int rb, int streams) {
  return rb == 4    ? streams * 4 * Geo<4>::BN <= Geo<4>::RING + Geo<4>::XS
         : rb == 8  ? streams * 8 * Geo<8>::BN <= Geo<8>::RING + Geo<8>::XS
         : rb == 16 ? streams * 16 * Geo<16>::BN <= Geo<16>::RING + Geo<16>::XS
                    : false;
}

// Deepest k range and widest tile of a block with rb rows.
__host__ __device__ constexpr int kmax(int rb) {
  return (rb == 4 ? Geo<4>::XS : Geo<8>::XS) / rb;
}
__host__ __device__ constexpr int bn_max(int rb) {
  return rb == 4 ? Geo<4>::BN : Geo<8>::BN;
}

// Elements of one stream's box in a stage: ks rows of `pitch`, rounded up
// to 128 bytes (the tensor copies' shared-memory alignment).
template <typename W>
__host__ __device__ constexpr int box_elems(int ks, int pitch) {
  return (ks * pitch + 128 / (int)sizeof(W) - 1) / (128 / (int)sizeof(W)) *
         (128 / (int)sizeof(W));
}

// A box row's elements: the tile width rounded up to whole 16-byte vectors
// (the tensor copies' inner extent, and the consumers' widest read).
template <typename W>
__host__ __device__ constexpr int pitch_of(int bn) {
  return (bn + vec_elems<W>() - 1) / vec_elems<W>() * vec_elems<W>();
}

// The first of the 4 columns j of a consumer lane's accumulators: float32
// lanes read 4 columns at lane * 4 + 128 j; bf16 lanes read their CPL
// columns as one run at lane * CPL.
template <int RB, typename W>
__device__ __forceinline__ int col4(int lane, int j) {
  return sizeof(W) == 4 ? lane * 4 + 128 * j : lane * Geo<RB>::CPL + 4 * j;
}

// A block's dynamic shared memory (Geo<RB>::SMEM bytes): the ring, the
// staged activations [kmax(RB)][RB], 16 row statistics and the 2 * NSTAGE
// barriers, in that order.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA tensor copy of a box at coordinates (c0, c1[, c2]) (innermost
// first) of the tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// bar.sync on a named barrier among the first n threads (n % 32 == 0).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Thread 0 initialises the ring's barriers (`fills` arrivals complete a
// `full` one, `consumers` an `empty` one); every thread then syncs.
template <int NS>
__device__ inline void ring_init(uint64_t* full, uint64_t* empty,
                                 unsigned consumers, unsigned fills = 1) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], fills);
      mbar_init(&empty[i], consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer warp, S <= 32 streams (a constant in the instantiations of
// one code, a runtime value in the generic one). Stream s's box of the
// stage at k row k0 lands at ring[stage][s * sreg] (elements of W):
// issue(s, k0, dst, bar) copies the whole [ks, pitch] box by one TMA
// tensor copy, lane s issuing stream s's copy, for every stream but u0 ..
// u0 + U - 1. Those (U = 0 on the copy engine's instantiation) the
// row-copy instantiation's consumers copy (consume_shifted): no tensor map
// takes their rows. There issue() starts each box at the 16-byte boundary
// at or before the tile, the only start the copy engine takes.
template <int NS, typename W, typename Issue>
__device__ inline void produce(int S, int u0, int U, const Issue& issue,
                               W* ring, uint64_t* full, uint64_t* empty,
                               int kb0, int kb1, int ks, int pitch,
                               int sreg) {
  const int lane = threadIdx.x & 31;
  const int nst = (kb1 - kb0 + ks - 1) / ks;
  const uint32_t bytes = (uint32_t)((S - U) * ks * pitch * (int)sizeof(W));
  for (int it = 0; it < nst; ++it) {
    const int st = it % NS, round = it / NS;
    if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
    if (lane == 0) mbar_arrive_tx(&full[st], bytes);
    __syncwarp();
    if (lane < S && (lane < u0 || lane >= u0 + U))
      issue(lane, kb0 + it * ks, ring + st * stage_elems<W>() + lane * sreg,
            &full[st]);
  }
}

// One 16-byte cp.async, global to shared (bypassing L1), and the arrival
// of this thread's cp.async copies on `bar` once they have landed (noinc:
// the arrival is one of the barrier's expected count).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One k row of a consumer lane's columns, widened to float32: float32
// lanes read 16 bytes for each 4 columns (128 apart), bf16 lanes their CPL
// columns in one 16-byte (CPL 8) or 8-byte (CPL 4) read. HALF: the row
// starts 8 bytes past a 16-byte boundary (a box that began at the
// boundary before its tile), so every 16-byte read is two 8-byte ones.
template <int CPL, bool HALF>
__device__ __forceinline__ void load_row(const float* p, float (&v)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL / 4; ++j) {
    if constexpr (HALF) {
      const float2 a = *reinterpret_cast<const float2*>(p + 128 * j);
      const float2 b = *reinterpret_cast<const float2*>(p + 128 * j + 2);
      v[4 * j] = a.x;
      v[4 * j + 1] = a.y;
      v[4 * j + 2] = b.x;
      v[4 * j + 3] = b.y;
    } else {
      const float4 q = *reinterpret_cast<const float4*>(p + 128 * j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  }
}
template <int CPL, bool HALF>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[CPL]) {
  static_assert(CPL == 4 || CPL == 8, "4 or 8 bf16 columns a lane");
  uint32_t u[CPL / 2];
  if constexpr (CPL == 8 && HALF) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const uint2 b = *reinterpret_cast<const uint2*>(p + 4);
    u[0] = a.x;
    u[1] = a.y;
    u[2] = b.x;
    u[3] = b.y;
  } else if constexpr (CPL == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    u[0] = q.x;
    u[1] = q.y;
    u[2] = q.z;
    u[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    u[0] = q.x;
    u[1] = q.y;
  }
#pragma unroll
  for (int i = 0; i < CPL / 2; ++i) {
    __nv_bfloat162 b2;
    memcpy(&b2, &u[i], 4);
    const float2 f = __bfloat1622float2(b2);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Consumer warp of stream s: acc[rr][q] += x[rr, kk] * W_s[kk, col(q)] over
// kk in [kb0, kb1), col(4 j + i) = col4<RB, W>(lane, j) + i, the tile's
// columns starting `shift` elements into each box row (a box that began
// at the 16-byte boundary before its tile; shift is 0 or half a 16-byte
// vector); xs holds the activations of that range k-major
// ([kk - kb0][RB]). Columns past the tile's width compute on whatever the
// box holds there (its padding, the next row) and are never written.
template <int RB, typename W, bool HALF>
__device__ __forceinline__ void fma_box(const W* wrow, const float* xr,
                                        int nrow, int pitch,
                                        float (&acc)[RB][Geo<RB>::CPL]) {
  static_assert(RB % 4 == 0, "activations are read 4 rows at a time");
  constexpr int CPL = Geo<RB>::CPL;
#pragma unroll 2
  for (int kk = 0; kk < nrow; ++kk) {
    float wv[CPL];
    load_row<CPL, HALF>(wrow + kk * pitch, wv);
#pragma unroll
    for (int g = 0; g < RB / 4; ++g) {
      const float4 x4 = *reinterpret_cast<const float4*>(xr + kk * RB + 4 * g);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          acc[4 * g + i][q] = fmaf(xv[i], wv[q], acc[4 * g + i][q]);
    }
  }
}

template <int RB, typename W, bool HALF>
__device__ inline void consume_rows(const W* ring, uint64_t* full,
                                    uint64_t* empty, const float* xs, int s,
                                    int kb0, int kb1, int ks, int pitch,
                                    int sreg,
                                    float (&acc)[RB][Geo<RB>::CPL],
                                    int shift) {
  constexpr int NS = Geo<RB>::NSTAGE;
  const int lane = threadIdx.x & 31;
  const int nst = (kb1 - kb0 + ks - 1) / ks;
  for (int it = 0; it < nst; ++it) {
    const int st = it % NS;
    const int k0 = kb0 + it * ks, nrow = min(ks, kb1 - k0);
    mbar_wait(&full[st], (it / NS) & 1);
    const W* wrow = ring + st * stage_elems<W>() + s * sreg + shift +
                    col4<RB, W>(lane, 0);
    fma_box<RB, W, HALF>(wrow, xs + (k0 - kb0) * RB, nrow, pitch, acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
  }
}

template <int RB, typename W>
__device__ inline void consume(const W* ring, uint64_t* full,
                               uint64_t* empty, const float* xs, int s,
                               int kb0, int kb1, int ks, int pitch,
                               int sreg, float (&acc)[RB][Geo<RB>::CPL],
                               int shift = 0) {
  if (shift % vec_elems<W>() != 0)
    consume_rows<RB, W, true>(ring, full, empty, xs, s, kb0, kb1, ks, pitch,
                              sreg, acc, shift);
  else
    consume_rows<RB, W, false>(ring, full, empty, xs, s, kb0, kb1, ks,
                               pitch, sreg, acc, shift);
}

// The generic code's consumer warp: it owns the streams s0, s0 + step, ...
// below S (at most NSPW of them), each with its own accumulators, and
// consumes them one after another from every stage before releasing it.
// shift(s) is stream s's `shift` (as in consume).
template <int RB, int NSPW, typename W, typename Shift>
__device__ inline void consume_multi(const W* ring, uint64_t* full,
                                     uint64_t* empty, const float* xs,
                                     int s0, int step, int S, int kb0,
                                     int kb1, int ks, int pitch, int sreg,
                                     float (&acc)[NSPW][RB][Geo<RB>::CPL],
                                     const Shift& shift) {
  constexpr int NS = Geo<RB>::NSTAGE;
  const int lane = threadIdx.x & 31;
  const int nst = (kb1 - kb0 + ks - 1) / ks;
  for (int it = 0; it < nst; ++it) {
    const int st = it % NS;
    const int k0 = kb0 + it * ks, nrow = min(ks, kb1 - k0);
    mbar_wait(&full[st], (it / NS) & 1);
    const float* xr = xs + (k0 - kb0) * RB;
#pragma unroll
    for (int i = 0; i < NSPW; ++i) {
      const int s = s0 + i * step;
      if (s >= S) break;
      const int sh = shift(s);
      const W* wrow = ring + st * stage_elems<W>() + s * sreg + sh +
                      col4<RB, W>(lane, 0);
      if (sh % vec_elems<W>() != 0)
        fma_box<RB, W, true>(wrow, xr, nrow, pitch, acc[i]);
      else
        fma_box<RB, W, false>(wrow, xr, nrow, pitch, acc[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

// One stored element read from shared memory, widened to float32 (bf16 is
// the high half of a float32: exact).
__device__ __forceinline__ float ld_shared(const float* p) { return *p; }
__device__ __forceinline__ float ld_shared(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// acc[rr][q] += x[rr, kk] * (row kk of box, at its shift)[lane + 32 q]
// for q < NQ, kk < nrow: row kk's shift is ((a0 + kk ldb) mod 16) /
// sizeof(W) elements (a0: row 0's address mod 16, ldb: the row stride in
// bytes mod 16), one 4- or 2-byte shared load a column.
template <int RB, int NQ, typename W>
__device__ __forceinline__ void fma_shifted(const W* box, const float* xr,
                                            int nrow, int pitch,
                                            uint32_t a0, uint32_t ldb,
                                            float (&acc)[RB][Geo<RB>::CPL]) {
  constexpr int LG = sizeof(W) == 4 ? 2 : 1;
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int kk = 0; kk < nrow; ++kk) {
    const int shift = (int)(((a0 + (uint32_t)kk * ldb) & 15u) >> LG);
    const W* p = box + kk * pitch + shift + lane;
    float wv[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) wv[q] = ld_shared(p + 32 * q);
#pragma unroll
    for (int g = 0; g < RB / 4; ++g) {
      const float4 x4 = *reinterpret_cast<const float4*>(xr + kk * RB + 4 * g);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[4 * g + i][q] = fmaf(xv[i], wv[q], acc[4 * g + i][q]);
    }
  }
}

// The consumers' copies of stage j (j < nst) into its slot, and their
// arrival on its `full` barrier: the rows of the streams u0 .. u0 + U - 1
// (no tensor map takes them), row i (stream major) by consumer warp i mod
// ncw; each row src(s, kk) with the 16-byte granules that hold its `bytes`
// (granules lie in the rows' own 16-byte units, so no copy leaves the
// memory the rows live in), lane l the granules l, l + 32, ..., into box
// row kk - k0 (`pitch` elements apart). Before a slot's second and later
// stages every consumer has released it (`empty`).
template <int NS, typename W, typename Src>
__device__ __forceinline__ void fill_rows(W* ring, uint64_t* full,
                                          uint64_t* empty, const Src& src,
                                          int j, int cw, int ncw, int u0,
                                          int U, int kb0, int kb1, int ks,
                                          int pitch, int sreg, int bytes) {
  const int lane = threadIdx.x & 31, st = j % NS;
  const int k0 = kb0 + j * ks, nrow = min(ks, kb1 - k0);
  if (j >= NS) mbar_wait(&empty[st], (j / NS - 1) & 1);
  W* stage = ring + st * stage_elems<W>();
  for (int i = cw; i < U * nrow; i += ncw) {
    const int u = i / nrow, kk = i - u * nrow;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src(u0 + u, k0 + kk));
    const uintptr_t lo = a & ~(uintptr_t)15;
    const int n = (int)(((a + bytes + 15) & ~(uintptr_t)15) - lo);
    const char* g = reinterpret_cast<const char*>(lo);
    char* d = reinterpret_cast<char*>(stage + (u0 + u) * sreg + kk * pitch);
    for (int o = lane * 16; o < n; o += 32 * 16) cp_async16(d + o, g + o);
  }
  cp_async_arrive(&full[st]);
}

// The row-copy instantiation's consumer warp cw (of ncw) of the streams
// s0, s0 + step, ... below S (at most NSPW of them, each with its own
// accumulators). acc[i][rr][q] += x[rr, kk] * W_s[kk, lane + 32 q]: box
// row kk of stream s holds row kk from the 16-byte granule of its first
// element on (src(s, kk): the row's first element), so the row starts at
// shift = (src(s, kk) mod 16) / sizeof(W) elements, read with one 4- or
// 2-byte shared load a column (32 lanes on 32 neighbouring columns);
// columns past 128 are read and summed only where the tile is wider. The
// streams with a tensor map arrive by the producer's boxes; the rows of
// the streams u0 .. u0 + U - 1 the consumers copy between them
// (fill_rows), NS - 1 stages ahead, every thread's copies arriving on the
// stage's `full` barrier (the producer's arrival and 32 ncw more).
template <int RB, int NSPW, typename W, typename Src>
__device__ __forceinline__ void consume_shifted(
    W* ring, uint64_t* full, uint64_t* empty, const float* xs, int s0,
    int step, int S, int kb0, int kb1, int ks, int pitch, int sreg,
    int width, int u0, int U, int cw, int ncw, const Src& src,
    float (&acc)[NSPW][RB][Geo<RB>::CPL]) {
  constexpr int NS = Geo<RB>::NSTAGE, CPL = Geo<RB>::CPL;
  const int lane = threadIdx.x & 31;
  const int nst = (kb1 - kb0 + ks - 1) / ks;
  const int bytes = width * (int)sizeof(W);
  // each own stream's first row and row stride, mod 16 bytes
  uint32_t a0[NSPW], lb[NSPW];
#pragma unroll
  for (int i = 0; i < NSPW; ++i) {
    const int s = min(s0 + i * step, S - 1);
    const char* r0 = reinterpret_cast<const char*>(src(s, kb0));
    a0[i] = (uint32_t)reinterpret_cast<uintptr_t>(r0) & 15u;
    lb[i] = (uint32_t)(reinterpret_cast<const char*>(src(s, kb0 + 1)) - r0)
            & 15u;
  }
  for (int j = 0; j < NS - 1 && j < nst; ++j)
    fill_rows<NS>(ring, full, empty, src, j, cw, ncw, u0, U, kb0, kb1, ks,
                  pitch, sreg, bytes);
  for (int it = 0; it < nst; ++it) {
    const int st = it % NS;
    const int k0 = kb0 + it * ks, nrow = min(ks, kb1 - k0);
    // stage it + NS - 1 goes into the slot of stage it - 1 once every
    // consumer has released it
    if (it + NS - 1 < nst)
      fill_rows<NS>(ring, full, empty, src, it + NS - 1, cw, ncw, u0, U,
                    kb0, kb1, ks, pitch, sreg, bytes);
    mbar_wait(&full[st], (it / NS) & 1);
    const float* xr = xs + (k0 - kb0) * RB;
#pragma unroll
    for (int i = 0; i < NSPW; ++i) {
      const int s = s0 + i * step;
      if (s >= S) break;
      const W* box = ring + st * stage_elems<W>() + s * sreg;
      const uint32_t a = (a0[i] + (uint32_t)(k0 - kb0) * lb[i]) & 15u;
      if (CPL > 4 && width > 128)
        fma_shifted<RB, CPL, W>(box, xr, nrow, pitch, a, lb[i], acc[i]);
      else
        fma_shifted<RB, 4, W>(box, xr, nrow, pitch, a, lb[i], acc[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

// The column of acc[.][q] of a consumer lane: col4's runs on the copy
// engine's instantiation (ROWS false), lane + 32 q on the row-copy one.
template <int RB, typename W, bool ROWS>
__device__ __forceinline__ int acc_col(int lane, int q) {
  return ROWS ? lane + 32 * q : col4<RB, W>(lane, q / 4) + q % 4;
}

// The consumers write their accumulators to tot[(s * RB + rr) * BN + col]
// (float32; BN = Geo<RB>::BN), every column of the lane: in 16-byte stores
// of col4's runs, or (ROWS) one store a column.
template <int RB, typename W, bool ROWS = false>
__device__ inline void store_acc(float* tot, int s,
                                 const float (&acc)[RB][Geo<RB>::CPL]) {
  constexpr int BNS = Geo<RB>::BN, CPL = Geo<RB>::CPL;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < RB; ++rr) {
    if constexpr (ROWS) {
#pragma unroll
      for (int q = 0; q < CPL; ++q)
        tot[(s * RB + rr) * BNS + lane + 32 * q] = acc[rr][q];
    } else {
#pragma unroll
      for (int j = 0; j < CPL / 4; ++j)
        *reinterpret_cast<float4*>(tot + (s * RB + rr) * BNS +
                                   col4<RB, W>(lane, j)) =
            make_float4(acc[rr][4 * j], acc[rr][4 * j + 1],
                        acc[rr][4 * j + 2], acc[rr][4 * j + 3]);
    }
  }
}

// The consumers (threads [0, n)) stage x[r0 + rr, kb0 + kk] for kk in
// [0, kb1 - kb0) as xs[kk][rr] in float32 (x is stored as float32 or bf16),
// zero past the rows, and, when gamma is given, as the rmsnorm x * inv[rr]
// * gamma[k] (inv computed here over all of k, one warp per row). Ends on
// named barrier 1 among the n threads.
template <int RB, typename X>
__device__ inline void stage_x(const X* __restrict__ x, int rows, int k,
                               int r0, int kb0, int kb1,
                               const float* __restrict__ gamma, float eps,
                               float* xs, float* inv, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (gamma != nullptr) {
    for (int rr = warp; rr < RB; rr += n / 32) {
      float ss = 0.f;
      if (r0 + rr < rows) {
        const X* xr = x + (int64_t)(r0 + rr) * k;
        for (int kk = lane; kk < k; kk += 32) {
          const float v = ld(xr + kk);
          ss = fmaf(v, v, ss);
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) inv[rr] = rsqrtf(ss / (float)k + eps);
    }
    bar_sync(1, n);
  }
  const int kc = kb1 - kb0;
  for (int i = tid; i < RB * kc; i += n) {
    const int rr = i / kc, kk = i - rr * kc;
    float v = 0.f;
    if (r0 + rr < rows) {
      v = ld(x + (int64_t)(r0 + rr) * k + kb0 + kk);
      if (gamma != nullptr) v = v * inv[rr] * __ldg(gamma + kb0 + kk);
    }
    xs[kk * RB + rr] = v;
  }
  bar_sync(1, n);
}

// The last block of a tile adds the split partials part[sp][off + j] of the
// n = rows_here x width outputs at offsets off(i) in split order (sp = 0,
// 1, ...), so every launch gives the same bits. On the copy engine's path
// (VEC) widths and offsets are multiples of 4 and it reads 16 bytes a
// load; the split loop is unrolled so that its loads are in flight
// together, and only the adds wait on each other.
template <bool VEC, typename Off, typename Store>
__device__ inline void add_splits(const float* part, int64_t plane,
                                  int nsplit, int items, int width,
                                  const Off& off, const Store& store,
                                  int nthreads) {
  constexpr int V = VEC ? 4 : 1;
  const int wv = width / V;
  for (int i = threadIdx.x; i < items * wv; i += nthreads) {
    const int it = i / wv, cv = i - it * wv;
    const int64_t o = off(it);
    if (o < 0) continue;
    const float* p = part + o + cv * V;
    if (VEC) {
      float4 s = __ldcg(reinterpret_cast<const float4*>(p));
#pragma unroll 8
      for (int sp = 1; sp < nsplit; ++sp) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(p + sp * plane));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      store(o + cv * V, s.x);
      store(o + cv * V + 1, s.y);
      store(o + cv * V + 2, s.z);
      store(o + cv * V + 3, s.w);
    } else {
      float s = __ldcg(p);
#pragma unroll 8
      for (int sp = 1; sp < nsplit; ++sp) s += __ldcg(p + sp * plane);
      store(o + cv, s);
    }
  }
}

// ---------------------------------------------------------- host side --

// cuTensorMapEncodeTiled, fetched from the driver at run time (nothing
// links libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A float32 (or, with bf16, bfloat16) tensor map of `rank` <= 3 dims
// (dims[0] innermost; strides in bytes of dims 1..rank-1) read in boxes of
// `box`; out-of-bounds elements read as zero. Returns false if the driver
// refuses it. A map is a pure function of these arguments, so the last 64
// are kept, keyed by them: the serving round's weights keep their
// addresses, and a hit costs no call into the driver.
static inline bool encode_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box, bool bf16 = false,
                              CUtensorMapSwizzle swizzle =
                                  CU_TENSOR_MAP_SWIZZLE_NONE) {
  struct Key {
    const void* base;
    cuuint64_t dims[3], strides[2];
    cuuint32_t box[3];
    int rank, swizzle, bf16;
  };
  struct Entry {
    Key key;
    CUtensorMap map;
    bool used;
  };
  static Entry cache[64];
  static std::mutex lock;
  Key key;
  memset(&key, 0, sizeof key);
  key.base = base;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  key.bf16 = (int)bf16;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  uint64_t h = 1469598103934665603ull;   // FNV-1a over the key's bytes
  for (size_t i = 0; i < sizeof key; ++i)
    h = (h ^ reinterpret_cast<const unsigned char*>(&key)[i]) *
        1099511628211ull;
  Entry& e = cache[h % 64];
  std::lock_guard<std::mutex> guard(lock);
  if (e.used && memcmp(&e.key, &key, sizeof key) == 0) {
    *map = e.map;
    return true;
  }
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  if (fn == nullptr ||
      fn(map,
         bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         (cuuint32_t)rank,
         const_cast<void*>(base), dims, strides, box, one,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  e.key = key;
  e.map = *map;
  e.used = true;
  return true;
}

}  // namespace stream
}  // namespace cdc
