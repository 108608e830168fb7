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
//  * the head shards are read in place from lm_head.w (shard t at column
//    offset t * m_l), so nothing is copied per round;
//  * the TPU kernel walks the vocabulary tiles in order and carries the
//    running (max, argmax) across grid steps; here the tiles are parallel
//    blocks, each writes its (max, id) per row, and the last block to
//    finish reduces those partials in tile order with the same tie rule --
//    one launch, deterministic;
//  * m_l = 12292 is not a multiple of the 32-column tile: the last tile is
//    masked instead of shrinking the tile as the Pallas wrapper does.
#include "coded_tile.cuh"

namespace cdc {

constexpr float NEG_INF_LOGIT = -1e30f;

template <int T>
__global__ void __launch_bounds__(BN * WARPS)
fused_head_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ pw, float* __restrict__ part_val,
                  int* __restrict__ part_idx, int* __restrict__ sem,
                  int* __restrict__ tok, float* __restrict__ vmax, int b,
                  int k, int m_l, int64_t shard_stride, int64_t ldw,
                  int vocab, unsigned valid_bits) {
  constexpr int S = T + 1;
  __shared__ float xs[RB][KC];
  __shared__ float tot[S][RB][BN];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.x * BN + lane;
  const bool col_ok = c < m_l;
  const int cc = col_ok ? c : 0;
  const int r0 = blockIdx.y * RB;

  const float* wp[S];
  int64_t ld[S];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    wp[t] = w + (int64_t)t * shard_stride + cc;
    ld[t] = ldw;
  }
  wp[T] = pw + cc;
  ld[T] = m_l;

  float acc[RB][S];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int s = 0; s < S; ++s) acc[rr][s] = 0.f;
  tile_mainloop<S>(x, b, k, r0, 0, k, wp, ld, col_ok, nullptr, nullptr, acc,
                   xs);
  reduce_warps<S>(acc, tot);

  // epilogue: warp rr owns row r0 + rr; each lane decodes its column of
  // every shard, then the warp reduces (max, id) over the tile
  const int rr = warp, row = r0 + rr;
  float best = -INFINITY;
  int bid = 0x7fffffff;
  if (col_ok && row < b) {
    float yz[T];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float vm = ((valid_bits >> t) & 1u) ? 1.f : 0.f;
      yz[t] = tot[t][rr][lane] * vm;
      sum += yz[t];
    }
    const float miss = tot[T][rr][lane] - sum;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float vm = ((valid_bits >> t) & 1u) ? 1.f : 0.f;
      const int gid = t * m_l + c;
      const float logit = gid < vocab ? yz[t] + (1.f - vm) * miss
                                      : NEG_INF_LOGIT;
      argmax_merge(best, bid, logit, gid);
    }
  }
  warp_argmax(best, bid);
  if (lane == 0 && row < b) {
    part_val[(int64_t)blockIdx.x * b + row] = best;
    part_idx[(int64_t)blockIdx.x * b + row] = bid;
  }

  int* row_sem = sem + blockIdx.y;
  if (!arrive_last(row_sem, gridDim.x)) return;
  best = -INFINITY;
  bid = 0x7fffffff;
  if (row < b) {
    for (int i = lane; i < (int)gridDim.x; i += 32)
      argmax_merge(best, bid, __ldcg(part_val + (int64_t)i * b + row),
                   __ldcg(part_idx + (int64_t)i * b + row));
  }
  warp_argmax(best, bid);
  if (lane == 0 && row < b) {
    tok[row] = bid;
    vmax[row] = best;
  }
  if (threadIdx.x == 0 && threadIdx.y == 0) *row_sem = 0;
}

}  // namespace cdc

// C interface (loaded with ctypes). Returns the cudaError_t of the launch.
extern "C" int cdc_fused_head_argmax_f32(
    const float* x, const float* w, const float* pw, float* part_val,
    int* part_idx, int* sem, int* tok, float* vmax, int b, int k, int T,
    int m_l, long long shard_stride, long long ldw, int vocab,
    unsigned valid_bits, void* stream) {
  using namespace cdc;
  const dim3 grid((m_l + BN - 1) / BN, (b + RB - 1) / RB);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 2:
      fused_head_kernel<2><<<grid, dim3(BN, WARPS), 0, st>>>(
          x, w, pw, part_val, part_idx, sem, tok, vmax, b, k, m_l,
          shard_stride, ldw, vocab, valid_bits);
      break;
    case 4:
      fused_head_kernel<4><<<grid, dim3(BN, WARPS), 0, st>>>(
          x, w, pw, part_val, part_idx, sem, tok, vmax, b, k, m_l,
          shard_stride, ldw, vocab, valid_bits);
      break;
    case 8:
      fused_head_kernel<8><<<grid, dim3(BN, WARPS), 0, st>>>(
          x, w, pw, part_val, part_idx, sem, tok, vmax, b, k, m_l,
          shard_stride, ldw, vocab, valid_bits);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
