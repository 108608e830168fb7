// Fused coded matmul + Eq. 12 decode + merge, float32, sm_90a.
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
// 4096 x 3200 float32 = 315 MB, ~94 us at 3.35 TB/s).
// What the design does about it:
//  * the weights are read in place: shard t is w at column offset t*m_l,
//    and the parity is read in its folded slot layout through the
//    folded_slot_map index arithmetic, so no per-call copy of any weight;
//  * the Pallas tile keeps all of k resident (~3.3 MB); here the block
//    streams k in chunks and keeps the T + r accumulators in registers;
//  * with few rows the parallelism comes from column tiles, and for the
//    narrow GEMMs (wk/wv, m_l = 256) from splitting k across blocks: each
//    split decodes its own partial sums (the decode is linear, and a dead
//    shard is removed by select, so partials decode exactly) into a
//    workspace, and the last block to finish a tile adds the splits in
//    split order -- one launch, deterministic, no zero-initialised output.
// Simple by intent: FMA on CUDA cores, no TMA or wgmma yet.
#include "coded_tile.cuh"

namespace cdc {

template <int T, int R>
__global__ void __launch_bounds__(BN * WARPS)
coded_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ pw,
                    const float* __restrict__ gen,
                    const int* __restrict__ esel,
                    const float* __restrict__ coef,
                    const float* __restrict__ gamma, float eps,
                    float* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ sem, int rows, int k, int m_l,
                    int64_t ldw, int folded, unsigned valid_bits,
                    int kchunk) {
  constexpr int S = T + R;
  __shared__ float xs[RB][KC];
  __shared__ float tot[S][RB][BN];
  __shared__ float inv[RB];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.x * BN + lane;  // shard-local output column
  const bool col_ok = c < m_l;
  const int cc = col_ok ? c : 0;
  const int r0 = blockIdx.y * RB;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int kb0 = split * kchunk, kb1 = min(k, kb0 + kchunk);

  if (gamma != nullptr) row_rms(x, rows, k, r0, eps, inv);
  __syncthreads();

  const float* wp[S];
  int64_t ld[S];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    wp[t] = w + (int64_t)t * m_l + cc;
    ld[t] = ldw;
  }
  if (folded) {
    // parity j, column c lives in slice s = c / wd of slot (s + j + 1) % T,
    // at column j * wd + c % wd of that slot's [k, R * wd] block
    const int wd = m_l / T, s = cc / wd, o = cc % wd;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int slot = (s + j + 1) % T;
      wp[T + j] = pw + (int64_t)slot * k * (R * wd) + j * wd + o;
      ld[T + j] = R * wd;
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      wp[T + j] = pw + (int64_t)j * k * m_l + cc;
      ld[T + j] = m_l;
    }
  }

  float acc[RB][S];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int s = 0; s < S; ++s) acc[rr][s] = 0.f;
  tile_mainloop<S>(x, rows, k, r0, kb0, kb1, wp, ld, col_ok, inv, gamma, acc,
                   xs);
  reduce_warps<S>(acc, tot);

  // epilogue: warp rr decodes row r0 + rr, lane decodes column c
  const int rr = warp, row = r0 + rr;
  const bool live = col_ok && row < rows;
  float o[T];
  if (live) {
    float y[T];
    const int e = esel[c];
#pragma unroll
    for (int t = 0; t < T; ++t) y[t] = tot[t][rr][lane];
    eq12_decode<T>(y, tot[T + e][rr][lane], gen + e * T, coef[c], valid_bits,
                   o);
  }
  const int64_t m = (int64_t)T * m_l;
  if (nsplit == 1) {
    if (live)
#pragma unroll
      for (int t = 0; t < T; ++t) out[(int64_t)row * m + t * m_l + c] = o[t];
    return;
  }
  if (live)
#pragma unroll
    for (int t = 0; t < T; ++t)
      ws[((int64_t)split * rows + row) * m + t * m_l + c] = o[t];
  int* tile_sem = sem + blockIdx.y * gridDim.x + blockIdx.x;
  if (!arrive_last(tile_sem, nsplit)) return;
  if (live) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float acc_t = 0.f;
      for (int sp = 0; sp < nsplit; ++sp)
        acc_t += __ldcg(ws + ((int64_t)sp * rows + row) * m + t * m_l + c);
      out[(int64_t)row * m + t * m_l + c] = acc_t;
    }
  }
  if (threadIdx.x == 0 && threadIdx.y == 0) *tile_sem = 0;
}

template <int T, int R>
static void launch(dim3 grid, cudaStream_t st, const float* x, const float* w,
                   const float* pw, const float* gen, const int* esel,
                   const float* coef, const float* gamma, float eps,
                   float* out, float* ws, int* sem, int rows, int k, int m_l,
                   int64_t ldw, int folded, unsigned valid_bits, int kchunk) {
  coded_matmul_kernel<T, R><<<grid, dim3(BN, WARPS), 0, st>>>(
      x, w, pw, gen, esel, coef, gamma, eps, out, ws, sem, rows, k, m_l, ldw,
      folded, valid_bits, kchunk);
}

}  // namespace cdc

// C interface (loaded with ctypes). Returns the cudaError_t of the launch.
// Cases (T, R): (2, 1-2), (4, 1-4), (8, 1-4); anything else returns
// cudaErrorInvalidValue. The case key T * 16 + R is unique because R < 16.
extern "C" int cdc_coded_matmul_f32(
    const float* x, const float* w, const float* pw, const float* gen,
    const int* esel, const float* coef, const float* gamma, float eps,
    float* out, float* ws, int* sem, int rows, int k, int T, int R, int m_l,
    long long ldw, int folded, unsigned valid_bits, int ksplit, int kchunk,
    void* stream) {
  using namespace cdc;
  const dim3 grid((m_l + BN - 1) / BN, (rows + RB - 1) / RB, ksplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CDC_CASE(TT, RR)                                                     \
  case TT * 16 + RR:                                                         \
    launch<TT, RR>(grid, st, x, w, pw, gen, esel, coef, gamma, eps, out, ws, \
                   sem, rows, k, m_l, ldw, folded, valid_bits, kchunk);      \
    break;
  switch (T * 16 + R) {
    CDC_CASE(2, 1)
    CDC_CASE(2, 2)
    CDC_CASE(4, 1)
    CDC_CASE(4, 2)
    CDC_CASE(4, 3)
    CDC_CASE(4, 4)
    CDC_CASE(8, 1)
    CDC_CASE(8, 2)
    CDC_CASE(8, 3)
    CDC_CASE(8, 4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CDC_CASE
  return (int)cudaGetLastError();
}
