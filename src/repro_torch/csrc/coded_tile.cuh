// Tile machinery of the fused coded head (kernel 2), and the Eq. 12
// decode and cross-block completion that kernels 1, 2, 3 and 7 share
// (float32, CUDA cores). Kernel 1 streams its weights through
// stream_tile.cuh instead.
//
// In kernel 2 a block owns BN = 32 output columns (one per lane) of EVERY
// shard of a coded GEMM -- the T weight shards and the parity shards --
// for RB = 8 rows. Its 8 warps split the contraction: warp g takes k indices
// g, g + 8, g + 16, ... of each chunk of KC staged activations, so each
// weight load is one 128-byte row segment per warp. The per-warp partial
// sums are then added in warp order in shared memory (deterministic), and
// the kernel's epilogue decodes from there: per-shard outputs never reach
// device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar.cuh"

namespace cdc {

constexpr int BN = 32;     // output columns per block, one per lane
constexpr int WARPS = 8;   // contraction groups per block, one per warp
constexpr int RB = 8;      // rows per block; warp w decodes row w
constexpr int KC = 256;    // activations staged per chunk of k

static_assert(RB == WARPS, "the epilogue maps one warp to one row");

// (value, id) argmax step: larger value wins, ties go to the smaller id.
__device__ __forceinline__ void argmax_merge(float& v, int& id, float ov,
                                             int oid) {
  if (ov > v || (ov == v && oid < id)) {
    v = ov;
    id = oid;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& id) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oid = __shfl_xor_sync(0xffffffffu, id, off);
    argmax_merge(v, id, ov, oid);
  }
}

// acc[rr][s] += x'[r0 + rr, kk] * W_s[kk, column] over kk in [kb0, kb1),
// where W_s[kk, column] = wp[s][kk * ld[s]] and x' = x, or the rmsnorm of
// x (x * inv[row] * gamma[kk]) when gamma is given.
template <int S>
__device__ inline void tile_mainloop(
    const float* __restrict__ x, int rows, int k, int r0, int kb0, int kb1,
    const float* const (&wp)[S], const int64_t (&ld)[S], bool col_ok,
    const float* inv, const float* __restrict__ gamma, float (&acc)[RB][S],
    float (*xs)[KC]) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * BN + lane;
  for (int c0 = kb0; c0 < kb1; c0 += KC) {
    const int kc = min(KC, kb1 - c0);
    for (int i = tid; i < RB * KC; i += BN * WARPS) {
      const int rr = i / KC, kk = i % KC;
      float v = 0.f;
      if (r0 + rr < rows && kk < kc) {
        v = x[(int64_t)(r0 + rr) * k + c0 + kk];
        if (gamma != nullptr) v = v * inv[rr] * gamma[c0 + kk];
      }
      xs[rr][kk] = v;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int kk = warp; kk < kc; kk += WARPS) {
        float wv[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          wv[s] = __ldg(wp[s] + (int64_t)(c0 + kk) * ld[s]);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const float xv = xs[rr][kk];
#pragma unroll
          for (int s = 0; s < S; ++s) acc[rr][s] = fmaf(xv, wv[s], acc[rr][s]);
        }
      }
    }
    __syncthreads();
  }
}

// tot[s][rr][lane] = sum over warps (in warp order) of acc[rr][s].
template <int S>
__device__ inline void reduce_warps(const float (&acc)[RB][S],
                                    float (*tot)[RB][BN]) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int rr = 0; rr < RB; ++rr)
          tot[s][rr][lane] = (w == 0 ? 0.f : tot[s][rr][lane]) + acc[rr][s];
    }
    __syncthreads();
  }
}

// Eq. 12 decode of one output column across the T shards, shared by the
// coded GEMM's epilogue and the decode-and-merge kernel: dead shards are
// zeroed by SELECT (a NaN in a dead shard cannot spread), and every dead
// shard takes (p_e - sum_t gen_e[t] * y[t]) * coef, where p_e is the
// column's selected parity equation e and gen_e its generator row. y[] of
// a dead shard is ignored: it may hold anything.
template <int T>
__device__ __forceinline__ void eq12_decode(const float (&y)[T], float p_e,
                                            const float* __restrict__ gen_e,
                                            float coef, unsigned valid_bits,
                                            float (&o)[T]) {
  float yz[T];
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    yz[t] = ((valid_bits >> t) & 1u) ? y[t] : 0.f;
    sum = fmaf(gen_e[t], yz[t], sum);
  }
  const float miss = (p_e - sum) * coef;
#pragma unroll
  for (int t = 0; t < T; ++t) o[t] = ((valid_bits >> t) & 1u) ? yz[t] : miss;
}

// Cross-block completion: every block calls this after writing its
// partial results; it returns true in exactly one block (the last to
// arrive at counter *sem), which then owns the final reduction and resets
// the counter to 0 for the next launch.
__device__ inline bool arrive_last(int* sem, int n_arrivals) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = (atomicAdd(sem, 1) == n_arrivals - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace cdc
