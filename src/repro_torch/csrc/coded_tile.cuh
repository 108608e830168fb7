// Device functions that the coded kernels share (float32, CUDA cores):
// the (value, id) argmax step and its warp reduction (kernel 2), the
// Eq. 12 select-decode of one column (kernels 1 and 3), and the
// cross-block completion counter (kernels 1, 2 and 7). The weights'
// mainloop of kernels 1, 2 and 7 is stream_tile.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar.cuh"

namespace cdc {

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

// Eq. 12 decode of one output column across the T shards, shared by the
// coded GEMM's epilogue and the decode-and-merge kernel: dead shards are
// zeroed by SELECT (a NaN in a dead shard cannot spread), and every dead
// shard takes (p_e - sum_t gen_e[t] * y[t]) * coef, where p_e is the
// column's selected parity equation e and gen_e its generator row. y[] of
// a dead shard is ignored: it may hold anything. The code width is TM, or
// n < TM in the generic instantiations (arrays MAX_T wide, the first n
// used; the unrolled loops stay in registers).
template <int TM>
__device__ __forceinline__ void eq12_decode(const float (&y)[TM], float p_e,
                                            const float* __restrict__ gen_e,
                                            float coef, unsigned valid_bits,
                                            float (&o)[TM], int n = TM) {
  float yz[TM];
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    if (t < n) {
      yz[t] = ((valid_bits >> t) & 1u) ? y[t] : 0.f;
      sum = fmaf(gen_e[t], yz[t], sum);
    }
  }
  const float miss = (p_e - sum) * coef;
#pragma unroll
  for (int t = 0; t < TM; ++t)
    if (t < n) o[t] = ((valid_bits >> t) & 1u) ? yz[t] : miss;
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
