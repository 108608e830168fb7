// Kernel 1 (coded_matmul.cuh) on bf16 weights, the generic instantiation:
// every code 2 <= T <= 16, 1 <= R <= T that the cases of
// cdc_coded_matmul_bf16.cu and cdc_coded_matmul_t16.cu do not cover.
#define CDC_CODED_CASES(X)
#define CDC_CODED_ANY
#define CDC_CODED_TYPES(Y) Y(__nv_bfloat16)
#include "coded_matmul.cuh"
