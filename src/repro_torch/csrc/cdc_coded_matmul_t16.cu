// Kernel 1 (coded_matmul.cuh) at T = 16, R = 1-4, on float32 and bf16
// weights (20 streams at most: 21 warps a block, 4 or 8 rows a block).
#define CDC_CODED_CASES(X) X(16, 1) X(16, 2) X(16, 3) X(16, 4)
#define CDC_CODED_TYPES(Y) Y(float) Y(__nv_bfloat16)
#include "coded_matmul.cuh"
