// Kernel 2 (fused_head.cuh), the generic instantiation on float32 and bf16
// weights: every 2 <= T <= 16 outside {2, 4, 8, 16}.
#define CDC_HEAD_TS(X)
#define CDC_HEAD_ANY
#define CDC_HEAD_TYPES(Y) Y(float) Y(__nv_bfloat16)
#include "fused_head.cuh"
