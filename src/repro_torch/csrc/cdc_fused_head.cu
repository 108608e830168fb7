// Kernel 2 (fused_head.cuh) on float32 weights, T in {2, 4, 8, 16}.
#define CDC_HEAD_TS(X) X(2) X(4) X(8) X(16)
#define CDC_HEAD_TYPES(Y) Y(float)
#include "fused_head.cuh"
