// Kernel 1 (coded_matmul.cuh) on float32 weights at T in {2, 4, 8}: the
// cases (T, R) = (2, 1-2), (4, 1-4), (8, 1-4).
#define CDC_CODED_CASES(X) \
  X(2, 1) X(2, 2) X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(8, 1) X(8, 2) X(8, 3) \
  X(8, 4)
#define CDC_CODED_TYPES(Y) Y(float)
#include "coded_matmul.cuh"
