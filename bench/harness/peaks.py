"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity), at its full 700 W power limit: the two the
configurations here are held to (float32 with TF32 off)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores (TF32 off)
