"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit): the float32 rate outside the tensor cores,
which both the fused RHS (CUDA cores) and the policy's convolutions (TF32
off) run at, and the HBM3 bandwidth."""

PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
