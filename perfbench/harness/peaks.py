"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): what a roofline share divides by."""

HBM_BYTES_PER_S = 3.35e12
# int32 operations outside the tensor cores: half the 67 TFLOP/s float32 rate
# (64 INT32 lanes per SM against 128 FP32)
INT32_OPS_PER_S = 33.5e12
