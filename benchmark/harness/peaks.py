"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at the
700 W limit)."""

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12
