"""LUT activations, Q15 quantization, the scalar C-equivalent runtime, the
FP32 FastGRNN cell, warm-up characterization and the MCU latency and
energy models."""
