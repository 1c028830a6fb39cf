"""LUT activations, Q15 quantization and the scalar C-equivalent runtime."""
