"""The quantized matmul (Q15/Q7 weights, bfloat16 products, float32
accumulation): CUDA kernel wrapper (``kernel``), entry points (``ops``)
and the float32 oracle (``ref``)."""
from . import kernel, ops, ref  # noqa: F401
