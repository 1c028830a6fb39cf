"""The FastGRNN cell kernels: the batched Q15 step and the fused FP32
window scan.  Plain versions (``qstep``), CUDA kernel wrappers
(``kernel``), entry points (``ops``) and oracles (``ref``)."""
from . import kernel, ops, qstep, ref  # noqa: F401
