"""The batched Q15 FastGRNN step: plain version (``qstep``), CUDA kernel
wrapper (``kernel``), streaming entry point (``ops``) and scalar oracle
(``ref``)."""
from . import kernel, ops, qstep, ref  # noqa: F401
