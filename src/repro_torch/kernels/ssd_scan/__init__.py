"""The Mamba-2 chunked SSD scan: CUDA kernel wrapper and plain version
(``kernel``), the model-layout entry point (``ops``) and the oracle
(``ref``)."""
from . import kernel, ops, ref  # noqa: F401
