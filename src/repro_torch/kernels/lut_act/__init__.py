"""The elementwise LUT activation: CUDA kernel wrapper (``kernel``) and
entry points (``ops``); the plain version is ``core.lut.lut_eval``."""
from . import kernel, ops  # noqa: F401
