"""LUT-based activations (paper Sec. III-E, Appendix C).

256-entry tables over [-8, +8], each entry sampled at the *center* of its
bucket (the (i + 0.5) offset).  Inputs outside the domain saturate.  The
tables are generated in float64 numpy and cast to float32, exactly as the
reference ``repro.core.lut.make_lut`` does, so they are bitwise equal to
the reference's tables.  Evaluation (nearest bucket, as the deployed C
engine does) lives with its callers: ``kernels/fastgrnn_cell/qstep.py``
(batched, torch) and ``core/qruntime.py`` (scalar, numpy).
"""
from __future__ import annotations

import numpy as np
import torch

LUT_SIZE = 256
INPUT_MIN = -8.0
INPUT_MAX = 8.0


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


_GENERATORS = {"sigmoid": _np_sigmoid, "tanh": np.tanh}


def make_lut(fn: str, size: int = LUT_SIZE, lo: float = INPUT_MIN,
             hi: float = INPUT_MAX) -> torch.Tensor:
    """Bucket-center table (Appendix C) as a (size,) float32 CPU tensor."""
    bw = (hi - lo) / size
    centers = lo + (np.arange(size) + 0.5) * bw
    return torch.from_numpy(_GENERATORS[fn](centers).astype(np.float32))
