"""Public LUT activations over tensors of any shape (paper Sec. III-E).

The tensor's device decides the path: a CPU tensor runs the plain
``core.lut.lut_eval``, a CUDA tensor launches the hand-written kernel
``csrc/lut_act.cu`` (:class:`~repro_torch.kernels.lut_act.kernel.LUTAct`).
There is no padding to (256, 128) tiles: that was the TPU's layout.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import INPUT_MAX, INPUT_MIN
from .kernel import LUTAct

_ACT = LUTAct()


def lut_act(x: torch.Tensor, fn: str = "tanh", *, mode: str = "nearest",
            lo: float = INPUT_MIN, hi: float = INPUT_MAX) -> torch.Tensor:
    """LUT activation of ``fn`` over ``x`` (float32 or bfloat16, any
    shape), in ``x``'s dtype.  Each table is generated and uploaded once
    per device."""
    return _ACT(x, fn, mode=mode, lo=lo, hi=hi)


def lut_sigmoid(x: torch.Tensor, **kw) -> torch.Tensor:
    return lut_act(x, "sigmoid", **kw)


def lut_tanh(x: torch.Tensor, **kw) -> torch.Tensor:
    return lut_act(x, "tanh", **kw)
