"""L-S-Q stage 3: per-tensor Q15/Q7 post-training quantization (paper
Sec. III-D, Appendix B).

Weight quantization (paper Eq. (8) + Appendix B):
    scale_l = max_ij |W_ij| / 32767            (Q15; 127 for Q7)
    Wq      = clip(round(W / scale_l), -2^15, 2^15 - 1)
    dequant = float(Wq) * scale_l

Every step runs in float32 on CPU tensors: ``amax / qmax`` is a float32
division, ``torch.round`` rounds half to even, and ``w / scale`` divides
by a 0-dim tensor (never by a Python float, which PyTorch's CUDA division
turns into a multiply by the reciprocal).  The integers and scales are
therefore bitwise those of the reference ``repro.core.quantization``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

Q15_MAX = 32767


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 16                      # 16 -> Q15 (int16), 8 -> Q7 (int8)
    # Leaves kept in float (paper keeps biases in the FP32 accumulate path).
    float_leaves: tuple[str, ...] = ("b_z", "b_h", "zeta", "nu", "head_b")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def dtype(self) -> torch.dtype:
        return torch.int16 if self.bits == 16 else torch.int8


def quantize_tensor(w: torch.Tensor, qmax: int):
    """Per-tensor symmetric quantization of a float32 tensor.  Returns the
    rounded float32 integers and the 0-dim float32 scale."""
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = w.abs().max()
    scale = torch.where(amax > 0, amax / qmax,
                        torch.tensor(1.0 / qmax, dtype=torch.float32))
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    return q, scale


@dataclasses.dataclass
class QuantizedParams:
    """Q-weights + per-tensor scales + float passthrough leaves.

    ``q`` holds int16/int8 CPU tensors, ``scales`` Python floats (each the
    exact value of a float32 scale), ``fp`` float32 CPU tensors."""
    q: dict[str, torch.Tensor]
    scales: dict[str, float]
    fp: dict[str, torch.Tensor]
    bits: int = 16

    CANONICAL_ORDER = ("W", "U", "W1", "W2", "U1", "U2", "head_w")

    def tensor_order(self) -> tuple[str, ...]:
        """Deterministic packing order of the quantized tensors: canonical
        names first (cell factors, then head), then any extras sorted."""
        known = [n for n in self.CANONICAL_ORDER if n in self.q]
        extra = sorted(n for n in self.q if n not in self.CANONICAL_ORDER)
        return tuple(known + extra)


def as_f32_cpu(w) -> torch.Tensor:
    """A float32 CPU tensor owning its memory, from a torch tensor, a numpy
    array, a scalar or any array-like."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(w, np.float32))


def quantize_params(params: dict[str, Any], cfg: QuantConfig) -> QuantizedParams:
    """Per-tensor PTQ of a float parameter dict (torch or numpy leaves)."""
    q, scales, fp = {}, {}, {}
    for name, w in params.items():
        w = as_f32_cpu(w)
        if name in cfg.float_leaves or w.ndim == 0:
            fp[name] = w
        else:
            qi, s = quantize_tensor(w, cfg.qmax)
            q[name] = qi.to(cfg.dtype)
            scales[name] = float(s)
    return QuantizedParams(q=q, scales=scales, fp=fp, bits=cfg.bits)
