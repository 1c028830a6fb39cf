"""L-S-Q stage 3: per-tensor Q15/Q7 post-training quantization (paper
Sec. III-D, Appendix B).

Weight quantization (paper Eq. (8) + Appendix B):
    scale_l = max_ij |W_ij| / 32767            (Q15; 127 for Q7)
    Wq      = clip(round(W / scale_l), -2^15, 2^15 - 1)
    dequant = float(Wq) * scale_l

Every step runs in float32 on the tensor's device: ``amax / qmax`` and
``w / scale`` are float32 divisions by 0-dim tensors on that device (never
by a Python number or a CPU tensor, which PyTorch's CUDA division turns
into a multiply by the reciprocal), and ``torch.round`` rounds half to
even.  The integers and scales are therefore bitwise those of the
reference ``repro.core.quantization``, on the CPU and on the card.
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
    calibration_batches: int = 5        # paper Table X
    headroom: float = 0.10              # paper Table X: 10%
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
    f32 = dict(dtype=torch.float32, device=w.device)
    scale = torch.where(amax > 0, amax / torch.tensor(qmax, **f32),
                        torch.tensor(1.0 / qmax, **f32))
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    return q, scale


def dequantize_tensor(q: torch.Tensor, scale) -> torch.Tensor:
    """``float32(q) * scale``, the scale as a float32 tensor on q's device."""
    return q.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32,
                                                 device=q.device)


@dataclasses.dataclass
class QuantizedParams:
    """Q-weights + per-tensor scales + float passthrough leaves.

    ``q`` holds int16/int8 CPU tensors, ``scales`` Python floats (each the
    exact value of a float32 scale), ``fp`` float32 CPU tensors."""
    q: dict[str, torch.Tensor]
    scales: dict[str, float]
    fp: dict[str, torch.Tensor]
    bits: int = 16

    def dequantize(self) -> dict[str, torch.Tensor]:
        """Float parameters: each quantized tensor as ``float32(q) *
        scale`` (one float32 multiply, as the reference and
        ``qstep.StepWeights.w`` compute it), plus the float leaves."""
        out = {k: dequantize_tensor(v, self.scales[k])
               for k, v in self.q.items()}
        out.update(self.fp)
        return out

    def nbytes(self) -> int:
        itemsize = 2 if self.bits == 16 else 1
        return sum(v.numel() for v in self.q.values()) * itemsize

    def nonzero(self) -> int:
        return int(sum(int(torch.count_nonzero(v))
                       for d in (self.q, self.fp) for v in d.values()))

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


def quantize_params(params: dict[str, Any], cfg: QuantConfig,
                    device: str | torch.device = "cpu") -> QuantizedParams:
    """Per-tensor PTQ of a float parameter dict (torch or numpy leaves),
    computed on ``device``; the result holds CPU tensors, the same bits
    from either device."""
    q, scales, fp = {}, {}, {}
    for name, w in params.items():
        w = as_f32_cpu(w)
        if name in cfg.float_leaves or w.ndim == 0:
            fp[name] = w
        else:
            qi, s = quantize_tensor(w.to(device), cfg.qmax)
            q[name] = qi.to(cfg.dtype).cpu()
            scales[name] = float(s)
    return QuantizedParams(q=q, scales=scales, fp=fp, bits=cfg.bits)
