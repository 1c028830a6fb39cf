"""The float32 oracle of the quantized matmul (reference
``repro.kernels.q15_matmul.ref``): dequantize, then matmul."""
from __future__ import annotations

import torch


def q15_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: (M, K) float; wq: (K, N) int8/int16; scale: scalar.  The
    per-tensor scale commutes with the contraction:
    ``x @ (wq * s) == s * (x @ wq_as_float)``."""
    w = wq.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32,
                                               device=wq.device)
    return (x.to(torch.float32) @ w).to(out_dtype)
