"""The quantized matmul over tensors with any leading dims, and the
serving entry point ``quantized_dense`` (reference
``repro.kernels.q15_matmul.ops``).

The tensor's device decides the path: a CPU tensor runs the plain version,
a CUDA tensor launches the hand-written kernel ``csrc/q15_matmul.cu``
(:class:`~repro_torch.kernels.q15_matmul.kernel.Q15Matmul`).  There is no
padding to 128-blocks: that was the TPU's layout; the kernel guards its
own tails.
"""
from __future__ import annotations

import torch

from .kernel import Q15Matmul

_MM = Q15Matmul()


def as_scale(scale, device) -> torch.Tensor:
    """``scale`` as a 0-dim float32 tensor on ``device``, rounded through
    float32 as the reference's ``jnp.asarray([scale], jnp.float32)``."""
    return torch.as_tensor(scale, dtype=torch.float32).reshape(()).to(device)


def q15_matmul(x: torch.Tensor, wq: torch.Tensor, scale, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: (..., K) float; wq: (K, N) int8/int16; scale: a number or a
    1-element tensor -> (..., N) in ``out_dtype``."""
    lead, k, n = x.shape[:-1], x.shape[-1], wq.shape[1]
    x2 = x.reshape(-1, k).to(torch.float32)
    out = _MM(x2, wq, as_scale(scale, x.device), out_dtype=out_dtype)
    return out.reshape(lead + (n,))


def quantized_dense(p_q, p_scale, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``layers.dense_apply`` with a quantized weight leaf:
    float32 output, plus the float bias where the layer has one."""
    y = q15_matmul(x, p_q["w"], p_scale["w"], out_dtype=torch.float32)
    if "b" in p_q:
        y = y + p_q["b"]
    return y
