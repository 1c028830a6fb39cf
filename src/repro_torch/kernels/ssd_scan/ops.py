"""The SSD scan in the model's layout (reference
``repro.kernels.ssd_scan.ops``): broadcast the groups of B and C over
their heads, fold batch x heads into the kernel's per-head layout, scan,
and unfold.

The tensor's device decides the path: a CPU tensor runs the plain version,
a CUDA tensor launches the hand-written kernel ``csrc/ssd_scan.cu``
(:class:`~repro_torch.kernels.ssd_scan.kernel.SSDScan`), and a ``meta``
stand-in goes through the plain version's ops without values (a dry-run
counts their work).  S is not padded
to a multiple of the chunk: that was the TPU's block layout; the kernel
masks the ragged last chunk itself.
"""
from __future__ import annotations

import torch

from .kernel import SSDScan

_SCAN = SSDScan()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same signature and semantics as ``models.mamba2.ssd_chunked`` with
    no initial state.  x: (b, S, H, P); dt: (b, S, H); A: (H,); B, C:
    (b, S, G, N) -> (y (b, S, H, P) in x's dtype, state (b, H, N, P)
    float32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    xh = x.movedim(2, 1).reshape(b * h, s, p)
    dth = dt.float().movedim(2, 1).reshape(b * h, s, 1)
    Bh = B.repeat_interleave(rep, dim=2).movedim(2, 1).reshape(b * h, s, n)
    Ch = C.repeat_interleave(rep, dim=2).movedim(2, 1).reshape(b * h, s, n)
    ah = A.float().repeat(b).reshape(b * h, 1)
    y, state = _SCAN(xh, dth, ah, Bh, Ch, chunk=chunk)
    return y.reshape(b, h, s, p).movedim(1, 2), state.reshape(b, h, n, p)
