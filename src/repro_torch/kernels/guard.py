"""The gradient guard every kernel wrapper calls before it does anything
else.

The hand-written kernels have no backward (nor do the reference's Pallas
kernels), and a launch through ``ctypes`` gives an output with no
``grad_fn``: a gradient through it would be cut silently, leaving every
parameter before it with a zero gradient.  So a wrapper refuses, on any
device, an input that requires grad while grad mode is on; inference
runs under ``torch.no_grad()`` or on detached tensors, and training takes
the plain differentiable path (the LM's mamba scans train through
``models.mamba2.ssd_chunked``).
"""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` if grad mode is on and any of ``tensors``
    (``None`` entries skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the kernel has no "
            "backward; run it under torch.no_grad() or on detached "
            "tensors, or train through the plain differentiable path")
