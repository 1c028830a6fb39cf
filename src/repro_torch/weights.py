"""Carry model weights across from the reference JAX package.

The reference's parameters reach the port as numpy arrays (``np.asarray``
of each leaf), never as JAX objects: this module imports neither package.
A float parameter dict (``W1, W2, U1, U2`` or ``W, U``, plus ``b_z, b_h,
zeta, nu, head_w, head_b``) becomes float32 CPU tensors; quantized
parameters ``(q, scales, fp, bits)`` become a port
:class:`~repro_torch.core.quantization.QuantizedParams`.  ``.fgar`` bytes
written by the reference load directly through
:meth:`repro_torch.compress.ModelArtifact.from_bytes`.  An LM parameter
tree (nested dicts of numpy arrays, bfloat16 leaves included) becomes the
port's nested dict of tensors through :func:`lm_params_from_numpy`.

:func:`random_params` draws seeded float parameters at the paper's
``fastgrnn_har`` width (H=16, d=3, 6 classes, r_w=2, r_u=8) with the
reference initializer's shapes and scales, from numpy.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedParams, as_f32_cpu
from repro_torch.device import resolve_device


def params_from_numpy(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Float parameter dict (numpy or array-like leaves) -> float32 CPU
    tensors, bit for bit."""
    return {k: as_f32_cpu(v) for k, v in params.items()}


def lm_params_from_numpy(tree, device: str | torch.device = "cuda"):
    """The reference's LM parameter pytree, with ``np.asarray`` applied to
    each leaf, as the port's nested dict of tensors on ``device`` (the
    card unless the caller asks for the CPU), bit for bit: stacked
    ``blocks`` keep their leading L axis, float32 leaves carry across as
    they are, and bfloat16 leaves (``ml_dtypes`` arrays, told by their
    dtype's name) through their 16-bit patterns."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def quantized_from_numpy(q: Mapping[str, Any], scales: Mapping[str, Any],
                         fp: Mapping[str, Any], bits: int = 16
                         ) -> QuantizedParams:
    """Quantized parameters (int arrays, float32 scales, float leaves) ->
    the port's :class:`QuantizedParams`, bit for bit."""
    dtype = np.int16 if bits == 16 else np.int8
    return QuantizedParams(
        q={k: torch.from_numpy(np.array(v, dtype)) for k, v in q.items()},
        scales={k: float(np.float32(v)) for k, v in scales.items()},
        fp={k: as_f32_cpu(v) for k, v in fp.items()},
        bits=int(bits))


def random_params(seed: int, *, low_rank: bool = True, input_dim: int = 3,
                  hidden_dim: int = 16, num_classes: int = 6,
                  rank_w: int = 2, rank_u: int = 8) -> dict[str, np.ndarray]:
    """Seeded float parameters with the reference ``init_params`` layout:
    N(0, 0.1) factor/head matrices, ``b_z = 1``, ``b_h = 0``, raw
    ``zeta = 1``, ``nu = -4``, ``head_b = 0`` (numpy float32 leaves)."""
    rng = np.random.default_rng(seed)
    d, H, C = input_dim, hidden_dim, num_classes
    mat = lambda *shape: (0.1 * rng.standard_normal(shape)).astype(np.float32)
    p: dict[str, np.ndarray] = {}
    if low_rank:
        p.update(W1=mat(H, rank_w), W2=mat(d, rank_w),
                 U1=mat(H, rank_u), U2=mat(H, rank_u))
    else:
        p.update(W=mat(H, d), U=mat(H, H))
    p.update(b_z=np.ones(H, np.float32), b_h=np.zeros(H, np.float32),
             zeta=np.float32(1.0), nu=np.float32(-4.0),
             head_w=mat(H, C), head_b=np.zeros(C, np.float32))
    return p
