"""Per-tensor PTQ of an LM parameter tree for serving (reference
``repro.compress.tree``).

The same per-tensor symmetric recipe as the MCU path
(:func:`repro_torch.core.quantization.quantize_tensor`), applied to a
nested dict of tensors: every floating leaf with ``ndim >= 2`` is
quantized to int8 (Q7) or int16 (Q15) on the device it lies on; biases,
norms and scalars pass through in float.  A stacked ``(L, ...)`` leaf is
one tensor with one scale, as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import quantization as q
from repro_torch.pytree import tree_leaves, tree_map
from .passes import BITS_ALIASES


def _is_weight(leaf: torch.Tensor) -> bool:
    return leaf.ndim >= 2 and leaf.is_floating_point()


def _is_quantized(leaf: torch.Tensor) -> bool:
    return leaf.ndim >= 2 and not (leaf.is_floating_point()
                                   or leaf.is_complex()
                                   or leaf.dtype == torch.bool)


def quantize_tree(params, bits: int = 8):
    """Per-tensor symmetric PTQ of every >=2D floating leaf; the rest stay
    as they are.  ``bits`` accepts Q-format (7/15) or storage-width (8/16)
    names.  Returns ``(qtree, scales)``: ``qtree`` mirrors ``params`` with
    int8/int16 weight leaves, ``scales`` mirrors it with each weight's
    0-dim float32 scale (a 0-dim zero for the leaves left alone), on the
    leaf's device."""
    bits = BITS_ALIASES.get(bits, bits)
    if bits not in (8, 16):
        raise ValueError(f"bits must be Q7/int8 or Q15/int16: {bits}")
    qmax = (1 << (bits - 1)) - 1
    dtype = torch.int8 if bits == 8 else torch.int16

    def quant(leaf):
        if not _is_weight(leaf):
            return leaf, torch.zeros((), device=leaf.device)
        qi, s = q.quantize_tensor(leaf.float(), qmax)
        return qi.to(dtype), s

    pairs = tree_map(quant, params)
    return _split(pairs, 0), _split(pairs, 1)


def _split(pairs, i):
    if isinstance(pairs, dict):
        return {k: _split(v, i) for k, v in pairs.items()}
    return pairs[i]


def dequantize_tree(qtree, scales):
    """Inverse of :func:`quantize_tree` into bfloat16 (the serving compute
    dtype), multiplying in bfloat16 as the reference does: integer >=2D
    leaves become ``q.bf16 * scale.bf16``, everything else passes
    through."""
    def deq(ql, s):
        if _is_quantized(ql):
            return ql.to(torch.bfloat16) * s.to(torch.bfloat16)
        return ql
    return tree_map(deq, qtree, scales)


def tree_size_report(qtree, bits: int = 8) -> dict[str, Any]:
    """Weight-byte accounting of a quantized tree against its bf16
    baseline."""
    bits = BITS_ALIASES.get(bits, bits)
    itemsize = bits // 8
    n_q = n_fp = q_bytes = fp_bytes = 0
    for leaf in tree_leaves(qtree):
        if _is_quantized(leaf):
            n_q += leaf.numel()
            q_bytes += leaf.numel() * itemsize
        else:
            n_fp += leaf.numel()
            fp_bytes += leaf.numel() * 2          # bf16 passthrough
    dense = (n_q + n_fp) * 2
    return {
        "bits": bits,
        "quantized_params": n_q,
        "float_params": n_fp,
        "weight_bytes_quantized": q_bytes + fp_bytes,
        "weight_bytes_bf16": dense,
        "bytes_saved": dense - (q_bytes + fp_bytes),
        "compression_ratio": dense / max(q_bytes + fp_bytes, 1),
    }
