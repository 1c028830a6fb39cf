"""Gradient compression for the all-reduce over slow axes, with error
feedback (reference ``repro.train.grad_compression``).

Two compressors, called on every rank of the mesh with the rank's own
gradient, over the ranks along ``axes``:

  * ``bf16`` (``bits=16``): cast, all-reduce, cast back (half the bytes,
    no state);
  * ``int8`` (``bits=8``): one scale a leaf, the max of |g| over the
    ranks (a tiny all-reduce), the quantised values summed as int32
    (exact), and ERROR FEEDBACK: the quantisation residual is carried into
    the next step's gradient, so the compression bias vanishes over time
    (EF-SGD, here EF-Adam).

The int8 path is bitwise the reference's under ``shard_map``; the bf16
path's sum runs in the collective's own order.
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh as M
from repro_torch.pytree import tree_leaves, tree_map


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def compressed_psum(g, axes, *, mesh, bits: int = 8, error=None):
    """All-reduce one gradient leaf in low precision over ``axes`` of
    ``mesh``.  Returns the MEAN over those ranks and this rank's new
    error-feedback residual."""
    gf = g.float()
    if error is not None:
        gf = gf + error
    n = M.axis_size(mesh, axes)
    with torch.no_grad():
        if bits == 16:
            red = M.psum(gf.to(torch.bfloat16), mesh, axes).float() / n
            return red, gf - _round_bf16(gf)   # the local rounding residual
        qmax = (1 << (bits - 1)) - 1
        # one scale over every rank: the MAX of the shards' maxima (a
        # mean of maxima would clip an outlier shard, and the error bound
        # would no longer hold)
        amax = M.pmax(gf.abs().max(), mesh, axes)
        scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
        q = torch.clamp(torch.round(gf / scale), -qmax - 1,
                        qmax).to(torch.int32)
        total = M.psum(q, mesh, axes)
        red = total.float() * scale / n
        # the residual rounded once, as the reference's fused multiply-
        # subtract rounds it: q * scale is exact in float64, and so is its
        # difference from gf
        err = (gf.double() - q.double() * scale.double()).float()
        return red, err


def compressed_psum_tree(grads, axes, *, mesh, bits: int = 8, error=None):
    """:func:`compressed_psum` over every leaf of a nested dict; ``error``
    a matching tree (``None``: zeros).  Returns (means, residuals)."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    out = iter([compressed_psum(g, axes, mesh=mesh, bits=bits, error=e)
                for g, e in zip(tree_leaves(grads), tree_leaves(error))])
    pairs = tree_map(lambda _: next(out), grads)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def compression_ratio(bits: int) -> float:
    return 32.0 / bits
