"""The LM's cross-entropy over the unembedding (reference
``repro.models.losses``).

``vocab_parallel_ce`` takes the final hidden states and the unembedding
weight and returns the mean loss.  Without a mesh it is the plain path:
the head's logits in float32, then ``layers.cross_entropy``, as the
reference falls back to when there is no mesh or the vocab does not
divide the model axis.  The vocab-sharded path over a process group is
ROADMAP A10's distributed half and raises here.
"""
from __future__ import annotations

import torch

from repro_torch.device import MULTI_DEVICE
from . import layers as L


def plain_ce(logits, labels, z_loss):
    return L.cross_entropy(logits, labels, z_loss)


def vocab_parallel_ce(x, w, labels, *, mesh=None, tied: bool,
                      z_loss: float = 1e-4, compute_dtype=torch.bfloat16):
    """x: (B, S, D) final hidden states; w: the embedding table (V, D) if
    ``tied``, else the head's (D, V) weight; labels: (B, S).  Returns the
    scalar mean loss."""
    if mesh is not None:
        raise NotImplementedError(f"vocab_parallel_ce over a mesh {MULTI_DEVICE}")
    if tied:
        logits = L.unembed_apply({"table": w}, x, compute_dtype)
    else:
        logits = L.dense_apply({"w": w}, x,
                               compute_dtype=compute_dtype).float()
    return plain_ce(logits, labels, z_loss)
