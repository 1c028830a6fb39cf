"""The LM's cross-entropy over the unembedding (reference
``repro.models.losses``), plain or vocab-parallel (Megatron-style).

``vocab_parallel_ce`` takes the final hidden states and the unembedding
weight and returns the mean loss.  Without a mesh it is the plain path:
the head's logits in float32, then ``layers.cross_entropy``.  Over a mesh
it runs on every rank, on the rank's batch rows (the batch split over
``pod`` x ``data``) with the rank's block of the weight's vocab over
``model``, where the reference runs its ``shard_map``:

  * each ``model`` rank computes the logits of its own slice of the vocab;
  * the log-sum-exp is merged over ``model`` from each rank's own (a
    stop-gradient max, then the sum of exponentials); the label's logit
    is picked by the rank whose slice holds it and summed over ``model``;
  * the z-loss is kept, and the mean is taken over the batch axes.

Every collective is differentiable (``launch.mesh``), so the gradients of
the ranks, summed, are the plain path's gradient times the number of
ranks, as for any loss every rank computes whole.  At one ``model`` rank
each merge is the identity (exp(0) = 1, log(1) = 0).  A weight that
holds the whole vocab (a vocab that does not divide the ``model`` axis,
which ``sharding`` then replicates, or one ``model`` rank) takes the
plain path on the rank's rows, its mean taken over the batch axes: at
1 x 1 the plain path's loss and gradient bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh as M
from . import layers as L


def plain_ce(logits, labels, z_loss):
    return L.cross_entropy(logits, labels, z_loss)


def _logits(x, w, tied: bool, compute_dtype):
    if tied:
        return L.unembed_apply({"table": w}, x, compute_dtype)
    return L.dense_apply({"w": w}, x, compute_dtype=compute_dtype).float()


def vocab_parallel_ce(x, w, labels, *, mesh=None, tied: bool,
                      vocab: int | None = None, z_loss: float = 1e-4,
                      compute_dtype=torch.bfloat16):
    """x: (B, S, D) final hidden states; w: the embedding table (V, D) if
    ``tied``, else the head's (D, V) weight; labels: (B, S).  Returns the
    scalar mean loss (over a mesh: B is the rank's rows, and the loss is
    the global batch's mean, the same on every rank).  Over a mesh ``w``
    is the rank's block of the ``vocab`` ids over ``model`` (``(V / tp,
    D)`` or ``(D, V / tp)``, rank-ordered) when its vocab dimension is
    smaller than ``vocab``; else it is whole."""
    v_loc = w.shape[0] if tied else w.shape[1]
    if mesh is None:
        return plain_ce(_logits(x, w, tied, compute_dtype), labels, z_loss)
    baxes = M.batch_axes(mesh)
    if vocab is None or v_loc == vocab:
        loss = plain_ce(_logits(x, w, tied, compute_dtype), labels, z_loss)
        return M.pmean(loss, mesh, baxes)
    v0 = M.axis_index(mesh, "model") * v_loc
    logits = _logits(x, w, tied, compute_dtype)
    lse_loc = torch.logsumexp(logits, dim=-1)               # (b, s)
    mx = M.pmax(lse_loc, mesh, "model")                     # no gradient
    lse = mx + torch.log(M.psum(torch.exp(lse_loc - mx), mesh, "model"))
    rel = labels.long() - v0
    mine = (rel >= 0) & (rel < v_loc)
    pick = logits.gather(-1, rel.clamp(0, v_loc - 1)[..., None])[..., 0]
    ll = M.psum(torch.where(mine, pick, torch.zeros_like(pick)), mesh,
                "model")
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return M.pmean(loss.mean(), mesh, baxes)
