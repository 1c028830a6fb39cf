"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (reference
``repro.train.pipeline``).

Every stage runs the SAME callable over its own layer slice.  Inputs are
microbatched (M, b, ...); stage s works on microbatch (t - s) at tick t,
over M + P - 1 ticks, and hands its output to stage s + 1 after each tick
(``dist.batch_isend_irecv``).  The hand-off and the final broadcast are
differentiable, so a backward through :func:`pipeline_apply` runs the
classic GPipe forward-then-backward schedule, whose bubble fraction is
(P - 1) / (M + P - 1).
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh as M
from repro_torch.pytree import tree_map


def pipeline_apply(stage_fn, stage_params, x_micro, *, mesh,
                   axis: str = "stage"):
    """``stage_fn(params_slice, x) -> y``, applied by each of the P stages
    in turn.  Called on every rank of ``mesh``; ``stage_params`` is this
    rank's block of the stage-major stacked parameters (leading dim 1,
    the reference's ``P(axis)`` shard) and ``x_micro`` the full (M, b,
    ...) microbatches.  Returns the (M, b, ...) outputs of the last stage,
    the same on every rank."""
    n_stage = M.axis_size(mesh, axis)
    sid = M.axis_index(mesh, axis)
    m = x_micro.shape[0]
    params = tree_map(lambda a: a[0], stage_params)
    carry = torch.zeros_like(x_micro[0])      # the microbatch on the wire
    outs = []
    for t in range(m + n_stage - 1):
        # stage 0 takes in microbatch t; the others take the wire
        inp = x_micro[min(t, m - 1)] if sid == 0 else carry
        out = stage_fn(params, inp)
        carry = M.shift_next(out, mesh, axis)
        # the last stage finishes microbatch t - P + 1
        if t >= n_stage - 1:        # a select on every rank (the backward
            outs.append(torch.where(   # runs the psum's on every rank)
                torch.tensor(sid == n_stage - 1, device=out.device), out,
                torch.zeros_like(out)))
    # every rank gets the last stage's results (a sum of masked copies)
    return M.psum(torch.stack(outs), mesh, axis)


def bubble_fraction(n_stage: int, n_micro: int) -> float:
    return (n_stage - 1) / (n_micro + n_stage - 1)
