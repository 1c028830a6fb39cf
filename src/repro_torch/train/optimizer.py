"""Adam/AdamW with dtype-configurable moment states, and the IHT masks
(reference ``repro.train.optimizer``).

The update math runs in float32 whatever the storage dtype: each moment
is read in float32, updated as the reference writes it, op for op, and
rounded once to ``state_dtype``; each parameter is rounded once to its
own dtype.  ``update`` keeps the reference's functional signature and
returns the new trees, but it writes them into the leaves it was given,
under ``torch.no_grad()``: the trainer consumes its parameters and state
each step, as the reference's jitted step donates them, so a step holds
no second copy of either (at Qwen2-1.5B, 24 GB of parameters, moments and
gradients).  A caller that keeps the old values passes clones.

The IHT masks (the paper's sparsification at LM scale) come from the
port's ``core.compression``: recomputed on the cubic ramp, then frozen.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.compression import (IHTConfig, apply_masks_tree,
                                          compute_masks_tree,
                                          sparsity_at_epoch)
from repro_torch.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


def schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up: ``lr * min(1, (step + 1) / warmup_steps)``, float32
    (``step`` an int32 0-dim tensor)."""
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def init(params, cfg: AdamConfig) -> dict:
    """Zero moments in ``state_dtype`` on each parameter's device (a
    DTensor's with its placements) and an int32 step counter; ``meta``
    parameters give ``meta`` stand-ins."""
    dt = getattr(torch, cfg.state_dtype)

    def z(p):               # a DTensor's moments take its placements
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    first = next(tree_leaves(params))
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm over every leaf, leaf sums added in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def _update_leaf(p, g, m, v, *, cfg, scale, lr, c1, c2):
    """One leaf's update, written into p, m and v: the reference's
    ``upd``, each product and sum rounded where it rounds them.  A
    float32 moment is updated in its own storage."""
    f32 = torch.float32
    gs = g.to(f32) * scale
    mf = m.mul_(cfg.b1) if m.dtype == f32 else m.to(f32) * cfg.b1
    mf += gs * (1 - cfg.b1)
    t = gs * (1 - cfg.b2)
    t *= gs                                     # ((1 - b2) * g) * g
    del gs
    vf = v.mul_(cfg.b2) if v.dtype == f32 else v.to(f32) * cfg.b2
    vf += t
    del t
    u = (mf / c1).div_((vf / c2).sqrt_().add_(cfg.eps))
    if cfg.weight_decay:
        u += p.to(f32) * cfg.weight_decay
    u.mul_(lr)
    if p.dtype == f32:
        p.sub_(u)
    else:
        p.copy_(p.to(f32) - u)
    if mf is not m:
        m.copy_(mf)
    if vf is not v:
        v.copy_(vf)


def update(params, grads, state, cfg: AdamConfig):
    """-> (new_params, new_state, {"grad_norm", "lr"}), the new trees being
    the given leaves, updated in place (see the module docstring)."""
    with torch.no_grad():
        return apply_update(params, grads, state, cfg, global_norm(grads))


def apply_update(params, grads, state, cfg: AdamConfig, gnorm):
    """:func:`update` given the gradient's global norm ``gnorm``: a
    sharded step updates each rank's own blocks with the norm over every
    rank's (``models.registry.make_train_step``)."""
    with torch.no_grad():
        step = state["step"] + 1
        scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
                 if cfg.grad_clip else 1.0)
        lr = schedule(cfg, state["step"])
        sf = step.float()
        c1 = 1.0 - cfg.b1 ** sf
        c2 = 1.0 - cfg.b2 ** sf
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            _update_leaf(p, g, m, v, cfg=cfg, scale=scale, lr=lr, c1=c1,
                         c2=c2)
        state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# IHT (paper Sec. III-C at LM scale)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IHTState:
    masks: Any
    frozen: bool


def iht_epoch_masks(params, epoch: int, target_sparsity: float,
                    ramp_epochs: int, prev: IHTState | None,
                    path_filter=None) -> IHTState:
    """Recompute the masks on the cubic ramp; frozen after
    ``ramp_epochs``."""
    icfg = IHTConfig(target_sparsity=target_sparsity,
                     ramp_epochs=ramp_epochs)
    if epoch >= ramp_epochs and prev is not None and prev.frozen:
        return prev
    masks = compute_masks_tree(params, sparsity_at_epoch(icfg, epoch),
                               path_filter)
    return IHTState(masks=masks, frozen=epoch >= ramp_epochs)


def apply_iht(params, iht_state: IHTState | None):
    if iht_state is None:
        return params
    return apply_masks_tree(params, iht_state.masks)
