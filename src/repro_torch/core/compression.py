"""L-S-Q stage 1+2: IHT sparsification (paper Sec. III-C), a torch copy of
the reference ``repro.core.compression``.

At each step retain the top-k magnitude entries of every *sparsifiable*
tensor and zero the rest; the target sparsity follows the cubic ramp
``s_e = s * min(1, e/e_ramp)^3``, then the mask freezes for the fine-tune
phase.  Masks are boolean tensors on the weights' device and equal the
reference's bit for bit, ties included, on the CPU and on the card.

Flat dicts serve the FastGRNN pipeline; ``compute_masks_tree`` /
``apply_masks_tree`` work over the port's nested-dict trees
(:mod:`repro_torch.pytree`) with the reference's path spelling.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class IHTConfig:
    target_sparsity: float = 0.5        # s: fraction of entries REMOVED
    ramp_epochs: int = 50               # e_ramp (cubic schedule)
    finetune_epochs: int = 50           # mask frozen afterwards
    # Predicate selecting which leaves are sparsified.  The paper sparsifies
    # the four factor matrices only (not biases, scalars, or the head).
    leaf_filter: Callable[[str], bool] = staticmethod(
        lambda name: name in ("W", "U", "W1", "W2", "U1", "U2")
    )


def sparsity_at_epoch(cfg: IHTConfig, epoch: int) -> float:
    """Paper Eq. (7): cubic ramp to the target sparsity."""
    frac = min(1.0, epoch / max(cfg.ramp_epochs, 1))
    return cfg.target_sparsity * frac ** 3


def topk_mask(x: torch.Tensor, keep: int) -> torch.Tensor:
    """Boolean mask retaining the ``keep`` largest-|x| entries of x.

    The threshold is the keep-th largest magnitude and the mask is
    ``|x| >= thresh``; when ties at the threshold make the count wrong,
    the rank of a stable descending sort decides (earlier entries win),
    exactly as the reference does."""
    if keep >= x.numel():
        return torch.ones_like(x, dtype=torch.bool)
    if keep <= 0:
        return torch.zeros_like(x, dtype=torch.bool)
    flat = x.abs().reshape(-1)
    thresh = torch.topk(flat, keep).values[-1]
    mask = x.abs() >= thresh
    order = torch.argsort(-flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=x.device)
    exact = (rank < keep).reshape(x.shape)
    return torch.where(mask.sum() == keep, mask, exact)


def compute_masks(params: dict[str, Any], cfg: IHTConfig, sparsity: float):
    """Per-leaf boolean masks at the given sparsity level (flat dict of
    tensors)."""
    masks = {}
    for name, w in params.items():
        if cfg.leaf_filter(name) and isinstance(w, torch.Tensor) \
                and w.numel() > 1:
            keep = int(round(w.numel() * (1.0 - sparsity)))
            masks[name] = topk_mask(w, keep)
        else:
            masks[name] = (torch.ones_like(w, dtype=torch.bool)
                           if isinstance(w, torch.Tensor) else True)
    return masks


def apply_masks(params: dict[str, Any], masks: dict[str, Any]):
    return {k: (torch.where(masks[k], v, torch.zeros_like(v))
                if isinstance(masks[k], torch.Tensor) else v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Nested-dict variant for LM trees (path-based filter).
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, ``path`` spelled as the
    reference's ``jax.tree_util.keystr`` spells it (``"['a']['w']"``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return fn(path, tree)


def compute_masks_tree(params, sparsity: float, path_filter=None):
    """Masks over a nested dict; ``path_filter(path_str, leaf) -> bool``
    (default: every leaf of two or more dims)."""
    def mask(name, leaf):
        sparsify = (leaf.ndim >= 2) if path_filter is None \
            else path_filter(name, leaf)
        if sparsify:
            return topk_mask(leaf, int(round(leaf.numel() * (1.0 - sparsity))))
        return torch.ones_like(leaf, dtype=torch.bool)
    return _map_with_path(mask, params)


def apply_masks_tree(params, masks):
    return tree_map(lambda w, m: torch.where(m, w, torch.zeros_like(w)),
                    params, masks)


def deployed_param_count(params, masks) -> int:
    """Stored-parameter accounting (paper 'nonzero' column): sparsified
    leaves store their kept slots (mask.sum()); dense leaves store every
    entry regardless of value (a zero-initialized bias still occupies its
    2 bytes in the deployed image).  Masks may be boolean tensors or the
    boolean numpy arrays an artifact carries."""
    total = 0
    for k, v in params.items():
        m = masks.get(k, True)
        m = torch.as_tensor(m) if hasattr(m, "dtype") else None
        if m is not None and m.dtype == torch.bool and not bool(m.all()):
            total += int(m.sum())
        else:
            total += int(torch.as_tensor(v).numel())
    return total


def sparsity_of(params, leaf_filter=None) -> float:
    """Realized sparsity over the sparsifiable leaves (tensor or numpy
    leaves)."""
    total = nz = 0
    if isinstance(params, dict) and leaf_filter is not None:
        items = [torch.as_tensor(v) for k, v in params.items()
                 if leaf_filter(k)]
    else:
        items = [v for v in map(torch.as_tensor, tree_leaves(params))
                 if v.ndim >= 2]
    for v in items:
        total += v.numel()
        nz += int(torch.count_nonzero(v))
    return 1.0 - nz / max(total, 1)
