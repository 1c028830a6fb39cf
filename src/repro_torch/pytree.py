"""Nested dicts of tensors, the port's parameter trees (the reference's
JAX pytrees): map a function over their leaves, or list them."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` applied leaf by leaf to trees of one structure (dicts nest;
    anything else is a leaf)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """Every leaf of ``tree``, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree
