"""Sharding rules (reference ``repro.launch.sharding``): parameter, optimizer,
batch, cache and logits partition specs per architecture, and their
placements on a ``DeviceMesh``.

Strategy, as in the reference: pod = DP, data = FSDP, model = TP / EP,
with the two sequence-parallel modes (``ssm_seq``, ``sp_dense``).  The
parameter rules go by the leaf's path, spelled as ``jax.tree_util.keystr``
spells it (``['blocks']['attn']['q']['w']``); every rule checks that the
axis divides the dimension and replicates it otherwise.

A spec is :class:`P`: one entry per tensor dimension, an axis name, a
tuple of names (the dimension split over several axes, the first major)
or ``None``, the reference's ``PartitionSpec`` spelling, so the two
compare equal entry by entry.  Every rule reads only the mesh's axis
names and sizes, so it takes a ``DeviceMesh`` or a ``launch.mesh.
MeshShape`` (the 16 x 16 and 2 x 16 x 16 rules are checked on the CPU).
:func:`named` turns specs into :class:`NamedSharding`s, whose
``placements`` are DTensor placements on the mesh; :func:`local_block`
cuts a rank's block out of a full tensor.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Any

import torch

from repro_torch.core.compression import _map_with_path
from repro_torch.pytree import tree_map
from .mesh import batch_axes, mesh_shape, tp_size


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axis(mesh, name: str, dim: int):
    """Axis name if it divides dim, else None (replicate)."""
    mesh = mesh_shape(mesh)
    if name not in mesh.axis_names:
        return None
    return name if _div(dim, int(mesh.shape[name])) else None


def _baxis(mesh, dim: int):
    """Batch axes (pod,data) combined — falls back progressively."""
    axes = batch_axes(mesh)
    if not axes:
        return None
    mesh = mesh_shape(mesh)
    size = int(math.prod(mesh.shape[a] for a in axes))
    if _div(dim, size):
        return axes if len(axes) > 1 else axes[0]
    if "data" in axes and _div(dim, int(mesh.shape["data"])):
        return "data"
    return None


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _leaf_rule(tokens: list[str], shape: tuple[int, ...], mesh) -> P:
    """Spec for an UNSTACKED leaf (no leading layer dim)."""
    t = tokens
    name = t[-1]
    mod = t[-2] if len(t) >= 2 else ""
    ax = lambda a, i: _axis(mesh, a, shape[i])

    if "embed" in t and name == "table":            # (V, D)
        # vocab on model ONLY: sharding D on `data` makes the unembed
        # contraction dim conflict with the batch's data-sharding (the
        # reference's compiler then replicates the batch)
        return P(ax("model", 0), None)
    if "lm_head" in t:
        if name == "w":                             # (D, V)
            return P(None, ax("model", 1))
        if name in ("w1",):                         # low-rank (D, r)
            return P(None, None)
        if name in ("w2",):                         # (r, V)
            return P(None, ax("model", 1))
        return P(None)                              # bias (V,)
    # attention projections: params['attn'][{'q','k','v','o'}][{'w','b'}]
    if "attn" in t:
        proj = t[t.index("attn") + 1] if t.index("attn") + 1 < len(t) else ""
        if proj in ("q", "k", "v"):
            if name == "w":                         # (D, N*hd)
                return P(ax("data", 0), ax("model", 1))
            return P(ax("model", 0))                # bias (N*hd,)
        if proj == "o":
            if name == "w":                         # (N*hd, D)
                return P(ax("model", 0), ax("data", 1))
            return P(None)

    # MoE: router (D,E); experts (E, d_in, d_out)
    if "moe" in t:
        if "router" in t:
            return P(ax("data", 0), None) if name == "w" else P(None)
        if name in ("w_in", "w_gate"):              # (E, D, F)
            return P(ax("model", 0), ax("data", 1), None)
        if name == "w_out":                         # (E, F, D)
            return P(ax("model", 0), None, ax("data", 2))

    # dense MLP: params['mlp'][{'w_gate','w_in','w_out'}][{'w','b',...}]
    if "mlp" in t:
        proj = t[t.index("mlp") + 1] if t.index("mlp") + 1 < len(t) else ""
        if proj in ("w_gate", "w_in"):
            if name == "w":                         # (D, F)
                return P(ax("data", 0), ax("model", 1))
            if name == "w1":                        # low-rank (D, r)
                return P(ax("data", 0), None)
            if name == "w2":                        # (r, F)
                return P(None, ax("model", 1))
            return P(ax("model", 0))                # bias (F,)
        if proj == "w_out":
            if name == "w":                         # (F, D)
                return P(ax("model", 0), ax("data", 1))
            if name == "w1":                        # (F, r)
                return P(ax("model", 0), None)
            if name == "w2":                        # (r, D)
                return P(None, ax("data", 1))
            return P(None)                          # bias (D,)

    # Mamba2.  Projection weights deliberately do NOT shard their
    # contracting (d_model) dim on `data`: that conflicts with the batch's
    # data-sharding (the reference's compiler then replicates the batch
    # through the whole mamba stack).  At <=1.2B params the FSDP saving
    # these weights would buy is small.
    if "mamba" in t:
        if mod in ("z_proj", "x_proj", "dt_proj") and name == "w":
            return P(None, ax("model", 1))
        if mod in ("B_proj", "C_proj") and name == "w":
            return P(None, None)
        if name == "conv_x":                        # (W, d_inner)
            return P(None, ax("model", 1))
        if name == "conv_x_b":
            return P(ax("model", 0))
        if name in ("conv_B", "conv_C"):
            return P(None, None)
        if name in ("conv_B_b", "conv_C_b"):
            return P(None)
        if name in ("A_log", "dt_bias", "D"):       # (H,)
            return P(ax("model", 0))
        if "gn" in t and name == "scale":           # (d_inner,)
            return P(ax("model", 0))
        if mod == "out_proj" and name == "w":       # (d_inner, D)
            return P(ax("model", 0), None)
    # norms & scalars & leftover biases: replicate
    return P(*([None] * len(shape)))


_TOKEN_RE = re.compile(r"\['([^']+)'\]")


def _sp_dense_leaf_rule(tokens, shape, mesh, kv_shardable: bool) -> P:
    """Megatron-SP + explicit-ZeRO layout (models/_seq_scan_dense)."""
    name = tokens[-1]
    d_ax = "data" if "data" in mesh_shape(mesh).axis_names else None
    if "attn" in tokens:
        proj = tokens[tokens.index("attn") + 1]
        if proj == "q" and name == "w":
            return P(d_ax, "model")
        if proj in ("k", "v") and name == "w":
            return P(d_ax, "model" if kv_shardable else None)
        if proj == "o" and name == "w":
            return P("model", d_ax)
    if "mlp" in tokens:
        proj = tokens[tokens.index("mlp") + 1]
        if proj in ("w_in", "w_gate") and name == "w":
            return P(d_ax, "model")
        if proj == "w_out" and name == "w":
            return P("model", d_ax)
    if "embed" in tokens and name == "table":
        return P(_axis(mesh, "model", shape[0]), None)
    if "lm_head" in tokens and name == "w":
        return P(None, _axis(mesh, "model", shape[1]))
    return P(*([None] * len(shape)))


def param_pspecs(abstract_params, mesh, *, seq_parallel: bool = False,
                 mode: str | None = None, cfg=None) -> Any:
    """PartitionSpec pytree matching ``abstract_params``.

    Modes:
      * None          — FSDP x TP rules (_leaf_rule);
      * "ssm_seq"     — mamba-family sequence parallelism: ALL weights
        replicated, the sequence dim carries `model` (context-parallel
        SSD; <=1.2B params, so replication removes every per-layer TP
        all-reduce at little memory);
      * "sp_dense"    — Megatron-SP + explicit ZeRO for dense/vlm/audio.
    ``seq_parallel=True`` is shorthand for "ssm_seq" (back-compat)."""
    if seq_parallel and mode is None:
        mode = "ssm_seq"
    if mode == "ssm_seq":
        return tree_map(lambda leaf: P(*([None] * leaf.ndim)),
                        abstract_params)
    kv_shardable = bool(cfg and cfg.num_kv_heads
                        and cfg.num_kv_heads % tp_size(mesh) == 0)
    rule = ((lambda t, s: _sp_dense_leaf_rule(t, s, mesh, kv_shardable))
            if mode == "sp_dense" else (lambda t, s: _leaf_rule(t, s, mesh)))

    def spec(path, leaf):
        tokens = _TOKEN_RE.findall(path)
        shape = tuple(leaf.shape)
        if tokens and tokens[0] == "blocks":        # stacked: layer dim first
            s = P(None, *rule(tokens, shape[1:]))
        else:
            s = rule(tokens, shape)
        if len(s) != len(shape) and s != P():
            raise ValueError(f"spec {s} for {path} of shape {shape}")
        return s
    return _map_with_path(spec, abstract_params)


def opt_pspecs(abstract_opt, pspecs) -> Any:
    """Optimizer state: moments shard like params; step is replicated."""
    return {"m": pspecs, "v": pspecs, "step": P()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_pspecs(cfg, shape, mesh, *, seq_parallel: bool = False) -> dict[str, P]:
    b = _baxis(mesh, shape.global_batch)
    s = _axis(mesh, "model", shape.seq_len) if seq_parallel else None
    out: dict[str, P] = {}
    if cfg.family == "audio":
        out["frames"] = P(b, s, None)
    else:
        out["tokens"] = P(b, s)
    if shape.kind == "train":
        out["labels"] = P(b, s)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patch_embeds"] = P(b, None, None)
    return out


def use_splitkv(cfg, shape, mesh) -> bool:
    """Flash-decoding when KV heads do not divide tp (the cache then
    shards its sequence dim on `model`; see cache_pspecs)."""
    if os.environ.get("REPRO_NO_SPLITKV") == "1":
        return False
    tp = tp_size(mesh)
    return (shape.kind == "decode" and cfg.uses_attention
            and cfg.num_kv_heads % tp != 0 and tp > 1)


def use_seq_parallel(cfg, shape, mesh) -> bool:
    if os.environ.get("REPRO_NO_SEQP") == "1":   # A/B measurement switch
        return False
    # the reference takes sequence parallelism for both ssm and hybrid:
    # it measured less resharding traffic than the TP all-reduces
    return (cfg.uses_mamba and shape.kind in ("train", "prefill")
            and "model" in mesh_shape(mesh).axis_names
            and shape.seq_len % tp_size(mesh) == 0)


def parallel_mode(cfg, shape, mesh) -> str | None:
    """Select the sharding mode for one cell (None = FSDP x TP)."""
    if use_seq_parallel(cfg, shape, mesh):
        return "ssm_seq"
    if os.environ.get("REPRO_NO_SP_DENSE") == "1":
        return None
    tp = tp_size(mesh)
    s_total = shape.seq_len + (cfg.num_patches if cfg.family == "vlm" else 0)
    if (cfg.family in ("dense", "vlm", "audio") and shape.kind == "train"
            and tp > 1 and cfg.num_heads % tp == 0 and s_total % tp == 0):
        return "sp_dense"
    return None


def cache_pspecs(cfg, shape, mesh, abstract_cache) -> Any:
    """Specs for the decode cache pytree.

    KV heads shard on ``model`` when divisible; otherwise the cache
    SEQUENCE dim shards on ``model`` (flash-decoding-style split-KV,
    ``attention.attn_decode_splitkv``: small cross-shard collectives, and
    cache memory stays balanced with zero padding)."""
    b = _baxis(mesh, shape.global_batch)
    tp = tp_size(mesh)
    specs: dict[str, Any] = {}
    for key, leaf in abstract_cache.items():
        if key == "len":
            specs[key] = P()
        elif key in ("k", "v"):
            L_, B_, S_, KV_, hd_ = leaf.shape
            if _div(KV_, tp):
                specs[key] = P(None, b, None, "model", None)
            else:
                specs[key] = P(None, b, _axis(mesh, "model", S_), None, None)
        elif key == "ssm":
            specs[key] = P(None, b, _axis(mesh, "model", leaf.shape[2]), None, None)
        elif key == "conv":
            specs[key] = {
                "x": P(None, b, None, _axis(mesh, "model", leaf["x"].shape[3])),
                "B": P(None, b, None, None),
                "C": P(None, b, None, None),
            }
        else:
            raise KeyError(key)
    return specs


def logits_pspec(cfg, shape, mesh) -> P:
    b = _baxis(mesh, shape.global_batch)
    v_ax = _axis(mesh, "model", cfg.vocab_size)
    return P(b, None, v_ax)


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dimension: ``Shard(i)`` where
        the spec puts that axis on tensor dim ``i``, else ``Replicate``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_shape(self.mesh).axis_names:
            dims = [i for i, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, P(*s)), spec_tree)


def spec_of(t) -> P:
    """The spec of a DTensor's placements on its mesh (the inverse of
    :attr:`NamedSharding.placements`); a plain tensor's is replicated."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return P(*([None] * t.ndim))
    entries: list[list] = [[] for _ in range(t.ndim)]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            entries[pl.dim].append(name)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


def local_block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view):
    each sharded dimension cut into equal blocks over its axes, the first
    axis major."""
    from .mesh import axis_index, axis_size
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = axis_size(mesh, entry), axis_index(mesh, entry)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks over {entry}")
        step = t.shape[dim] // n
        t = t.narrow(dim, i * step, step)
    return t


def distribute(tree, shardings):
    """Each full tensor of ``tree`` as a DTensor placed by the matching
    :class:`NamedSharding`, every rank keeping only its block (no
    communication: each rank holds the full values)."""
    from torch.distributed.tensor import DTensor

    def one(t, s):
        return DTensor.from_local(local_block(t, s.mesh, s.spec).contiguous(),
                                  s.mesh, s.placements, run_check=False)
    return tree_map(one, tree, shardings)
