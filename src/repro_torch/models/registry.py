"""Registry: per-architecture serving functions and shape-only stand-ins
(reference ``repro.models.registry``, its serving half).

  * ``abstract_params(cfg)``           — the init tree as ``meta`` tensors
  * ``input_specs(cfg, shape)``        — ``meta`` batch stand-ins
  * ``abstract_cache(cfg, shape)``     — decode-cache stand-ins
  * ``make_prefill_step(cfg, shape)``  — (params, batch) -> logits for an
                                         encoder, (logits, cache) otherwise
  * ``make_decode_step(cfg, shape)``   — (params, cache, tokens) -> ...
  * ``abstract_opt(cfg, acfg)``        — the optimizer state's stand-ins
  * ``make_train_step(cfg, acfg)``     — (params, opt, batch) ->
                                         (params, opt, metrics)
  * ``param_count`` / ``active_param_count`` / ``step_flops_model``

A stand-in is a ``meta`` tensor: its ``shape`` and ``dtype`` are the
reference's ``ShapeDtypeStruct``'s, and it holds no storage, so the full
configs (``nemotron-4-340b`` included) are counted without allocating.
``long_*`` decode shapes pass ``window=cfg.sliding_window`` to the hybrid
family, as in the reference.

Over a mesh (``launch.mesh``) every step runs on every rank.  The
training step's parameters and Adam moments are DTensors placed by
``launch.sharding.param_pspecs`` / ``opt_pspecs``; the serving steps take
DTensors or whole tensors (of which each rank cuts its ``model`` blocks
under ``param_pspecs``).  In mode None (FSDP x TP) a step of every
family holds only the rank's blocks of its parameters, optimizer state,
gradients and cache: each layer gathers its weights' ``data`` dims at
use and computes on its ``model`` blocks (``transformer``'s mesh path:
the rank's heads, ``d_ff`` columns or experts, a mamba layer's heads and
channels, the hybrid's shared block as an attention block).  Under the
mamba families' sequence parallelism (``ssm_seq``) every parameter is
replicated, and each rank computes on its span of the sequence.  The
training step takes the global batch and computes on the rank's rows of
it; the serving steps take the rank's blocks of their batch and cache
(``sharding.local_block`` under ``batch_pspecs`` / ``cache_pspecs``) and
return the rank's blocks: a prefill's logits as ``sharding.logits_pspec``
places them and its cache as ``cache_pspecs`` does (what the mesh
decode takes), a decode's logits whole over the vocab.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compress.tree import dequantize_tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train import optimizer as opt_mod
from . import layers as L
from . import transformer as T


def _need_mesh(mesh, **flags) -> None:
    on = [k for k, v in flags.items() if v]
    if on and mesh is None:
        raise ValueError(f"{' and '.join(on)} run over a mesh's model axis: "
                         "pass mesh=")


def _gathered(tree):
    """Each DTensor leaf gathered whole; other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _mode(cfg, seq_parallel: bool):
    """The ``param_pspecs`` mode a step over a mesh takes."""
    if not seq_parallel:
        return None
    return "ssm_seq" if cfg.uses_mamba else "sp_dense"


def _rank_blocks(cfg, tree, mesh, mode):
    """-> (the rank's blocks of ``tree``, their specs) for a serving step
    on the rank's blocks: a DTensor's local block and the
    spec of its placements; a whole tensor's ``model`` block under
    ``param_pspecs`` (a view; its ``data`` dims stay whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding as sh

    def one(t, rule):
        if isinstance(t, DTensor):
            return t.to_local(), sh.spec_of(t)
        spec = sh.P(*(e if e == "model" else None for e in rule))
        return sh.local_block(t, mesh, spec), spec
    pairs = tree_map(one, tree, sh.param_pspecs(tree, mesh, mode=mode,
                                                cfg=cfg))
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def _serving_params(cfg, params, mesh, mode):
    """-> (params, specs) as a serving step hands them to ``transformer``:
    as given without a mesh; gathered whole under ``ssm_seq`` (whose
    weights are replicated); the rank's blocks otherwise."""
    if mesh is None:
        return params, None
    if mode == "ssm_seq":
        return _gathered(params), None
    return _rank_blocks(cfg, params, mesh, mode)


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def init(cfg: ModelConfig, generator: torch.Generator):
    return T.init(cfg, generator)


def abstract_params(cfg: ModelConfig):
    """``init``'s tree as ``meta`` tensors: the reference's leaf names,
    shapes and dtypes (float32 full-rank dense weights, ROADMAP C2), with
    nothing drawn or allocated."""
    return T.init(cfg, L.SHAPE_ONLY)


def abstract_opt(cfg: ModelConfig, acfg: opt_mod.AdamConfig):
    """``optimizer.init``'s state for ``init``'s tree as ``meta``
    tensors: the moments in ``acfg.state_dtype``, an int32 step."""
    return opt_mod.init(abstract_params(cfg), acfg)


def make_train_step(cfg: ModelConfig, acfg: opt_mod.AdamConfig, mesh=None,
                    seq_parallel: bool = False, tracer=None):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of ``transformer.train_loss`` and one
    ``optimizer.update``, which writes the given parameters and state in
    place (the reference's jitted step donates both).  ``metrics``: the
    loss and the loss's own metrics, ``grad_norm`` and ``lr``, as 0-dim
    tensors on the parameters' device.  ``tracer``
    (:class:`repro_torch.obs.Tracer`): the host time of each step's
    forward, backward and update as ``train.forward``, ``train.backward``
    and ``train.update`` spans.  With a ``mesh``, see
    :func:`_sharded_train_step` (no spans)."""
    _need_mesh(mesh, seq_parallel=seq_parallel)
    if mesh is not None:
        if tracer is not None:
            raise ValueError("the training step's spans are recorded on "
                             "one device: pass no tracer with a mesh")
        return _sharded_train_step(cfg, acfg, mesh, seq_parallel)
    tr = NULL_TRACER if tracer is None else tracer

    def train_step(params, opt_state, batch):
        t0 = tr.t()
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = T.train_loss(cfg, live, batch)
        tr.rec("train.forward", t0)
        t0 = tr.t()
        leaves = list(tree_leaves(live))
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), live)
        del live, leaves
        tr.rec("train.backward", t0)
        t0 = tr.t()
        params, opt_state, om = opt_mod.update(params, grads, opt_state,
                                               acfg)
        tr.rec("train.update", t0)
        return params, opt_state, _metrics(loss, metrics, om)
    return train_step


def _metrics(loss, metrics, om):
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}


def _sharded_train_step(cfg, acfg, mesh, seq_parallel):
    """The training step over ``mesh``, on every rank.  ``params`` and
    ``opt_state`` are DTensors (``launch.sharding.distribute`` under
    ``param_pspecs`` / ``opt_pspecs``); ``batch`` is the global batch.
    The gradients are :func:`_sharded_grads`'; each rank's Adam then
    updates its own blocks, with the gradient norm over every rank's."""
    grads_of = _sharded_grads(cfg, mesh, seq_parallel)

    def train_step(params, opt_state, batch):
        loss, metrics, grads, gnorm = grads_of(params, batch)
        _, _, om = opt_mod.apply_update(tree_map(_local, params), grads,
                                        tree_map(_local, opt_state), acfg,
                                        gnorm)
        return params, opt_state, _metrics(loss, metrics, om)
    return train_step


def _sharded_grads(cfg, mesh, seq_parallel):
    """-> ``grads(params, batch) -> (loss, metrics, grads, grad_norm)``
    over ``mesh``, on every rank: ``params`` DTensors, ``batch`` the
    global batch, of which the rank takes its rows (split over the batch
    axes); ``grads`` the rank's block of each leaf's gradient of the
    global loss, ``grad_norm`` the global norm.  ``train_loss`` gets the
    rank's blocks and their placements: each layer gathers its weights'
    ``data`` dims at use and computes on its ``model`` blocks; under the
    mamba families' sequence parallelism every leaf is gathered whole
    first (a replicated leaf is whole already).  Every rank's loss is the
    global one, and each rank seeds loss
    / ranks, so that a block's gradients summed over every rank that
    holds a copy of it are its gradient: a gather's backward
    reduce-scatters a ``data`` dim's share back to its block, and the
    gradient of a leaf replicated along an axis is summed over that axis.
    The norm counts each replicated block once."""
    from repro_torch.launch.sharding import P, local_block, spec_of

    names = M.mesh_shape(mesh).axis_names
    ranks = M.axis_size(mesh, names)
    rows = P(M.batch_axes(mesh) or None)

    def copies(t):          # the ranks that hold each block of t
        return math.prod(M.axis_size(mesh, n) for n, pl in
                         zip(names, t.placements) if pl.is_replicate())

    def summed(g, t):       # over the axes t is replicated along
        for n, pl in zip(names, t.placements):
            if pl.is_replicate():
                g = M.psum(g, mesh, n)
        return g

    def grads(params, batch):
        specs = tree_map(spec_of, params)
        live = tree_map(lambda t: _local(t).detach().requires_grad_(),
                        params)
        if seq_parallel and cfg.uses_mamba:
            use = tree_map(lambda t, s: M.gather_layer(t, s, mesh, keep=()),
                           live, specs)
            use_specs = None
        else:
            use, use_specs = live, specs
        mine = {k: local_block(v, mesh, rows) for k, v in batch.items()}
        loss, metrics = T.train_loss(cfg, use, mine, mesh=mesh,
                                     seq_parallel=seq_parallel,
                                     specs=use_specs)
        # a leaf the step leaves unused (the reference's Megatron-SP body
        # reads only the "w" leaves) has a zero gradient, as under jax.grad
        gl = list(torch.autograd.grad(loss / ranks, list(tree_leaves(live)),
                                      materialize_grads=True))
        del live, use
        with torch.no_grad():
            for i, p in enumerate(tree_leaves(params)):
                gl[i] = summed(gl[i], p)     # one leaf's copy at a time
            sq = sum(torch.sum(torch.square(g.float())) / copies(p)
                     for g, p in zip(gl, tree_leaves(params)))
            gnorm = torch.sqrt(M.psum(sq, mesh, names))
        it = iter(gl)
        return loss, metrics, tree_map(lambda _: next(it), params), gnorm
    return grads


def _window_for(cfg: ModelConfig, shape: ShapeConfig):
    if shape.name == "long_500k" and cfg.family == "hybrid":
        return cfg.sliding_window
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Batch stand-ins for one (arch x shape) cell: tokens, audio's
    frames, a vlm's patch embeddings, training labels."""
    B, S = shape.global_batch, shape.seq_len
    out: dict = {}
    if shape.kind == "decode":
        out["tokens"] = _spec((B, 1), torch.int32)
        return out
    if cfg.family == "audio":
        out["frames"] = _spec((B, S, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _spec((B, S), torch.int32)
    if cfg.family == "vlm":
        out["patch_embeds"] = _spec((B, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
    if shape.kind == "train":
        out["labels"] = _spec((B, S), torch.int32)
    return out


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    """Decode-cache stand-ins with ``max_len = shape.seq_len`` (one new
    token over a cache of ``seq_len``)."""
    return T.cache_spec(cfg, shape.global_batch, shape.seq_len,
                        dtype=cfg.cdtype)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig | None = None,
                      mesh=None, seq_parallel: bool = False):
    """An encoder's prefill is its forward pass: (params, batch) ->
    logits (the audio family's serving entry point).  Otherwise
    (params, batch, max_len=None) -> (logits, cache), the cache sized to
    ``max_len`` positions (the sequence's own length by default) and,
    over a mesh, the rank's blocks of it under ``cache_pspecs``, which
    :func:`make_decode_step` over the same mesh takes."""
    _need_mesh(mesh, seq_parallel=seq_parallel)
    window = _window_for(cfg, shape) if shape else None
    mode = _mode(cfg, seq_parallel)

    def prefill_step(params, batch, max_len=None):
        params, specs = _serving_params(cfg, params, mesh, mode)
        kw = dict(window=window, mesh=mesh, seq_parallel=seq_parallel,
                  specs=specs)
        if cfg.is_encoder:
            return T.forward(cfg, params, batch, **kw)[0]
        return T.prefill(cfg, params, batch, max_len, **kw)
    return prefill_step


def _model_dims(cfg, shape, mesh, splitkv: bool) -> dict:
    """{"k": 2, "v": 2} when ``cache_pspecs`` splits the K/V cache's
    sequence over ``model`` and the decode does not take split-KV
    (``REPRO_NO_SPLITKV=1`` at KV heads that do not divide ``model``):
    every rank then attends over every position.  Every other leaf split
    over ``model`` is decoded on its block.  Empty without a mesh or a
    shape."""
    if mesh is None or shape is None or splitkv or not cfg.uses_attention:
        return {}
    from repro_torch.launch.sharding import cache_pspecs
    specs = cache_pspecs(cfg, shape, mesh, abstract_cache(cfg, shape))
    return {k: 2 for k in ("k", "v") if specs[k][2] == "model"}


def _sharded_decode(step, dims: dict, mesh):
    """``step(params, cache, tokens)`` over a cache of this rank's blocks
    (``launch.sharding.cache_pspecs``): each leaf of ``dims``
    (:func:`_model_dims`) is gathered whole along ``model`` before the
    step, and its block of the result is written back into the given
    leaf, in place."""
    if not dims:
        return step

    def decode(params, cache, tokens):
        whole = dict(cache)
        for key, d in dims.items():
            whole[key] = M.all_gather(cache[key], mesh, "model", d)
        logits, new = step(params, whole, tokens)
        out = dict(new)
        for key, d in dims.items():
            mine = cache[key]
            n = mine.shape[d]
            mine.copy_(new[key].narrow(d, M.axis_index(mesh, "model") * n, n))
            out[key] = mine
        return logits, out
    return decode


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig | None = None,
                     mesh=None, splitkv: bool = False):
    """(params, cache, tokens) -> (logits, cache).  Over a mesh, with a
    ``shape``, the cache holds this rank's blocks under
    ``launch.sharding.cache_pspecs``: its rows, and along ``model`` the
    split-KV sequence span when ``splitkv``, else its KV heads, its SSM
    state's heads and its x conv tail's channels, on which the step
    decodes; a K/V sequence split without ``splitkv`` is gathered whole
    for the step (:func:`_model_dims`)."""
    _need_mesh(mesh, splitkv=splitkv)
    window = _window_for(cfg, shape) if shape else None

    def decode_step(params, cache, tokens):
        params, specs = _serving_params(cfg, params, mesh, None)
        return T.decode_step(cfg, params, cache, tokens, window=window,
                             mesh=mesh, splitkv=splitkv, specs=specs)
    return _sharded_decode(decode_step, _model_dims(cfg, shape, mesh,
                                                    splitkv), mesh)


def abstract_quantized_params(cfg: ModelConfig, bits: int = 8):
    """(qparams, scales) stand-ins for the L-S-Q serving path: every
    >=2-D floating leaf becomes int8/int16, with a float32 0-dim scale for
    every leaf."""
    dt = torch.int8 if bits == 8 else torch.int16

    def q(leaf):
        if leaf.ndim >= 2 and leaf.is_floating_point():
            return _spec(leaf.shape, dt)
        return leaf
    ap = abstract_params(cfg)
    qp = tree_map(q, ap)
    scales = tree_map(lambda _: _spec((), torch.float32), ap)
    return qp, scales


def make_decode_step_quantized(cfg: ModelConfig,
                               shape: ShapeConfig | None = None,
                               bits: int = 8, mesh=None,
                               splitkv: bool = False):
    """Decode over int-quantized weights: the tree is dequantized to
    bfloat16 each call (``compress.tree.dequantize_tree``).  Over a mesh,
    as :func:`make_decode_step`: each rank dequantizes its blocks (the
    scales are replicated 0-dim tensors)."""
    _need_mesh(mesh, splitkv=splitkv)
    window = _window_for(cfg, shape) if shape else None

    dims = _model_dims(cfg, shape, mesh, splitkv)

    def decode_step(qparams, scales, cache, tokens):
        qparams, specs = _serving_params(cfg, qparams, mesh, None)
        params = dequantize_tree(qparams, tree_map(_local, scales))
        return _sharded_decode(
            lambda p, c, t: T.decode_step(cfg, p, c, t, window=window,
                                          mesh=mesh, splitkv=splitkv,
                                          specs=specs),
            dims, mesh)(params, cache, tokens)
    return decode_step


def step_flops_model(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline's usefulness ratio: 6 N D (train),
    2 N per token otherwise, N the active parameters."""
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def _leaves_with_keys(tree, path=""):
    """(key, leaf) of every leaf, the key spelled as ``jax.tree_util.
    keystr`` spells a dict path (``['blocks']['moe']['w_in']``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, f"{path}['{k}']")
    else:
        yield path, tree


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(leaf.shape)
               for _, leaf in _leaves_with_keys(abstract_params(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: a MoE expert weight counts top_k of
    num_experts; the embedding lookup does not count, the unembedding
    matmul does."""
    total = 0
    for key, leaf in _leaves_with_keys(abstract_params(cfg)):
        n = math.prod(leaf.shape)
        if "moe" in key and "router" not in key:
            n = n * cfg.top_k // cfg.num_experts
        if "embed" in key:
            continue
        total += n
    return total
