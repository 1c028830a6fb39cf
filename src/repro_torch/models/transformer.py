"""LM assembly (reference ``repro.models.transformer``) for every family
of the reference:

  dense : [rmsnorm -> GQA attention -> rmsnorm -> MLP] x L
  moe   : [rmsnorm -> GQA attention -> rmsnorm -> MoE] x L
  ssm   : [rmsnorm -> Mamba-2] x L
  hybrid: the Mamba-2 backbone with ONE shared attention + MLP block
          applied after every ``attn_every`` mamba layers (zamba2)
  vlm   : the dense decoder over precomputed patch embeddings
          (``batch["patch_embeds"]``, (B, P, D)) put in front of the text
          embeddings; logits and the text offset start after the patches
  audio : a bidirectional encoder over precomputed frame embeddings
          (``batch["frames"]``, (B, S, D)) with a frame-classification
          head that has a bias; no embedding table and no decode path

Parameters are a nested dict of tensors; the per-layer parameters are
stacked with a leading L axis (``params["blocks"]``), as the reference
stacks them, and a Python loop over the layers (``torch.unbind`` views,
so a gradient reaches each stacked leaf in one copy) takes the place of
``lax.scan``.  Serving's full-sequence mamba scans go through the SSD
scan kernel's entry point (``kernels.ssd_scan.ops.ssd_scan``, the
reference's ``ssm_impl`` seam); :func:`train_loss` scans with
``mamba2.ssd_chunked``, as the reference trains (the kernel has no
backward), and with ``cfg.remat`` recomputes each layer's activations in
the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body).  A ``moe`` block's FFN is
``models.moe.moe_apply``: at ``cfg.capacity_factor`` over a full
sequence (a prefill may drop tokens, as the reference's does) and at
``num_experts / top_k`` in both decode paths, which never drops.  Serving
keeps the reference's cache layouts: ``(L, B, S_max, KV, hd)`` K/V
(``(n_groups, ...)`` for the hybrid shared block), ``(L, B, H, N, P)``
float32 SSM states and ``(L, B, 3, width)`` conv tails, with one shared
fill level ``len`` (a Python int here) or, for continuous batching, a
per-slot fill level ``pos`` ((S,) int32 tensor).  A vlm cache holds the
patch positions too: its fill level counts them.  Decode writes the cache
tensors in place (the slotted decode its ``pos`` too) and returns the
cache dict; an inactive slot keeps its cache rows and ``pos`` bit for
bit.

Over a mesh (``launch.mesh``) every function runs on every rank, on the
rank's batch rows (the batch split over ``pod`` x ``data``) and on the
rank's blocks of the parameters (``specs``: their
``sharding.param_pspecs`` placements; a leaf given whole is used
whole).  Each layer gathers its weights' ``data`` dims at use, inside the
layer (the FSDP gather), and never their ``model`` blocks; only
activations cross ``model``.  The attention families' blocks are
partitioned along ``model`` as GSPMD partitions the reference's step
(:func:`_attn_block`: the rank's heads, its ``d_ff`` columns or its
experts, a ``psum`` of each output), the embedding and the head on the
rank's block of the vocab (``losses.vocab_parallel_ce``), plus the
reference's explicit ``shard_map`` regions: sequence parallelism
(``seq_parallel=True``: Megatron-SP over the dense blocks,
context-parallel SSD over the mamba blocks, the hybrid's shared block on
the gathered sequence) and split-KV decoding (``splitkv=True``).  The
mamba families run each mamba layer on the rank's heads and channels
(``mamba2.mamba_apply`` over a full sequence, ``mamba2.mamba_decode`` for
a token) and the hybrid's shared block as an attention block; under
sequence parallelism their weights are replicated and each rank runs
its span.  A prefill over a mesh returns the rank's blocks of the cache,
as the mesh decode takes them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.pytree import tree_map
from . import attention as A
from . import layers as L
from . import losses
from . import mamba2 as S
from . import moe as M

def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree: views, no copy."""
    return tree_map(lambda t: t[i], tree)


def _stack(trees):
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _shared_after(cfg, i: int) -> bool:
    """Whether the hybrid's shared block follows mamba layer ``i`` (it is
    then the block's ``(i + 1) // attn_every - 1``-th application)."""
    return cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(cfg, generator):
    dt, dev = cfg.pdtype, generator.device
    if cfg.uses_mamba:
        return {"ln": L.rmsnorm_init(cfg.d_model, dt, dev),
                "mamba": S.mamba_init(generator, cfg, dt)}
    p = {"ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
         "attn": A.attn_init(generator, cfg.d_model, cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim,
                             qkv_bias=cfg.qkv_bias, dtype=dt),
         "ln2": L.rmsnorm_init(cfg.d_model, dt, dev)}
    if cfg.family == "moe":
        p["moe"] = M.moe_init(generator, cfg.d_model, cfg.d_ff,
                              cfg.num_experts, cfg.mlp_kind, dt)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                              cfg.mlp_kind, rank=cfg.lsq_rank, dtype=dt)
    return p


def init(cfg, generator: torch.Generator) -> dict[str, Any]:
    """Parameters with the reference's leaf names, shapes and dtypes, drawn
    from ``generator`` on its device (not the reference's values: JAX's
    PRNG is not reproduced).  Given ``layers.SHAPE_ONLY`` it builds the
    same tree of ``meta`` tensors and draws and allocates nothing."""
    dt, dev = cfg.pdtype, generator.device
    p: dict[str, Any] = {}
    if cfg.family != "audio":
        p["embed"] = L.embed_init(generator, cfg.vocab_size, cfg.d_model, dt)
    p["blocks"] = _stack([_block_init(cfg, generator)
                          for _ in range(cfg.num_layers)])
    if cfg.family == "hybrid":
        p["shared"] = {
            "ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
            "attn": A.attn_init(generator, cfg.d_model, cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim, dtype=dt),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                              cfg.mlp_kind, dtype=dt)}
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
    if cfg.family == "audio":
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    bias=True, dtype=dt)
    elif not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dtype=dt)
    return p


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg, bp, y, *, decode: bool = False, mesh=None):
    """The block's MLP, or its MoE: -> (out, aux).  A full sequence routes
    at ``cfg.capacity_factor``; the decode paths at ``num_experts /
    top_k``, which gives every expert room for every token, so serving
    never drops one.  Over a ``mesh``, ``bp`` may hold the rank's blocks
    over ``model``: see :func:`_tp_mlp` and :func:`_ep_moe`."""
    if cfg.family == "moe":
        cf = cfg.num_experts / cfg.top_k if decode else cfg.capacity_factor
        return _ep_moe(cfg, mesh, bp["moe"], y, cf)
    return _tp_mlp(cfg, mesh, bp["mlp"], y), _zero_aux(y.device)


def _mamba_block(cfg, bp, x, ssm_impl=None, mesh=None, spec=None):
    """One mamba layer; its scan is ``ssm_impl``, by default the SSD scan
    kernel's entry point (looked up at the call, so a caller may wrap
    it).  Over a ``mesh``, on the rank's ``model`` blocks of the layer
    (``mamba2.mamba_apply``), its ``data`` dims gathered at use; the
    state it returns is the rank's blocks."""
    if mesh is not None:
        bp = mesh_lib.gather_layer(bp, spec, mesh)
    y, state = S.mamba_apply(bp["mamba"],
                             L.rmsnorm_apply(bp["ln"], x, cfg.norm_eps), cfg,
                             chunk=cfg.ssd_chunk, compute_dtype=cfg.cdtype,
                             ssm_impl=ssm_impl or ssd_ops.ssd_scan, mesh=mesh)
    return x + y, state


def _zero_aux(device):
    """The reference's two router losses, and the count of (token, expert)
    assignments dropped past capacity (``models.moe``)."""
    return {"aux_loss": torch.zeros((), device=device),
            "router_z_loss": torch.zeros((), device=device),
            "dropped": torch.zeros((), dtype=torch.int64, device=device)}


def _embed(cfg, params, tokens, mesh=None):
    """The token embeddings in the compute dtype.  Over a ``mesh`` whose
    ``model`` axis splits the table's rows (the vocab), a vocab-parallel
    lookup: each rank reads the tokens of its block of the vocab, zeros
    for the others, summed over ``model`` (one nonzero term, so the sum
    is exact)."""
    table = params["embed"]["table"]
    v_loc = table.shape[0]
    if mesh is None or v_loc == cfg.vocab_size:
        return L.embed_apply(params["embed"], tokens, cfg.cdtype)
    rel = tokens.long() - mesh_lib.axis_index(mesh, "model") * v_loc
    mine = (rel >= 0) & (rel < v_loc)
    x = table[rel.clamp(0, v_loc - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return mesh_lib.psum(x, mesh, "model").to(cfg.cdtype)


def _embed_inputs(cfg, params, batch, mesh=None):
    """-> (x (B, S', D), positions (B, S'), text offset).  Audio takes its
    frame embeddings in the compute dtype; vlm puts its patch embeddings
    (in the compute dtype) in front of the text embeddings, and the text
    starts at their count."""
    if cfg.family == "audio":
        x, off = batch["frames"].to(cfg.cdtype), 0
    else:
        x, off = _embed(cfg, params, batch["tokens"], mesh), 0
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(cfg.cdtype)
            x, off = torch.cat([patches, x], dim=1), patches.shape[1]
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, pos, off


def _layers(blocks, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree: ``torch.unbind``
    views, whose backward stacks the layers' gradients once."""
    cols = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda c: c[i], cols) for i in range(n)]


def _remat(cfg, train: bool, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    training a config with ``remat`` (the reference's ``jax.checkpoint``
    of one layer)."""
    if train and cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _stacked_forward(cfg, params, x, positions, *, window=None,
                     train: bool = False, mesh=None, seq_parallel=False,
                     specs=None, cache_len=None, tracer=NULL_TRACER):
    """Every block in turn.  Returns (x, aux, caches): K/V stacked as (L,
    B, S, KV, hd) (dense; (n_groups, ...) for the hybrid's shared block),
    SSM states as (L, B, H, N, P) and conv tails as (L, B, 3, width).
    ``train``: no caches (``None``), mamba scans by ``ssd_chunked`` and
    ``cfg.remat`` honoured.  ``seq_parallel``: see
    :func:`_seq_parallel_forward`.  The attention families' blocks are
    :func:`_attn_block`s; over a ``mesh`` each layer's K/V is cut to the
    rank's block of a cache of ``cache_len`` positions (the sequence's
    own length by default) as soon as the layer has made it
    (:func:`_kv_block`).  ``tracer``: each layer's host time as a
    ``model.mamba`` or ``model.attn`` span, and each SSD scan call's as
    ``model.ssd``."""
    if seq_parallel:
        return _seq_parallel_forward(cfg, mesh, params, x, positions,
                                     window=window, train=train, specs=specs,
                                     cache_len=cache_len)
    aux = _zero_aux(x.device)
    ks, vs = [], []
    blocks = _layers(params["blocks"], cfg.num_layers)
    if not cfg.uses_mamba:
        bspec = _sub(specs, "blocks")
        for bp in blocks:
            t0 = tracer.t()
            x, a, kv = _remat(cfg, train, lambda x, bp=bp: _attn_block(
                cfg, mesh, bp, bspec, x, positions, window=window,
                emit_cache=not train), x)
            if not train:
                kv = _kv_blocks(cfg, mesh, kv, cache_len)
            tracer.rec("model.attn", t0)
            aux = {n: aux[n] + a[n] for n in aux}
            if not train:
                ks.append(kv[0])
                vs.append(kv[1])
        if train:
            return x, aux, None
        return x, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
    states = []
    impl = S.ssd_chunked if train else _traced_scan(tracer)
    bspec = _sub(specs, "blocks")
    sspec = _sub(specs, "shared") if cfg.family == "hybrid" else None
    for i, bp in enumerate(blocks):
        t0 = tracer.t()
        x, st = _remat(cfg, train, lambda x, bp=bp: _mamba_block(
            cfg, bp, x, impl, mesh, bspec), x)
        if not train:
            states.append(_state_block(cfg, mesh, st))
        tracer.rec("model.mamba", t0)
        if _shared_after(cfg, i):
            # the hybrid's shared block runs as an attention block
            t0 = tracer.t()
            x, _, kv = _remat(cfg, train, lambda x: _attn_block(
                cfg, mesh, params["shared"], sspec, x, positions,
                window=window, emit_cache=not train), x)
            if not train:
                k, v = _kv_blocks(cfg, mesh, kv, cache_len)
                ks.append(k)
                vs.append(v)
            tracer.rec("model.attn", t0)
    if train:
        return x, aux, None
    return x, aux, _mamba_caches(cfg, states, ks, vs)


def _traced_scan(tracer):
    """The SSD scan kernel's entry point, each call a ``model.ssd`` span
    on ``tracer``; None (the default scan) without one."""
    if not tracer.enabled:
        return None

    def scan(*args, **kw):
        t0 = tracer.t()
        out = ssd_ops.ssd_scan(*args, **kw)
        tracer.rec("model.ssd", t0)
        return out
    return scan


def _mamba_caches(cfg, states, ks, vs):
    """The mamba families' caches: each layer's SSM state and conv tails,
    and the hybrid's shared-block K/V, stacked."""
    caches = _stack(states)
    if cfg.family == "hybrid":
        caches["k"] = torch.stack(ks) if ks else None
        caches["v"] = torch.stack(vs) if vs else None
    return caches


def _state_block(cfg, mesh, st):
    """One mamba layer's SSM state (B, H, N, P) and conv tails -> over a
    ``mesh``, the rank's blocks under ``sharding.cache_pspecs``: the
    state's heads and the x tail's channels where they divide ``model``
    (copies, so that no whole one outlives the layer); blocks already
    the rank's stay as they are.  Without a mesh, as they are."""
    if mesh is None:
        return st
    tp, me = mesh_lib.tp_size(mesh), mesh_lib.axis_index(mesh, "model")
    d_inner, _, n_heads, _, _ = S.mamba_dims(cfg)

    def mine(t, dim, n):
        if n % tp or t.shape[dim] != n:
            return t
        return t.narrow(dim, me * (n // tp), n // tp).clone()
    return {"ssm": mine(st["ssm"], 1, n_heads),
            "conv": dict(st["conv"], x=mine(st["conv"]["x"], 2, d_inner))}


# ---------------------------------------------------------------------------
# Tensor and expert parallelism over a mesh's ``model`` axis (FSDP x TP)
# ---------------------------------------------------------------------------

def _sub(specs, key):
    return None if specs is None else specs[key]


def _gathered_layer(bp, spec, key, mesh):
    """Layer subtree ``bp[key]`` with its ``data`` dims gathered (the
    ``model`` blocks stay the rank's): at use, so one weight at a time is
    whole along ``data``."""
    return mesh_lib.gather_layer(bp[key], _sub(spec, key), mesh)


def _tp_mlp(cfg, mesh, m, y, *, reduce=None, keep=None):
    """The MLP over the rank's block of the ``d_ff`` columns: ``w_in`` /
    ``w_gate`` column-parallel, ``w_out`` row-parallel
    (``attention.row_parallel``); whole weights (no mesh) give the plain
    MLP, ``layers.mlp_apply``."""
    cd = cfg.cdtype
    hmid = L.mlp_hidden(m, y, cfg.mlp_kind, compute_dtype=cd)
    return A.row_parallel(m["w_out"], hmid, cfg.d_ff, mesh, compute_dtype=cd,
                          reduce=reduce, keep=keep)


def _ep_moe(cfg, mesh, p, y, cf):
    """The MoE over the rank's ``E / tp`` experts (expert parallelism
    over ``model``, the reference's design, ``models/moe.py``): the router
    over every expert, so every ``model`` rank routes its rows as the
    no-mesh step does; each rank dispatches to and computes its own
    experts (``moe_apply_local`` at ``expert_offset = rank * E / tp``),
    and one ``psum`` over ``model`` sums their shares of each token's
    output, and their ``dropped`` counts.  Whole experts (no mesh): the
    plain MoE, ``moe.moe_apply``."""
    E = cfg.num_experts
    e_loc = p["w_in"].shape[0]
    split = e_loc != E
    off = mesh_lib.axis_index(mesh, "model") * e_loc if split else 0
    out, aux = M.moe_apply_local(
        p, y, num_experts_global=E, expert_offset=off, top_k=cfg.top_k,
        capacity_factor=cf, kind=cfg.mlp_kind, compute_dtype=cfg.cdtype)
    if split:
        out = mesh_lib.psum(out, mesh, "model")
        aux = dict(aux, dropped=mesh_lib.psum(aux["dropped"], mesh, "model"))
    return out, aux


def _attn_block(cfg, mesh, bp, spec, x, positions, *, window=None,
                emit_cache=False):
    """One attention block.  Without a mesh, on whole weights.  Over a
    mesh (FSDP x TP, as GSPMD partitions the reference's step from
    ``sharding._leaf_rule``'s placements): the residual stream ``x`` is
    replicated over ``model`` (each rank's batch rows); each weight's
    ``data`` dims are gathered at its use (``launch.mesh.gather_layer``,
    ``spec`` the stacked specs of ``params["blocks"]``); its ``model``
    block never leaves the rank.  Attention on the rank's heads
    (``attention.attn_apply``), the MLP on its ``d_ff`` columns or the
    MoE on its experts, each output summed over ``model``.  Under
    ``_remat`` a gathered weight lives for the layer's forward, and the
    backward gathers it again."""
    h, kv = A.attn_apply(
        _gathered_layer(bp, spec, "attn", mesh),
        L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps), positions, cfg,
        causal=cfg.causal, window=window, compute_dtype=cfg.cdtype,
        mesh=mesh)
    x = x + h
    y = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    key = "moe" if cfg.family == "moe" else "mlp"
    m, aux = _ffn(cfg, {key: _gathered_layer(bp, spec, key, mesh)}, y,
                  mesh=mesh)
    return x + m, aux, (kv if emit_cache else None)


# ---------------------------------------------------------------------------
# Sequence parallelism over a mesh's ``model`` axis
# ---------------------------------------------------------------------------

def _seq_span(x, mesh):
    """This rank's span of the sequence (dim 1), split over ``model``.
    Raises ``ValueError`` where ``model`` does not divide the sequence,
    as the reference's ``shard_map`` does."""
    tp = mesh_lib.tp_size(mesh)
    if x.shape[1] % tp:
        raise ValueError(f"sequence parallelism: the sequence length "
                         f"{x.shape[1]} is not evenly divisible by the "
                         f"mesh's 'model' axis of size {tp}")
    s_loc = x.shape[1] // tp
    return x.narrow(1, mesh_lib.axis_index(mesh, "model") * s_loc, s_loc)


def _w_only(bp, spec, key, names, mesh):
    """The ``w`` leaves of ``bp[key][name]`` for each of ``names``,
    gathered over ``data`` in turn (the Megatron-SP body reads nothing
    else, ROADMAP C8)."""
    return {n: {"w": mesh_lib.gather_layer(
        bp[key][n]["w"], None if spec is None else spec[key][n]["w"], mesh)}
        for n in names}


def _sp_dense_block(cfg, mesh, bp, spec, x):
    """One dense block under Megatron-style sequence parallelism (the
    reference's ``_seq_scan_dense`` body): the residual stream ``x`` (B,
    S_loc, D) is this rank's span, so norms and residuals stay local; the
    attention (this rank's heads; its KV heads when they divide the axis,
    else every KV head, each query head taking its group's) and the MLP
    (this rank's d_ff columns) run over the all-gathered sequence on the
    rank's ``model`` blocks of the weights, and their partial outputs are
    reduce-scattered back to spans.  Each weight is gathered over
    ``data`` at its use, in the reference's order (q, k, v, o, then
    w_in, w_gate, w_out); its ``w`` leaves only, as the reference reads
    (C8).  Whole weights (no ``spec``) compute every head and column on
    every rank, each keeping its span."""
    b, s_loc, _ = x.shape
    s = s_loc * mesh_lib.tp_size(mesh)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cd = cfg.cdtype

    def scatter(y):
        return mesh_lib.psum_scatter(y, mesh, "model", 1)

    def span(y):
        return _seq_span(y, mesh)

    g = mesh_lib.all_gather(L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps),
                            mesh, "model", 1).to(cd)
    a = _w_only(bp, spec, "attn", ("q", "k", "v", "o"), mesh)
    h, _ = A.attn_apply(a, g, positions, cfg, causal=cfg.causal,
                        compute_dtype=cd, mesh=mesh, chunked=True,
                        reduce=scatter, keep=span)
    x = x + h.to(x.dtype)
    g2 = mesh_lib.all_gather(L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps),
                             mesh, "model", 1).to(cd)
    names = (("w_in", "w_gate", "w_out")
             if cfg.mlp_kind in ("swiglu", "geglu") else ("w_in", "w_out"))
    m = _w_only(bp, spec, "mlp", names, mesh)
    return x + _tp_mlp(cfg, mesh, m, g2, reduce=scatter,
                       keep=span).to(x.dtype)


def _sp_mamba_block(cfg, mesh, bp, x):
    """One mamba block over this rank's span (``mamba2.mamba_apply_seq``,
    the reference's ``_seq_scan_mamba`` body)."""
    y, st = S.mamba_apply_seq(bp["mamba"],
                              L.rmsnorm_apply(bp["ln"], x, cfg.norm_eps),
                              cfg, mesh=mesh, chunk=cfg.ssd_chunk,
                              compute_dtype=cfg.cdtype)
    return x + y, st


def _seq_parallel_forward(cfg, mesh, params, x, positions, *, window=None,
                          train: bool = False, specs=None, cache_len=None):
    """The blocks with the sequence split over ``model``: each rank keeps
    its span of the residual stream through every dense block (Megatron
    SP) or mamba block (context-parallel SSD); the hybrid's shared block
    runs on the gathered sequence and each rank keeps its span of its
    output.  Returns the whole sequence (gathered) and, unless ``train``,
    the caches: the rank's blocks of the mamba layers' global states and
    conv tails and of the shared block's K/V over the sequence, as
    ``sharding.cache_pspecs`` places them (:func:`_state_block`,
    :func:`_kv_block`, each cut as its layer made it); the dense blocks
    keep no K/V (``None``, as the reference's ``_seq_scan_dense``
    returns)."""
    aux = _zero_aux(x.device)
    x = _seq_span(x, mesh)
    blocks = _layers(params["blocks"], cfg.num_layers)
    if not cfg.uses_mamba:
        bspec = _sub(specs, "blocks")
        for bp in blocks:
            x = _remat(cfg, train, lambda x, bp=bp: _sp_dense_block(
                cfg, mesh, bp, bspec, x), x)
        x = mesh_lib.all_gather(x, mesh, "model", 1)
        return x, aux, (None if train else {"k": None, "v": None})
    states, ks, vs = [], [], []
    for i, bp in enumerate(blocks):
        x, st = _remat(cfg, train, lambda x, bp=bp: _sp_mamba_block(
            cfg, mesh, bp, x), x)
        states.append(st if train else _state_block(cfg, mesh, st))
        if _shared_after(cfg, i):
            full = mesh_lib.all_gather(x, mesh, "model", 1)
            # the shared block on whole weights over the gathered sequence
            full, _, kv = _remat(cfg, train, lambda x: _attn_block(
                cfg, None, params["shared"], None, x, positions,
                window=window, emit_cache=not train), full)
            x = _seq_span(full, mesh)
            if not train:
                k, v = _kv_blocks(cfg, mesh, kv, cache_len)
                ks.append(k)
                vs.append(v)
    x = mesh_lib.all_gather(x, mesh, "model", 1)
    if train:
        return x, aux, None
    return x, aux, _mamba_caches(cfg, states, ks, vs)


def backbone(cfg, params, batch, *, window=None, train: bool = False,
             mesh=None, seq_parallel=False, specs=None, cache_len=None,
             tracer=NULL_TRACER):
    """-> (final normed hidden states, aux, caches, text offset).
    ``tracer``: per-layer spans (:func:`_stacked_forward`)."""
    x, positions, off = _embed_inputs(cfg, params, batch, mesh)
    x, aux, caches = _stacked_forward(cfg, params, x, positions,
                                      window=window, train=train, mesh=mesh,
                                      seq_parallel=seq_parallel, specs=specs,
                                      cache_len=cache_len, tracer=tracer)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x, aux, caches, off


def _logits(cfg, params, x, off: int = 0, mesh=None):
    """The head (audio's with its bias) over the positions from ``off``
    on: a vlm's text positions.  The head is row by row, so the rows are
    cut before it rather than after.  A head that holds the rank's block
    of the vocab over ``model`` gives that block's logits (the placement
    of ``sharding.logits_pspec``); a bias is whole on every rank, and the
    rank adds its block of it."""
    if off:
        x = x[:, off:]
    if cfg.family == "audio" or (not cfg.tie_embeddings
                                 and "lm_head" in params):
        p = params["lm_head"]
        if "b" in p and "w" in p and p["w"].shape[1] != p["b"].shape[0]:
            n = p["w"].shape[1]
            p = dict(p, b=p["b"].narrow(
                0, mesh_lib.axis_index(mesh, "model") * n, n))
        return L.dense_apply(p, x, compute_dtype=cfg.cdtype).float()
    return L.unembed_apply(params["embed"], x, cfg.cdtype)


def forward(cfg, params, batch, *, window=None, emit_caches=False,
            mesh=None, seq_parallel=False, specs=None, cache_len=None):
    """-> (logits float32, aux, caches or None); a vlm's logits cover its
    text positions only.  Over a mesh: ``specs`` are the placements of
    ``params`` (each leaf the rank's block; None for whole leaves), and
    the logits are the rank's vocab block where the head is split."""
    x, aux, caches, off = backbone(cfg, params, batch, window=window,
                                   mesh=mesh, seq_parallel=seq_parallel,
                                   specs=specs, cache_len=cache_len)
    return (_logits(cfg, params, x, off, mesh), aux,
            (caches if emit_caches else None))


def train_loss(cfg, params, batch, mesh=None, seq_parallel=False,
               specs=None):
    """-> (total loss, {"ce", "aux_loss", "router_z_loss", "dropped"}):
    the mean cross-entropy of ``batch["labels"]`` over the text positions
    (a vlm's logits start after its patches; audio's head has a bias),
    plus ``aux_loss_weight`` times the MoE router losses (zero for the
    other families).  Over a mesh the batch is the rank's rows and every
    rank returns the global batch's loss: vocab-parallel over ``model``
    (the plain head on the rank's rows for audio and, as in the reference,
    under the mamba families' sequence parallelism, whose vocab stays
    whole), the MoE router losses averaged over the batch axes (the mean
    of the shards' losses: ROADMAP C, divergences).  ``params`` may hold
    the rank's blocks, ``specs`` their placements (see :func:`forward`):
    the vocab-parallel loss then takes the rank's block of the head."""
    x, aux, _, off = backbone(cfg, params, batch, train=True, mesh=mesh,
                              seq_parallel=seq_parallel, specs=specs)
    if off:
        x = x[:, off:]
    if cfg.family == "audio" or (seq_parallel and cfg.uses_mamba):
        logits = _logits(cfg, params, x, mesh=mesh)
        if mesh is not None:
            logits = A.whole_cols(logits, cfg.vocab_size, mesh)
        loss = losses.plain_ce(logits, batch["labels"], cfg.z_loss)
        if mesh is not None:
            loss = mesh_lib.pmean(loss, mesh, mesh_lib.batch_axes(mesh))
    else:
        tied = cfg.tie_embeddings
        w = params["embed"]["table"] if tied else params["lm_head"]["w"]
        loss = losses.vocab_parallel_ce(x, w, batch["labels"], mesh=mesh,
                                        tied=tied, vocab=cfg.vocab_size,
                                        z_loss=cfg.z_loss,
                                        compute_dtype=cfg.cdtype)
    if mesh is not None and cfg.family == "moe":
        baxes = mesh_lib.batch_axes(mesh)
        aux = {k: (mesh_lib.psum if k == "dropped" else mesh_lib.pmean)(
            v, mesh, baxes) for k, v in aux.items()}
    total = loss + cfg.aux_loss_weight * (aux["aux_loss"]
                                          + aux["router_z_loss"])
    return total, {"ce": loss, **aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV / SSM caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict[str, Any]:
    """Zeroed caches on ``device`` (the card unless the caller asks for
    the CPU; a card asked for and absent raises): K/V in ``dtype`` for the
    attention layers, float32 SSM states and ``dtype`` conv tails for the
    mamba layers."""
    return _cache(cfg, batch_size, max_len, dtype, resolve_device(device))


def cache_spec(cfg, batch_size: int, max_len: int,
               dtype=torch.bfloat16) -> dict[str, Any]:
    """:func:`init_cache`'s tree as ``meta`` tensors, ``len`` an int32
    0-dim one as in the reference: the shapes and dtypes, nothing
    allocated."""
    c = _cache(cfg, batch_size, max_len, dtype, torch.device("meta"))
    c["len"] = torch.empty((), dtype=torch.int32, device="meta")
    return c


def _cache(cfg, batch_size, max_len, dtype, device) -> dict[str, Any]:
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    c: dict[str, Any] = {"len": 0}
    # the hybrid's shared block caches K/V once per application
    n_attn = (cfg.num_layers if cfg.family in ("dense", "moe", "vlm",
                                               "audio") else
              cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
              else 0)
    if n_attn:
        c["k"] = zeros(n_attn, batch_size, max_len, cfg.num_kv_heads,
                       cfg.head_dim)
        c["v"] = zeros(n_attn, batch_size, max_len, cfg.num_kv_heads,
                       cfg.head_dim)
    if cfg.uses_mamba:
        d_inner, pdim, nh, g, n = S.mamba_dims(cfg)
        lr, w = cfg.num_layers, S.CONV_W - 1
        c["ssm"] = zeros(lr, batch_size, nh, n, pdim, dt=torch.float32)
        c["conv"] = {"x": zeros(lr, batch_size, w, d_inner),
                     "B": zeros(lr, batch_size, w, g * n),
                     "C": zeros(lr, batch_size, w, g * n)}
    return c


def _write_caches(cache, caches, rows: slice, s: int) -> None:
    """A forward pass's caches into the batch rows ``rows`` of ``cache``,
    in place: K/V at positions ``< s``, SSM states and conv tails whole."""
    if caches.get("k") is not None:
        cache["k"][:, rows, :s] = caches["k"].to(cache["k"].dtype)
        cache["v"][:, rows, :s] = caches["v"].to(cache["v"].dtype)
    if caches.get("ssm") is not None:
        cache["ssm"][:, rows] = caches["ssm"].to(cache["ssm"].dtype)
        for name, t in caches["conv"].items():
            cache["conv"][name][:, rows] = t.to(cache["conv"][name].dtype)


def prefill(cfg, params, batch, max_len: int | None = None, *, window=None,
            mesh=None, seq_parallel=False, specs=None):
    """Full-sequence forward emitting caches sized to ``max_len``; the
    fill level counts a vlm's patch positions.  Over a mesh (see
    :func:`forward`) the cache is the rank's blocks under
    ``sharding.cache_pspecs``, which the mesh decode takes as they are:
    an attention family's K/V (:func:`_kv_block`), and a mamba family's
    SSM states, conv tails and shared-block K/V (:func:`_state_block`),
    in either sharding mode."""
    s = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[1]
    if cfg.family == "vlm":
        s += batch["patch_embeds"].shape[1]
    logits, _, caches = forward(cfg, params, batch, window=window,
                                emit_caches=True, mesh=mesh,
                                seq_parallel=seq_parallel, specs=specs,
                                cache_len=max_len or s)
    if mesh is not None and cfg.uses_mamba:
        cache = dict(caches)
        if cfg.family == "hybrid" and cache["k"] is None:
            # no shared-block application: an empty stack of K/V blocks
            empty = _kv_block(cfg, mesh, logits.new_zeros(
                (logits.shape[0], 0, cfg.num_kv_heads, cfg.head_dim)),
                max_len or s)[None][:0]
            cache["k"] = cache["v"] = empty
    elif mesh is not None and caches.get("k") is not None:
        cache = {"k": caches["k"], "v": caches["v"]}
    else:
        # on the logits' own device (already a resolved one)
        cache = _cache(cfg, logits.shape[0], max_len or s, cfg.cdtype,
                       logits.device)
        _write_caches(cache, caches, slice(None), s)
    cache["len"] = s
    return logits, cache


def _kv_blocks(cfg, mesh, kv, cache_len):
    """One layer's (k, v): over a ``mesh``, each cut to the rank's block of
    a ``cache_len``-position cache (:func:`_kv_block`; the sequence's own
    length by default); without one, as they are."""
    if mesh is None:
        return kv
    return tuple(_kv_block(cfg, mesh, t, cache_len or t.shape[1])
                 for t in kv)


def _kv_block(cfg, mesh, t, max_len: int):
    """One layer's K or V (B, s, kv, hd) of the rank's rows -> its block
    of a ``max_len``-position cache as ``sharding.cache_pspecs`` places
    it, in the cache dtype: its KV heads when they divide ``model`` (cut
    from every head when the rank computed them all), else its span of
    the positions when ``max_len`` divides, else the whole cache."""
    tp, me = mesh_lib.tp_size(mesh), mesh_lib.axis_index(mesh, "model")
    KV = cfg.num_kv_heads
    s = t.shape[1]
    p0, n = 0, max_len
    if KV % tp == 0:
        if t.shape[2] == KV:
            t = t.narrow(2, me * (KV // tp), KV // tp)
    elif max_len % tp == 0:
        n = max_len // tp
        p0 = me * n
    c = torch.zeros((t.shape[0], n) + t.shape[2:], dtype=cfg.cdtype,
                    device=t.device)
    m = max(0, min(s, p0 + n) - p0)
    if m:
        c[:, :m] = t[:, p0:p0 + m].to(c.dtype)
    return c


def _mamba_decode_layer(cfg, bp, cache, i: int, x, active, mesh=None):
    """Mamba layer ``i`` of a decode step; its SSM state and conv tail are
    written in place, an inactive row's (``active`` False) bit for bit as
    it was.  Over a ``mesh``, on the rank's heads (``mamba2.mamba_decode``)
    and its blocks of the cache."""
    h = L.rmsnorm_apply(bp["ln"], x, cfg.norm_eps)
    conv = {k: t[i] for k, t in cache["conv"].items()}
    ssm = cache["ssm"][i]
    y, nconv, nssm = S.mamba_decode(bp["mamba"], h, conv, ssm, cfg,
                                    compute_dtype=cfg.cdtype, mesh=mesh)
    if active is not None:
        nconv = {k: torch.where(active[:, None, None], nconv[k], conv[k])
                 for k in conv}
        nssm = torch.where(active[:, None, None, None], nssm, ssm)
    ssm.copy_(nssm)
    for k, t in conv.items():
        t.copy_(nconv[k])
    return x + y


def _decode_blocks(cfg, params, cache, x, attend, active=None, mesh=None,
                   specs=None, tracer=NULL_TRACER):
    """Every block of one decode step; ``attend(p, h, ck, cv)`` is the
    attention decode over one layer's K/V cache.  Over a ``mesh`` each
    layer's ``data`` dims are gathered for the layer (the hybrid's shared
    block's at each application), and it runs on the rank's ``model``
    blocks: its heads (attention, mamba) and its FFN's (:func:`_ffn`).
    ``tracer``: each layer's host time as a ``model.mamba`` or
    ``model.attn`` span."""
    eps = cfg.norm_eps
    bspec = _sub(specs, "blocks")
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        if mesh is not None:
            bp = mesh_lib.gather_layer(bp, bspec, mesh)
        if cfg.uses_mamba:
            t0 = tracer.t()
            x = _mamba_decode_layer(cfg, bp, cache, i, x, active, mesh)
            tracer.rec("model.mamba", t0)
            if not _shared_after(cfg, i):
                continue
            bp, gi = params["shared"], (i + 1) // cfg.attn_every - 1
            if mesh is not None:
                bp = mesh_lib.gather_layer(bp, _sub(specs, "shared"), mesh)
        else:
            gi = i
        t0 = tracer.t()
        h = L.rmsnorm_apply(bp["ln1"], x, eps)
        h, _, _ = attend(bp["attn"], h, cache["k"][gi], cache["v"][gi])
        x = x + h
        y = L.rmsnorm_apply(bp["ln2"], x, eps)
        x = x + _ffn(cfg, bp, y, decode=True, mesh=mesh)[0]
        tracer.rec("model.attn", t0)
    return L.rmsnorm_apply(params["final_norm"], x, eps)


def decode_step(cfg, params, cache, tokens, *, window=None, mesh=None,
                splitkv=False, specs=None):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, cache).  The new K/V,
    SSM states and conv tails land in the cache tensors in place; ``len``
    advances by one.  A vlm decodes as ``dense``; audio, an encoder, has
    no decode path and raises ``ValueError``.  ``splitkv`` (with a mesh):
    the K/V cache holds this rank's span of the sequence, and the
    attention layers (the hybrid's shared block too) decode by
    ``attention.attn_decode_splitkv``, whose softmax merges the spans
    over ``model``.  Otherwise, over a mesh, the attention layers decode
    on the rank's heads (``attention.attn_decode``) over its cache block
    by KV heads, or over every KV head of a whole cache.  The mamba
    layers decode on the rank's heads over its blocks of the SSM state
    and conv tail.  ``params`` and ``specs`` as in :func:`forward`.  The
    logits come back whole over the vocab (the head's vocab blocks
    gathered over ``model``)."""
    if cfg.family == "audio":
        raise ValueError(f"no decode path for family {cfg.family!r}")
    clen = cache["len"]
    x = _embed(cfg, params, tokens, mesh)
    if splitkv:
        def attend(p, h, ck, cv):
            return A.attn_decode_splitkv(p, h, ck, cv, clen, cfg, mesh=mesh,
                                         window=window,
                                         compute_dtype=cfg.cdtype)
    else:
        def attend(p, h, ck, cv):
            return A.attn_decode(p, h, ck, cv, clen, cfg, window=window,
                                 compute_dtype=cfg.cdtype, mesh=mesh)
    x = _decode_blocks(cfg, params, cache, x, attend, mesh=mesh, specs=specs)
    logits = _logits(cfg, params, x, mesh=mesh)
    if mesh is not None:
        logits = A.whole_cols(logits, cfg.vocab_size, mesh)
    return logits, dict(cache, len=clen + 1)


# ---------------------------------------------------------------------------
# Slotted caches: per-slot fill levels for continuous batching
# (serve/engine.py rides serve/scheduler.SlotScheduler over these)
# ---------------------------------------------------------------------------

def init_slot_cache(cfg, n_slots: int, max_len: int, dtype=torch.bfloat16,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """The :func:`init_cache` layout with a per-slot fill level
    ``pos`` ((S,) int32) in place of the shared ``len``."""
    device = resolve_device(device)
    c = init_cache(cfg, n_slots, max_len, dtype, device)
    del c["len"]
    c["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return c


def reset_cache_slot(cfg, cache, slot: int):
    """Zero one slot's cache rows (K/V, SSM state, conv tail: the SSM
    carry is additive) and fill level, in place; returns the cache."""
    cache["pos"][slot] = 0
    for name in ("k", "v", "ssm"):
        if cache.get(name) is not None:
            cache[name][:, slot] = 0
    for t in cache.get("conv", {}).values():
        t[:, slot] = 0
    return cache


def prefill_into_slot(cfg, params, cache, batch, slot: int, *, window=None,
                      return_hidden=False, tracer=NULL_TRACER):
    """Prefill ONE sequence (leading batch dim 1) and write its caches into
    row ``slot`` of a slotted cache, in place, leaving the other rows as
    they are: K/V up to the prompt's length, the SSM state and conv tail
    whole.  Returns ``(logits (1, s, V) float32, cache)``, or the final
    normed hidden states ``(1, s, D)`` with ``return_hidden=True`` (the
    quantized-head engine applies its own head).  ``tracer``: per-layer
    spans (:func:`_stacked_forward`)."""
    x, _, caches, off = backbone(cfg, params, batch, window=window,
                                 tracer=tracer)
    out = x if return_hidden else _logits(cfg, params, x, off)
    s = x.shape[1]                       # a vlm's patch positions included
    _write_caches(cache, caches, slice(slot, slot + 1), s)
    cache["pos"][slot] = s
    return out, cache


def decode_step_slotted(cfg, params, cache, tokens, active=None, *,
                        window=None, return_hidden=False,
                        tracer=NULL_TRACER):
    """One decode tick over a slotted cache.  tokens: (S, 1) ->
    ``(logits (S, 1, V) float32, cache)``, or the final normed hidden
    states ``(S, 1, D)`` with ``return_hidden=True``.

    Every slot advances at its own ``cache["pos"][b]``.  ``active``: (S,)
    bool; inactive slots keep their cache rows (K/V, SSM state, conv tail)
    and ``pos`` bit for bit (their outputs are computed and discarded, so
    a tick has one shape whatever the occupancy).  Every cache tensor,
    ``pos`` included, is written in place and the cache dict returned is
    the one given: a tick reads and writes the same addresses every time,
    as a CUDA graph of it needs (``serve/engine.py``).  Audio has no
    decode path and raises ``ValueError``.  ``tracer``: per-layer spans
    (:func:`_decode_blocks`)."""
    if cfg.family == "audio":
        raise ValueError(f"no slotted decode path for family "
                         f"{cfg.family!r}")
    pos = cache["pos"]
    if active is None:
        active = torch.ones((tokens.shape[0],), dtype=torch.bool,
                            device=tokens.device)
    active = active.to(torch.bool)
    x = L.embed_apply(params["embed"], tokens, cfg.cdtype)
    x = _decode_blocks(cfg, params, cache, x, lambda p, h, ck, cv:
                       A.attn_decode_slotted(p, h, ck, cv, pos, cfg,
                                             active=active, window=window,
                                             compute_dtype=cfg.cdtype),
                       active, tracer=tracer)
    pos.add_(active.to(torch.int32))
    if return_hidden:
        return x, cache
    return _logits(cfg, params, x), cache
