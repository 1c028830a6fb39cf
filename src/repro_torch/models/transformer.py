"""LM assembly (reference ``repro.models.transformer``) for the families
ported so far:

  dense : [rmsnorm -> GQA attention -> rmsnorm -> MLP] x L
  moe   : [rmsnorm -> GQA attention -> rmsnorm -> MoE] x L
  ssm   : [rmsnorm -> Mamba-2] x L
  hybrid: the Mamba-2 backbone with ONE shared attention + MLP block
          applied after every ``attn_every`` mamba layers (zamba2)

Parameters are a nested dict of tensors; the per-layer parameters are
stacked with a leading L axis (``params["blocks"]``), as the reference
stacks them, and a Python loop over the layers takes the place of
``lax.scan``.  Every mamba block's full-sequence scan goes through the SSD
scan kernel's entry point (``kernels.ssd_scan.ops.ssd_scan``, the
reference's ``ssm_impl`` seam).  A ``moe`` block's FFN is
``models.moe.moe_apply``: at ``cfg.capacity_factor`` over a full
sequence (a prefill may drop tokens, as the reference's does) and at
``num_experts / top_k`` in both decode paths, which never drops.  Serving
keeps the reference's cache layouts: ``(L, B, S_max, KV, hd)`` K/V
(``(n_groups, ...)`` for the hybrid shared block), ``(L, B, H, N, P)``
float32 SSM states and ``(L, B, 3, width)`` conv tails, with one shared
fill level ``len`` (a Python int here) or, for continuous batching, a
per-slot fill level ``pos`` ((S,) int32 tensor).  Decode writes the cache
tensors in place and returns the cache dict; an inactive slot keeps its
cache rows and ``pos`` bit for bit.

The other families are not ported yet and raise ``NotImplementedError``:
``vlm`` and ``audio`` (ROADMAP A9.2, their frontends and heads).
Sequence parallelism, meshes and remat belong with training and
``launch/`` (A10).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.pytree import tree_map
from . import attention as A
from . import layers as L
from . import mamba2 as S
from . import moe as M

_PORTED = ("dense", "moe", "ssm", "hybrid")
_NOT_PORTED = {
    "vlm": "ROADMAP A9.2: the vlm patch-embedding frontend",
    "audio": "ROADMAP A9.2: the audio encoder and its frame head",
}


def require_ported(cfg) -> None:
    """Raise for every family but ``dense``, ``moe``, ``ssm`` and
    ``hybrid``, naming its ROADMAP item."""
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED.get(cfg.family, 'ROADMAP A9')}")


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
    PRNG is not reproduced)."""
    require_ported(cfg)
    dt, dev = cfg.pdtype, generator.device
    p: dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dt)}
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
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dtype=dt)
    return p


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg, bp, y, *, decode: bool = False):
    """The block's MLP, or its MoE: -> (out, aux).  A full sequence routes
    at ``cfg.capacity_factor``; the decode paths at ``num_experts /
    top_k``, which gives every expert room for every token, so serving
    never drops one."""
    if cfg.family == "moe":
        cf = cfg.num_experts / cfg.top_k if decode else cfg.capacity_factor
        return M.moe_apply(bp["moe"], y, top_k=cfg.top_k, capacity_factor=cf,
                           kind=cfg.mlp_kind, compute_dtype=cfg.cdtype)
    return (L.mlp_apply(bp["mlp"], y, cfg.mlp_kind, compute_dtype=cfg.cdtype),
            _zero_aux(y.device))


def _attn_block(cfg, bp, x, positions, *, window=None, emit_cache=False):
    h, kv = A.attn_apply(bp["attn"], L.rmsnorm_apply(bp["ln1"], x,
                                                     cfg.norm_eps),
                         positions, cfg, causal=cfg.causal, window=window,
                         compute_dtype=cfg.cdtype)
    x = x + h
    y = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    m, aux = _ffn(cfg, bp, y)
    return x + m, aux, (kv if emit_cache else None)


def _mamba_block(cfg, bp, x):
    """One mamba layer; its scan runs through the SSD scan kernel."""
    y, state = S.mamba_apply(bp["mamba"],
                             L.rmsnorm_apply(bp["ln"], x, cfg.norm_eps), cfg,
                             chunk=cfg.ssd_chunk, compute_dtype=cfg.cdtype,
                             ssm_impl=ssd_ops.ssd_scan)
    return x + y, state


def _shared_block(cfg, sp, x, positions, *, window=None):
    h, kv = A.attn_apply(sp["attn"], L.rmsnorm_apply(sp["ln1"], x,
                                                     cfg.norm_eps),
                         positions, cfg, causal=True, window=window,
                         compute_dtype=cfg.cdtype)
    x = x + h
    m = L.mlp_apply(sp["mlp"], L.rmsnorm_apply(sp["ln2"], x, cfg.norm_eps),
                    cfg.mlp_kind, compute_dtype=cfg.cdtype)
    return x + m, kv


def _zero_aux(device):
    """The reference's two router losses, and the count of (token, expert)
    assignments dropped past capacity (``models.moe``)."""
    return {"aux_loss": torch.zeros((), device=device),
            "router_z_loss": torch.zeros((), device=device),
            "dropped": torch.zeros((), dtype=torch.int64, device=device)}


def _embed_inputs(cfg, params, batch):
    """-> (x (B, S, D), positions (B, S), text offset 0)."""
    x = L.embed_apply(params["embed"], batch["tokens"], cfg.cdtype)
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, pos, 0


def _stacked_forward(cfg, params, x, positions, *, window=None):
    """Every block in turn.  Returns (x, aux, caches): K/V stacked as (L,
    B, S, KV, hd) (dense; (n_groups, ...) for the hybrid's shared block),
    SSM states as (L, B, H, N, P) and conv tails as (L, B, 3, width)."""
    aux = _zero_aux(x.device)
    ks, vs = [], []
    if not cfg.uses_mamba:
        for i in range(cfg.num_layers):
            x, a, (k, v) = _attn_block(cfg, layer(params["blocks"], i), x,
                                       positions, window=window,
                                       emit_cache=True)
            aux = {n: aux[n] + a[n] for n in aux}
            ks.append(k)
            vs.append(v)
        return x, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
    states = []
    for i in range(cfg.num_layers):
        x, st = _mamba_block(cfg, layer(params["blocks"], i), x)
        states.append(st)
        if _shared_after(cfg, i):
            x, (k, v) = _shared_block(cfg, params["shared"], x, positions,
                                      window=window)
            ks.append(k)
            vs.append(v)
    caches = _stack(states)
    if cfg.family == "hybrid":
        caches["k"] = torch.stack(ks) if ks else None
        caches["v"] = torch.stack(vs) if vs else None
    return x, aux, caches


def backbone(cfg, params, batch, *, window=None):
    """-> (final normed hidden states, aux, caches, text offset)."""
    require_ported(cfg)
    x, positions, off = _embed_inputs(cfg, params, batch)
    x, aux, caches = _stacked_forward(cfg, params, x, positions,
                                      window=window)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x, aux, caches, off


def _logits(cfg, params, x):
    if not cfg.tie_embeddings and "lm_head" in params:
        return L.dense_apply(params["lm_head"], x,
                             compute_dtype=cfg.cdtype).float()
    return L.unembed_apply(params["embed"], x, cfg.cdtype)


def forward(cfg, params, batch, *, window=None, emit_caches=False):
    """-> (logits float32, aux, caches or None)."""
    x, aux, caches, _ = backbone(cfg, params, batch, window=window)
    return _logits(cfg, params, x), aux, (caches if emit_caches else None)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV / SSM caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict[str, Any]:
    """Zeroed caches on ``device`` (the card unless the caller asks for
    the CPU; a card asked for and absent raises): K/V in ``dtype`` for the
    attention layers, float32 SSM states and ``dtype`` conv tails for the
    mamba layers."""
    require_ported(cfg)
    device = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    c: dict[str, Any] = {"len": 0}
    # the hybrid's shared block caches K/V once per application
    n_attn = (cfg.num_layers if cfg.family in ("dense", "moe") else
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


def prefill(cfg, params, batch, max_len: int | None = None, *, window=None):
    """Full-sequence forward emitting caches sized to ``max_len``."""
    logits, _, caches = forward(cfg, params, batch, window=window,
                                emit_caches=True)
    b, s = batch["tokens"].shape
    cache = init_cache(cfg, b, max_len or s, dtype=cfg.cdtype,
                       device=logits.device)
    _write_caches(cache, caches, slice(None), s)
    cache["len"] = s
    return logits, cache


def _mamba_decode_layer(cfg, bp, cache, i: int, x, active):
    """Mamba layer ``i`` of a decode step; its SSM state and conv tail are
    written in place, an inactive row's (``active`` False) bit for bit as
    it was."""
    h = L.rmsnorm_apply(bp["ln"], x, cfg.norm_eps)
    conv = {k: t[i] for k, t in cache["conv"].items()}
    ssm = cache["ssm"][i]
    y, nconv, nssm = S.mamba_decode(bp["mamba"], h, conv, ssm, cfg,
                                    compute_dtype=cfg.cdtype)
    if active is not None:
        nconv = {k: torch.where(active[:, None, None], nconv[k], conv[k])
                 for k in conv}
        nssm = torch.where(active[:, None, None, None], nssm, ssm)
    ssm.copy_(nssm)
    for k, t in conv.items():
        t.copy_(nconv[k])
    return x + y


def _decode_blocks(cfg, params, cache, x, attend, active=None):
    """Every block of one decode step; ``attend(p, h, ck, cv)`` is the
    attention decode over one layer's K/V cache."""
    eps = cfg.norm_eps
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        if cfg.uses_mamba:
            x = _mamba_decode_layer(cfg, bp, cache, i, x, active)
            if not _shared_after(cfg, i):
                continue
            bp, gi = params["shared"], (i + 1) // cfg.attn_every - 1
        else:
            gi = i
        h = L.rmsnorm_apply(bp["ln1"], x, eps)
        h, _, _ = attend(bp["attn"], h, cache["k"][gi], cache["v"][gi])
        x = x + h
        y = L.rmsnorm_apply(bp["ln2"], x, eps)
        x = x + _ffn(cfg, bp, y, decode=True)[0]
    return L.rmsnorm_apply(params["final_norm"], x, eps)


def decode_step(cfg, params, cache, tokens, *, window=None):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, cache).  The new K/V,
    SSM states and conv tails land in the cache tensors in place; ``len``
    advances by one."""
    require_ported(cfg)
    clen = cache["len"]
    x = L.embed_apply(params["embed"], tokens, cfg.cdtype)
    x = _decode_blocks(cfg, params, cache, x, lambda p, h, ck, cv:
                       A.attn_decode(p, h, ck, cv, clen, cfg, window=window,
                                     compute_dtype=cfg.cdtype))
    return _logits(cfg, params, x), dict(cache, len=clen + 1)


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
                      return_hidden=False):
    """Prefill ONE sequence (leading batch dim 1) and write its caches into
    row ``slot`` of a slotted cache, in place, leaving the other rows as
    they are: K/V up to the prompt's length, the SSM state and conv tail
    whole.  Returns ``(logits (1, s, V) float32, cache)``, or the final
    normed hidden states ``(1, s, D)`` with ``return_hidden=True`` (the
    quantized-head engine applies its own head)."""
    x, _, caches, _ = backbone(cfg, params, batch, window=window)
    out = x if return_hidden else _logits(cfg, params, x)
    s = x.shape[1]
    _write_caches(cache, caches, slice(slot, slot + 1), s)
    cache["pos"][slot] = s
    return out, cache


def decode_step_slotted(cfg, params, cache, tokens, active=None, *,
                        window=None, return_hidden=False):
    """One decode tick over a slotted cache.  tokens: (S, 1) ->
    ``(logits (S, 1, V) float32, cache)``, or the final normed hidden
    states ``(S, 1, D)`` with ``return_hidden=True``.

    Every slot advances at its own ``cache["pos"][b]``.  ``active``: (S,)
    bool; inactive slots keep their cache rows (K/V, SSM state, conv tail)
    and ``pos`` bit for bit (their outputs are computed and discarded, so
    a tick has one shape whatever the occupancy)."""
    require_ported(cfg)
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
                       active)
    cache = dict(cache, pos=pos + active.to(torch.int32))
    if return_hidden:
        return x, cache
    return _logits(cfg, params, x), cache
