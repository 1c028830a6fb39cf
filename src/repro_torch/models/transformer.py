"""LM assembly, ``dense`` family (reference ``repro.models.transformer``):

  dense : [rmsnorm -> GQA attention -> rmsnorm -> MLP] x L

Parameters are a nested dict of tensors; the per-layer parameters are
stacked with a leading L axis (``params["blocks"]``), as the reference
stacks them, and a Python loop over the layers takes the place of
``lax.scan``.  Serving keeps the reference's cache layouts: ``(L, B,
S_max, KV, hd)`` K/V with one shared fill level ``len`` (a Python int
here) or, for continuous batching, a per-slot fill level ``pos`` ((S,)
int32 tensor).  Decode writes the cache tensors in place and returns the
cache dict; an inactive slot keeps its cache rows and ``pos`` bit for bit.

The other families are not ported yet and raise ``NotImplementedError``:
``moe`` (ROADMAP A9, ``models/moe.py``), ``ssm`` and ``hybrid`` (A9,
``models/mamba2.py``, with the SSD scan kernel B6), ``vlm`` and ``audio``
(A9, their frontends and heads).  Sequence parallelism, meshes and remat
belong with training and ``launch/`` (A10).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.pytree import tree_map
from . import attention as A
from . import layers as L

_NOT_PORTED = {
    "moe": "ROADMAP A9: models/moe.py",
    "ssm": "ROADMAP A9: models/mamba2.py (with the SSD scan kernel, B6)",
    "hybrid": "ROADMAP A9: models/mamba2.py (with the SSD scan kernel, B6)",
    "vlm": "ROADMAP A9: the vlm patch-embedding frontend",
    "audio": "ROADMAP A9: the audio encoder and its frame head",
}


def require_dense(cfg) -> None:
    """Raise for every family but ``dense``, naming its ROADMAP item."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED.get(cfg.family, 'ROADMAP A9')}")


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree: views, no copy."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(cfg, generator):
    dt, dev = cfg.pdtype, generator.device
    return {"ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
            "attn": A.attn_init(generator, cfg.d_model, cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim,
                                qkv_bias=cfg.qkv_bias, dtype=dt),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                              rank=cfg.lsq_rank, dtype=dt)}


def init(cfg, generator: torch.Generator) -> dict[str, Any]:
    """Parameters with the reference's leaf names, shapes and dtypes, drawn
    from ``generator`` on its device (not the reference's values: JAX's
    PRNG is not reproduced)."""
    require_dense(cfg)
    p: dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model,
                              cfg.pdtype)}
    p["blocks"] = tree_map(lambda *ls: torch.stack(ls),
                           *[_block_init(cfg, generator)
                             for _ in range(cfg.num_layers)])
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, cfg.pdtype,
                                     generator.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dtype=cfg.pdtype)
    return p


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _attn_block(cfg, bp, x, positions, *, window=None, emit_cache=False):
    h, kv = A.attn_apply(bp["attn"], L.rmsnorm_apply(bp["ln1"], x,
                                                     cfg.norm_eps),
                         positions, cfg, causal=cfg.causal, window=window,
                         compute_dtype=cfg.cdtype)
    x = x + h
    y = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    m = L.mlp_apply(bp["mlp"], y, cfg.mlp_kind, compute_dtype=cfg.cdtype)
    return x + m, _zero_aux(x.device), (kv if emit_cache else None)


def _zero_aux(device):
    return {"aux_loss": torch.zeros((), device=device),
            "router_z_loss": torch.zeros((), device=device)}


def _embed_inputs(cfg, params, batch):
    """-> (x (B, S, D), positions (B, S), text offset 0)."""
    x = L.embed_apply(params["embed"], batch["tokens"], cfg.cdtype)
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, pos, 0


def _stacked_forward(cfg, params, x, positions, *, window=None):
    """Every block in turn.  Returns (x, aux, caches) with the caches'
    K/V stacked as (L, B, S, KV, hd)."""
    aux = _zero_aux(x.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, a, (k, v) = _attn_block(cfg, layer(params["blocks"], i), x,
                                   positions, window=window, emit_cache=True)
        aux = {n: aux[n] + a[n] for n in aux}
        ks.append(k)
        vs.append(v)
    return x, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}


def backbone(cfg, params, batch, *, window=None):
    """-> (final normed hidden states, aux, caches, text offset)."""
    require_dense(cfg)
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
# Serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict[str, Any]:
    """Zeroed K/V caches on ``device`` (the card unless the caller asks
    for the CPU; a card asked for and absent raises)."""
    require_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"len": 0, "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(cfg, params, batch, max_len: int | None = None, *, window=None):
    """Full-sequence forward emitting caches sized to ``max_len``."""
    logits, _, caches = forward(cfg, params, batch, window=window,
                                emit_caches=True)
    b, s = batch["tokens"].shape
    cache = init_cache(cfg, b, max_len or s, dtype=cfg.cdtype,
                       device=logits.device)
    cache["k"][:, :, :s] = caches["k"].to(cache["k"].dtype)
    cache["v"][:, :, :s] = caches["v"].to(cache["v"].dtype)
    cache["len"] = s
    return logits, cache


def _decode_blocks(cfg, params, cache, x, attend):
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        h, _, _ = attend(bp["attn"], h, cache["k"][i], cache["v"][i])
        x = x + h
        y = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(bp["mlp"], y, cfg.mlp_kind,
                            compute_dtype=cfg.cdtype)
    return L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)


def decode_step(cfg, params, cache, tokens, *, window=None):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, cache).  The new K/V
    land in the cache tensors in place; ``len`` advances by one."""
    require_dense(cfg)
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
    c = init_cache(cfg, n_slots, max_len, dtype, device)
    del c["len"]
    c["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                           device=c["k"].device)
    return c


def reset_cache_slot(cfg, cache, slot: int):
    """Zero one slot's K/V rows and fill level, in place; returns the
    cache."""
    cache["pos"][slot] = 0
    cache["k"][:, slot] = 0
    cache["v"][:, slot] = 0
    return cache


def prefill_into_slot(cfg, params, cache, batch, slot: int, *, window=None,
                      return_hidden=False):
    """Prefill ONE sequence (leading batch dim 1) and write its K/V into
    row ``slot`` of a slotted cache, in place, leaving the other rows as
    they are.  Returns ``(logits (1, s, V) float32, cache)``, or the final
    normed hidden states ``(1, s, D)`` with ``return_hidden=True`` (the
    quantized-head engine applies its own head)."""
    x, _, caches, _ = backbone(cfg, params, batch, window=window)
    out = x if return_hidden else _logits(cfg, params, x)
    s = x.shape[1]
    cache["k"][:, slot, :s] = caches["k"][:, 0].to(cache["k"].dtype)
    cache["v"][:, slot, :s] = caches["v"][:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = s
    return out, cache


def decode_step_slotted(cfg, params, cache, tokens, active=None, *,
                        window=None, return_hidden=False):
    """One decode tick over a slotted cache.  tokens: (S, 1) ->
    ``(logits (S, 1, V) float32, cache)``, or the final normed hidden
    states ``(S, 1, D)`` with ``return_hidden=True``.

    Every slot advances at its own ``cache["pos"][b]``.  ``active``: (S,)
    bool; inactive slots keep their cache rows and ``pos`` bit for bit
    (their outputs are computed and discarded, so a tick has one shape
    whatever the occupancy)."""
    require_dense(cfg)
    pos = cache["pos"]
    if active is None:
        active = torch.ones((tokens.shape[0],), dtype=torch.bool,
                            device=tokens.device)
    active = active.to(torch.bool)
    x = L.embed_apply(params["embed"], tokens, cfg.cdtype)
    x = _decode_blocks(cfg, params, cache, x, lambda p, h, ck, cv:
                       A.attn_decode_slotted(p, h, ck, cv, pos, cfg,
                                             active=active, window=window,
                                             compute_dtype=cfg.cdtype))
    cache = dict(cache, pos=pos + active.to(torch.int32))
    if return_hidden:
        return x, cache
    return _logits(cfg, params, x), cache
