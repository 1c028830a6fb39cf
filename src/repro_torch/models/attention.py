"""Grouped-query attention: full-sequence (causal, sliding-window or
bidirectional) and serving (prefill -> KV cache -> single-token decode),
reference ``repro.models.attention``.

The attention math is plain torch, written op for op like the reference
(the reference computes it outside any Pallas kernel, so it is no kernel
of the port): scores in float32, ``-1e30`` masks, float32 softmax, and the
flash-style online softmax of ``chunked_attention`` for prompts of
``CHUNKED_THRESHOLD`` tokens or more, with the reference's FlashAttention-2
backward (a ``torch.autograd.Function`` in place of its ``custom_vjp``).
The decode functions write the new token's K/V into the cache tensors
they are given, in place, and return them; a row that is not active keeps
its cache bit for bit.  :func:`attn_decode_splitkv` is flash decoding over
a mesh: each ``model`` rank holds one span of the cache's sequence.
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh as M
from . import layers as L

CHUNKED_THRESHOLD = 2048  # use the flash-style path for S >= this
NEG = -1e30


def attn_init(generator, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, *, qkv_bias: bool = False,
              dtype=torch.float32) -> dict:
    return {
        "q": L.dense_init(generator, d_model, num_heads * head_dim,
                          bias=qkv_bias, dtype=dtype),
        "k": L.dense_init(generator, d_model, num_kv_heads * head_dim,
                          bias=qkv_bias, dtype=dtype),
        "v": L.dense_init(generator, d_model, num_kv_heads * head_dim,
                          bias=qkv_bias, dtype=dtype),
        "o": L.dense_init(generator, num_heads * head_dim, d_model,
                          bias=False, dtype=dtype),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _repeat_kv(k, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by repetition (GQA)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _flash_fwd(q, k, v, causal, window, q_chunk, k_chunk):
    """The online-softmax forward: -> (out (B, Sq, H, hd) in q's dtype,
    lse (B, H, Sq) float32, each row's log-sum-exp of its scores)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qc, kc = min(q_chunk, sq), min(k_chunk, sk)
    qpad, kpad = (-sq) % qc, (-sk) % kc
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, qpad))
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))
    nq, nk = (sq + qpad) // qc, (sk + kpad) // kc
    scale = hd ** -0.5
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qx = q[:, qi * qc:(qi + 1) * qc]
        m = torch.full((b, h, qc), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32, device=dev)
        qpos = qi * qc + torch.arange(qc, device=dev)[:, None]
        for kj in range(nk):
            kx = k[:, kj * kc:(kj + 1) * kc]
            vx = v[:, kj * kc:(kj + 1) * kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qx.float(),
                             kx.float()) * scale
            s = s + _bias(qpos, kj * kc, kc, sk, causal, window)[None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vx.dtype), vx).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(1, 2))                  # (b, qc, h, hd)
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=1)[:, :sq].to(q.dtype)
    return out, torch.cat(lses, dim=2)[..., :sq]


def _bias(qpos, k0: int, kc: int, sk: int, causal: bool, window):
    """The (q, kc) additive mask of the key chunk starting at ``k0``: 0
    where a query may attend, ``NEG`` past the keys, in the future
    (causal) or outside the window."""
    kpos = k0 + torch.arange(kc, device=qpos.device)[None, :]
    msk = kpos < sk
    if causal:
        msk = msk & (kpos <= qpos)
    if window is not None:
        msk = msk & (kpos > qpos - window)
    return torch.where(msk, 0.0, NEG)


def _flash_bwd(q, k, v, out, lse, dout, causal, window, k_chunk):
    """The FlashAttention-2 backward of the reference's ``_flash_bwd``:
    one loop over the key chunks, each recomputing its full-Q score block
    (Sq x kc) from (q, lse); dq accumulates over the chunks in float32."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kc = min(k_chunk, sk)
    kpad = (-sk) % kc
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))
    nk = (sk + kpad) // kc
    scale = hd ** -0.5
    qf, doutf = q.float(), dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", doutf, out.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for kj in range(nk):
        kx = k[:, kj * kc:(kj + 1) * kc].float()
        vx = v[:, kj * kc:(kj + 1) * kc].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kx) * scale
        s = s + _bias(qpos, kj * kc, kc, sk, causal, window)[None, None]
        p = torch.exp(s - lse[..., None])           # masked: exp(-1e30) = 0
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, doutf))
        dp = torch.einsum("bqhd,bkhd->bhqk", doutf, vx)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kx)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    dk = torch.cat(dks, dim=1)[:, :sk]
    dv = torch.cat(dvs, dim=1)[:, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """``chunked_attention`` with the reference's ``custom_vjp``: the
    forward saves (q, k, v, out, lse) and nothing per chunk; the backward
    recomputes each score block (:func:`_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, k_chunk):
        out, lse = _flash_fwd(q, k, v, causal, window, q_chunk, k_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, k_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, k_chunk = ctx.mask
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, dout, causal, window,
                                k_chunk)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, causal: bool = True,
                      window: int | None = None, q_chunk: int = 512,
                      k_chunk: int = 1024):
    """Flash-style attention: online softmax over KV chunks, never
    materializing the (Sq, Sk) score matrix, in the forward or (through
    :class:`_FlashAttention`) the backward.
    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) -> (B, Sq, H, hd)."""
    return _FlashAttention.apply(q, k, v, causal, window, q_chunk, k_chunk)


def attention_scores(q, k, v, *, causal: bool, window: int | None = None,
                     q_offset: int = 0, kv_len_mask=None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) -> (B, Sq, H, hd).

    ``q_offset``: absolute position of q[0].  ``kv_len_mask``: optional
    (B, Sk) bool of valid cache slots."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits, NEG)
    if kv_len_mask is not None:
        logits = torch.where(kv_len_mask[:, None, None, :], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _out(p, o, x, cfg, compute_dtype):
    H, hd = cfg.num_heads, cfg.head_dim
    return L.dense_apply(p["o"], o.reshape(x.shape[:-1] + (H * hd,)),
                         compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Tensor parallelism over a mesh's ``model`` axis: a rank holds its block of
# a projection's columns (q, k, v, an MLP's input) or rows (o, an MLP's
# output), and only activations cross the axis
# ---------------------------------------------------------------------------

def whole_cols(t, n: int, mesh):
    """``t`` (..., n) as it is, or, when it holds the rank's block of the
    ``n`` columns (a product with a column-parallel weight), every rank's
    block gathered over ``model``."""
    if t.shape[-1] == n:
        return t
    return M.all_gather(t, mesh, "model", t.ndim - 1)


def row_parallel(p, h, n: int, mesh, *, compute_dtype, reduce=None,
                 keep=None):
    """``dense_apply(p, h)`` for a layer of ``n`` input rows.  When ``p``
    holds the rank's block of the rows over ``model``: ``h``'s matching
    columns (cut out when ``h`` holds all ``n``) times it, ``reduce``d
    over the axis (``psum`` by default; Megatron-SP passes
    ``psum_scatter``), then the bias, which is whole on every rank.  With
    whole rows: the plain product, through ``keep`` if given."""
    w = p["w"] if "w" in p else p["w1"]
    rows = w.shape[0]
    if rows == n:
        y = L.dense_apply(p, h, compute_dtype=compute_dtype)
        return keep(y) if keep else y
    if h.shape[-1] != rows:
        h = h.narrow(-1, M.axis_index(mesh, "model") * rows, rows)
    y = L.dense_apply({k: v for k, v in p.items() if k != "b"}, h,
                      compute_dtype=compute_dtype)
    y = reduce(y) if reduce else M.psum(y, mesh, "model")
    return y + p["b"].to(compute_dtype) if "b" in p else y


def _local_heads(q, k, v, cfg, mesh):
    """q, k, v (B, S, columns) from the q, k, v projections, each the
    rank's block of its columns over ``mesh``'s ``model`` axis or whole
    -> per-head q (B, S, hq, hd), k and v (B, S, kv, hd), and how the
    attention pairs them: ``(q, k, v, rep, idx)``.

    * q: the rank's ``H / tp`` heads when its columns are whole heads of
      its block, else every head (the columns gathered over ``model``);
    * k, v: the rank's ``KV / tp`` heads when q's heads are the rank's
      and the KV heads divide the axis (``rep`` of q's heads a KV head),
      else every KV head (gathered when split), each q head taking its
      group's through ``idx`` (or ``rep = H / KV`` when q has every
      head, the plain path's repeat).
    k and v come back before ``idx`` picks from them: what the cache
    keeps.  Without a mesh, or at one ``model`` rank: every head, the
    plain path's."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = 1 if mesh is None else M.tp_size(mesh)
    b, s = q.shape[:2]
    if H % tp == 0 and q.shape[-1] * tp == H * hd:
        hq = H // tp
    else:
        q, hq = whole_cols(q, H * hd, mesh), H
    q = q.reshape(b, s, hq, hd)
    if hq < H and KV % tp == 0 and k.shape[-1] * tp == KV * hd:
        kv = KV // tp
        return (q, k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd),
                hq // kv, None)
    k = whole_cols(k, KV * hd, mesh).reshape(b, s, KV, hd)
    v = whole_cols(v, KV * hd, mesh).reshape(b, s, KV, hd)
    if hq == H:
        return q, k, v, H // KV, None
    h0 = M.axis_index(mesh, "model") * hq
    return q, k, v, 1, (h0 + torch.arange(hq, device=q.device)) * KV // H


def _projected(p, x, cfg, mesh, compute_dtype):
    return _local_heads(*(L.dense_apply(p[n], x, compute_dtype=compute_dtype)
                          for n in ("q", "k", "v")), cfg, mesh)


def attn_apply(p, x, positions, cfg, *, causal=True, window=None,
               compute_dtype=torch.bfloat16, mesh=None, chunked=None,
               reduce=None, keep=None):
    """Full-sequence attention (prefill). x: (B, S, D).  Returns the output
    and the (k, v) the caller may keep as the prefill cache.  The scores
    take the flash path from ``CHUNKED_THRESHOLD`` tokens on, or as
    ``chunked`` says.  Over a ``mesh``, ``p`` may hold the rank's blocks
    over ``model``: q, k, v column-parallel (the rank's heads,
    :func:`_local_heads`) and o row-parallel (:func:`row_parallel`, with
    ``reduce`` and ``keep``); whole weights give the plain attention."""
    q, k, v, rep, idx = _projected(p, x, cfg, mesh, compute_dtype)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    kv = (k, v)
    if idx is not None:
        k, v = k[:, :, idx], v[:, :, idx]
    kr, vr = _repeat_kv(k, rep), _repeat_kv(v, rep)
    if chunked is None:
        chunked = x.shape[1] >= CHUNKED_THRESHOLD
    if chunked:
        o = chunked_attention(q, kr, vr, causal, window)
    else:
        o = attention_scores(q, kr, vr, causal=causal, window=window)
    o = o.reshape(o.shape[:2] + (-1,))
    return row_parallel(p["o"], o, cfg.num_heads * cfg.head_dim, mesh,
                        compute_dtype=compute_dtype, reduce=reduce,
                        keep=keep), kv


def _attend_cache(p, q, x, cache_k, cache_v, valid, cfg, compute_dtype):
    H, KV = cfg.num_heads, cfg.num_kv_heads
    kr = _repeat_kv(cache_k.to(compute_dtype), H // KV)
    vr = _repeat_kv(cache_v.to(compute_dtype), H // KV)
    o = attention_scores(q, kr, vr, causal=False, q_offset=0,
                         kv_len_mask=valid)
    return _out(p, o, x, cfg, compute_dtype)


def attn_decode_slotted(p, x, cache_k, cache_v, pos, cfg, *, active=None,
                        window=None, compute_dtype=torch.bfloat16):
    """Per-slot single-token decode (continuous batching).  x: (B, 1, D);
    cache_k/v: (B, S_max, KV, hd); ``pos``: (B,) integer, each row's own
    cache fill level.  Row ``b`` writes its new K/V at ``pos[b]`` (in
    place) and attends over its own prefix ``0..pos[b]``.  ``active``:
    optional (B,) bool; an inactive row writes back the value its cache
    already holds, so its rows stay bit for bit (and so does a row whose
    ``pos`` is past the cache, which the reference's one-hot select never
    writes).  Returns (out, cache_k, cache_v)."""
    s_max = cache_k.shape[1]
    q, k, v, _, _ = _projected(p, x, cfg, None, compute_dtype)
    pos = pos.long()
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    write = pos < s_max
    if active is not None:
        write = write & active
    at = torch.clamp(pos, max=s_max - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        old = cache[rows, at]
        cache[rows, at] = torch.where(write[:, None, None],
                                      new[:, 0].to(cache.dtype), old)
    span = torch.arange(s_max, device=x.device)[None, :]
    valid = span <= pos[:, None]
    if window is not None:
        valid = valid & (span > pos[:, None] - window)
    return (_attend_cache(p, q, x, cache_k, cache_v, valid, cfg,
                          compute_dtype), cache_k, cache_v)


def attn_decode(p, x, cache_k, cache_v, cache_len: int, cfg, *, window=None,
                compute_dtype=torch.bfloat16, mesh=None):
    """Single-token decode at one shared fill level.  x: (B, 1, D);
    cache_k/v: (B, S_max, KV', hd); ``cache_len``: int.  Writes the new
    K/V at ``cache_len`` in place; returns (out, cache_k, cache_v).  Over
    a ``mesh``, ``p`` as in :func:`attn_apply`: the cache then holds the
    KV heads that :func:`_local_heads` gives the rank (its own when they
    divide ``model``, else every one)."""
    s_max = cache_k.shape[1]
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    q, k, v, rep, idx = _projected(p, x, cfg, mesh, compute_dtype)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    span = torch.arange(s_max, device=x.device)
    valid = span <= cache_len
    if window is not None:
        valid = valid & (span > cache_len - window)
    valid = valid[None, :].expand(b, s_max)
    kc, vc = cache_k.to(compute_dtype), cache_v.to(compute_dtype)
    if idx is not None:
        kc, vc = kc[:, :, idx], vc[:, :, idx]
    o = attention_scores(q, _repeat_kv(kc, rep), _repeat_kv(vc, rep),
                         causal=False, q_offset=0, kv_len_mask=valid)
    return (row_parallel(p["o"], o.reshape(x.shape[:-1] + (-1,)),
                         cfg.num_heads * cfg.head_dim, mesh,
                         compute_dtype=compute_dtype), cache_k, cache_v)


def attn_decode_splitkv(p, x, cache_k, cache_v, cache_len: int, cfg, *,
                        mesh, window=None, compute_dtype=torch.bfloat16):
    """Flash decoding over a cache whose SEQUENCE dim is split over the
    ``model`` ranks in rank order (the reference's split-KV decode, for KV
    head counts that do not divide the model axis).  Runs on every rank:
    ``cache_k``/``cache_v`` (B, S_loc, KV, hd) are this rank's span of
    positions ``[rank * S_loc, (rank + 1) * S_loc)``; ``cache_len`` the
    global fill level.  The rank whose span holds ``cache_len`` writes the
    new token's K/V there, in place.  Each rank attends over its span as
    :func:`attn_decode` attends over the whole cache, and the spans'
    outputs merge by their log-sum-exps over ``model``: (B, H) weights and
    (B, H, hd) outputs a layer.  At one rank the weight is exp(0) = 1, so
    a 1 x 1 mesh gives :func:`attn_decode`'s output bit for bit.  ``p``
    may hold the rank's blocks over ``model`` (column-parallel q, k, v,
    row-parallel o): the one token's projected q, k and v, not the
    weights, are gathered over the axis, and o's partial products are
    summed over it.  Returns (out, cache_k, cache_v)."""
    s_loc = cache_k.shape[1]
    me = M.axis_index(mesh, "model")
    b = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    q, k, v = (_split_heads(whole_cols(L.dense_apply(
        p[name], x, compute_dtype=compute_dtype), n * hd, mesh), n, hd)
        for name, n in (("q", H), ("k", KV), ("v", KV)))
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    lpos = cache_len - me * s_loc
    if 0 <= lpos < s_loc:                      # this rank owns the slot
        cache_k[:, lpos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, lpos] = v[:, 0].to(cache_v.dtype)
    gpos = me * s_loc + torch.arange(s_loc, device=x.device)
    valid = gpos <= cache_len
    if window is not None:
        valid = valid & (gpos > cache_len - window)
    valid = valid[None, :].expand(b, s_loc)
    kr = _repeat_kv(cache_k.to(compute_dtype), H // KV)
    vr = _repeat_kv(cache_v.to(compute_dtype), H // KV)
    o = attention_scores(q, kr, vr, causal=False, kv_len_mask=valid)
    # this span's log-sum-exp of the scores, (B, 1, H)
    logits = torch.einsum("bqhd,bkhd->bqhk", q.float(), kr.float()) * \
        hd ** -0.5
    logits = torch.where(valid[:, None, None, :], logits, NEG)
    lse = torch.logsumexp(logits, dim=-1)
    mx = M.pmax(lse, mesh, "model")
    wgt = torch.exp(lse - mx)
    wgt = wgt / M.psum(wgt, mesh, "model")
    o = M.psum(o.float() * wgt[..., None], mesh, "model").to(o.dtype)
    o = o.reshape(x.shape[:-1] + (H * hd,))
    return (row_parallel(p["o"], o, H * hd, mesh,
                         compute_dtype=compute_dtype), cache_k, cache_v)
