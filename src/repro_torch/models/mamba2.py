"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block (reference
``repro.models.mamba2``).

The chunked SSD formulation: within chunks of Q rows the recurrence is a
masked, decay-weighted attention-like product; across chunks a sequential
recurrence carries the (H, N, P) state.  :func:`ssd_chunked` is the
reference's own scan in PyTorch and the oracle of the SSD scan kernel
(``kernels/ssd_scan``); :func:`mamba_apply` takes the scan as
``ssm_impl`` (default :func:`ssd_chunked`), and the LM assembly passes
the kernel's entry point ``kernels.ssd_scan.ops.ssd_scan`` there.

The input projection is stored as five column blocks (z, x, B, C, dt) and
the depthwise conv as three (x, B, C), as in the reference.

Shapes: x (B, S, H, P) with H * P = d_inner; dt (B, S, H); A (H,)
negative; B, C (B, S, G, N), G groups broadcast over H // G heads each;
the state (B, H, N, P).  :func:`mamba_apply_seq` is the
sequence-parallel (context-parallel) block, run on every rank of a mesh
over the rank's span of the sequence; over a mesh's ``model`` axis,
:func:`mamba_apply` and :func:`mamba_decode` also run on the rank's blocks
of the weights (its heads and channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as M
from . import layers as L


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 256, h0=None,
                return_cs: bool = False):
    """Returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P)
    float32[, cs]).  As the reference: S zero-padded to a multiple of the
    chunk, the intra-chunk product taken over M cast to x's dtype, and the
    intra- and inter-chunk terms each rounded to x's dtype before their
    sum.  ``return_cs``: also the (B, S, H) inclusive cumsum of dt * A
    over the whole span, which the sequence-parallel correction needs (y
    is linear in the incoming state: y(h0) = y(0) + C_i exp(cs_i) h0)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        zf = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, B, C = zf(x), zf(dt), zf(B), zf(C)
    sp = s + pad
    nc = sp // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    dA = dtc * A.float()                                 # (b,nc,Q,h)
    cs = torch.cumsum(dA, dim=2)
    # the decay L[i,j] = exp(cs_i - cs_j) for i >= j, clamped before the
    # exp where i < j (cs_i - cs_j > 0 there and would overflow)
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (b,nc,Q,Q,h)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    li = torch.where(mask[None, None, :, :, None], li,
                     torch.full_like(li, -1e30))
    ldec = torch.exp(li)

    Bh = Bc.repeat_interleave(rep, dim=3).float()        # (b,nc,Q,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3).float()
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    M = scores * ldec * dtc[:, :, None, :, :]            # weight by dt_j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M.to(x.dtype).float(),
                          xc.float()).to(x.dtype)

    # chunk-final states: S_c[h,n,p] = sum_j exp(cs_last - cs_j) dt_j B_j x_j
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)      # (b,nc,Q,h)
    dBx = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", decay_to_end * dtc, Bh,
                       xc.float())

    # the inter-chunk recurrence, in order over the chunks
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (b,nc,h)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(state)                            # state BEFORE chunk
        state = chunk_decay[:, c, :, None, None] * state + dBx[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # (b,nc,h,n,p)

    # inter-chunk contribution: y_off_i = C_i . (exp(cs_i) * H_prev)
    y_off = torch.einsum("bcihn,bcih,bchnp->bcihp", Ch, torch.exp(cs),
                         h_prevs).to(x.dtype)
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    if return_cs:
        # the span's cumsum: each chunk's own plus the closed earlier chunks'
        last = cs[:, :, -1, :]
        prior = torch.cumsum(last, dim=1) - last
        cs_full = (cs + prior[:, :, None, :]).reshape(b, sp, h)[:, :s]
        return y, state, cs_full
    return y, state


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token SSD update.  state: (B, H, N, P); x: (B, H, P); dt: (B,
    H); B, C: (B, G, N).  Returns (y (B, H, P) in x's dtype, new state)."""
    h, g = x.shape[1], B.shape[1]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=1).float()          # (B,H,N)
    Ch = C.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    dec = torch.exp(dtf * A.float())                      # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dtf, Bh, x.float())
    new_state = dec[:, :, None, None] * state + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba-2 block: [z|x|B|C|dt]_proj -> conv(x,B,C) -> SSD -> gated norm
# -> out_proj
# ---------------------------------------------------------------------------

CONV_W = 4


def mamba_dims(cfg):
    """(d_inner, head dim P, heads H, groups G, state size N)."""
    d_inner = 2 * cfg.d_model
    headdim = cfg.mamba_headdim
    return d_inner, headdim, d_inner // headdim, cfg.mamba_groups, \
        cfg.ssm_state


def mamba_init(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """The reference's leaves, shapes and dtypes, drawn from ``generator``
    on its device: the projections at ``dense_init``'s default std (float32
    at least, ROADMAP C2), the conv weights truncated normal at std 0.1 in
    ``dtype``, ``A_log = log(linspace(1, 16, H))``, ``dt_bias`` 0 and ``D``
    1 in float32."""
    d_inner, pdim, n_heads, g, n = mamba_dims(cfg)
    dev = generator.device

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, dtype=dtype)

    def zeros(d):
        return torch.zeros((d,), dtype=dtype, device=dev)

    return {
        "z_proj": dense(cfg.d_model, d_inner),
        "x_proj": dense(cfg.d_model, d_inner),
        "B_proj": dense(cfg.d_model, g * n),
        "C_proj": dense(cfg.d_model, g * n),
        "dt_proj": dense(cfg.d_model, n_heads),
        "conv_x": L.truncated_normal(generator, (CONV_W, d_inner), 0.1, dtype),
        "conv_x_b": zeros(d_inner),
        "conv_B": L.truncated_normal(generator, (CONV_W, g * n), 0.1, dtype),
        "conv_B_b": zeros(g * n),
        "conv_C": L.truncated_normal(generator, (CONV_W, g * n), 0.1, dtype),
        "conv_C_b": zeros(g * n),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "gn": L.rmsnorm_init(d_inner, dtype, dev),
        "out_proj": dense(d_inner, cfg.d_model),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv.  u: (B, S, C); w: (W, C).  A sum of shifted
    products, as the reference writes it (no ``conv1d``, so no cuDNN and
    no TF32)."""
    W = w.shape[0]
    up = F.pad(u, (0, 0, W - 1, 0))
    y = sum(up[:, i:i + u.shape[1], :] * w[i] for i in range(W))
    return y + b


def _conv_tail(u):
    """The last CONV_W - 1 inputs of a sequence, the decode conv's state:
    zero rows before the sequence's start for a prompt shorter than that
    (ROADMAP C4)."""
    return F.pad(u, (0, 0, CONV_W - 1, 0))[:, -(CONV_W - 1):]


def _silu(x):
    return x * torch.sigmoid(x)               # jax.nn.silu


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))   # jax.nn.softplus


def _projections(p, xin, compute_dtype):
    cd = compute_dtype
    return tuple(L.dense_apply(p[k], xin, compute_dtype=cd)
                 for k in ("z_proj", "x_proj", "B_proj", "C_proj", "dt_proj"))


def _rank_groups(t, h_loc: int, cfg, mesh, dim: int):
    """B or C, groups on ``dim``, for a scan over ``h_loc`` heads: as it is
    with one group or with every head; else each of the rank's heads'
    group (one group a head)."""
    _, _, n_heads, g, _ = mamba_dims(cfg)
    if g == 1 or h_loc == n_heads:
        return t
    first = M.axis_index(mesh, "model") * h_loc
    idx = torch.arange(first, first + h_loc, device=t.device)
    return t.index_select(dim, idx // (n_heads // g))


def _gated_out(p, y, z, cfg, cd, mesh):
    """The gated norm and ``out_proj`` over ``y`` (.., heads x P) and the
    gate ``z``.  Whole ``z`` (every channel): the plain ops.  Over the
    rank's ``d_inner / tp`` channels: ``y`` cut to them where it holds
    every head, the norm's mean of squares and ``out_proj``'s row-parallel
    products summed over ``model``."""
    d_inner = mamba_dims(cfg)[0]
    d_loc = z.shape[-1]
    if d_loc == d_inner:
        y = L.rmsnorm_apply(p["gn"], y * _silu(z), cfg.norm_eps)
        return L.dense_apply(p["out_proj"], y, compute_dtype=cd)
    if y.shape[-1] != d_loc:
        y = y.narrow(-1, M.axis_index(mesh, "model") * d_loc, d_loc)
    y = _rmsnorm_split(p["gn"], y * _silu(z), d_inner, cfg.norm_eps, mesh)
    return M.psum(L.dense_apply(p["out_proj"], y, compute_dtype=cd), mesh,
                  "model")


def mamba_apply(p, xin, cfg, *, chunk: int = 256,
                compute_dtype=torch.bfloat16, ssm_impl=ssd_chunked,
                mesh=None):
    """Full-sequence Mamba-2 block.  xin: (B, S, D) -> (out, {"ssm": final
    state (B, H, N, P), "conv": {"x", "B", "C"}: the last CONV_W - 1
    pre-conv inputs (B, 3, width)}).

    Over a ``mesh``, ``p`` may hold the rank's blocks over ``model``, as
    :func:`mamba_decode` takes them: the rank then convolves its x
    channels over the whole sequence and scans its heads (``ssm_impl`` on
    ``H / tp`` heads), and the state and the x conv tail it returns are
    its blocks (the SSM state's heads, the tail's channels), as
    ``sharding.cache_pspecs`` places them.  Where the channels divide
    ``model`` and the heads do not, the conv output is gathered and every
    rank scans every head.  Differentiable through its collectives."""
    b, s, _ = xin.shape
    pdim, g, n = cfg.mamba_headdim, cfg.mamba_groups, cfg.ssm_state
    cd = compute_dtype
    z, xr, Br, Cr, dt = _projections(p, xin, cd)
    d_loc, h_loc = xr.shape[-1], dt.shape[-1]
    conv_tails = {"x": _conv_tail(xr), "B": _conv_tail(Br),
                  "C": _conv_tail(Cr)}
    xr = _silu(_causal_conv(xr, p["conv_x"].to(cd), p["conv_x_b"].to(cd)))
    Br = _silu(_causal_conv(Br, p["conv_B"].to(cd), p["conv_B_b"].to(cd)))
    Cr = _silu(_causal_conv(Cr, p["conv_C"].to(cd), p["conv_C_b"].to(cd)))
    if h_loc * pdim != d_loc:            # channels split, heads whole
        xr = M.all_gather(xr, mesh, "model", 2)
    x = xr.reshape(b, s, h_loc, pdim)
    B = _rank_groups(Br.reshape(b, s, g, n), h_loc, cfg, mesh, 2)
    C = _rank_groups(Cr.reshape(b, s, g, n), h_loc, cfg, mesh, 2)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssm_impl(x, dt, A, B, C, chunk=chunk)
    y = y + p["D"].to(cd)[None, None, :, None] * x
    out = _gated_out(p, y.reshape(b, s, h_loc * pdim), z, cfg, cd, mesh)
    return out, {"ssm": state, "conv": conv_tails}


# ---------------------------------------------------------------------------
# The sequence-parallel (context-parallel) block, on every rank of a mesh
# over the rank's span of the sequence, every weight whole.
#
# The SSD recurrence is associative in (decay, state), and y is LINEAR in
# the incoming state h0: y(h0) = y(0) + C_i exp(cs_i) h0.  So each rank
# runs its span from h0 = 0, the ranks' (span decay, final state) pairs
# are all-gathered, each rank folds its predecessors', and adds the
# correction: a state exchange and a 3-sample conv halo in place of the
# per-layer all-reduce of (B, S, D) activations.
# ---------------------------------------------------------------------------

def _conv_with_context(u, ctx, w, b):
    """Causal conv whose first W - 1 inputs come from the previous rank's
    span tail (zeros on the first rank: the true start)."""
    y = _causal_conv(torch.cat([ctx, u], dim=1), w, b)
    return y[:, ctx.shape[1]:]


def mamba_apply_seq(p, xin, cfg, *, mesh, axis: str = "model",
                    chunk: int = 256, compute_dtype=torch.bfloat16):
    """The block over this rank's span ``xin`` (B, S_loc, D) of a sequence
    split over ``axis`` in rank order.  Returns (out, {"ssm": the GLOBAL
    final state (the same on every rank), "conv": the global tail (the
    last CONV_W - 1 inputs of the whole sequence)}).  A span shorter than
    the conv halo gathers every rank's raw conv inputs, so the context
    reaches back over as many ranks as it needs (the reference's takes
    the previous rank's span alone: ROADMAP C9).  Differentiable through
    its collectives."""
    b, s, _ = xin.shape
    d_inner, pdim, n_heads, g, n = mamba_dims(cfg)
    cd = compute_dtype
    nsh, me = M.axis_size(mesh, axis), M.axis_index(mesh, axis)

    z, xr, Br, Cr, dt = _projections(p, xin, cd)
    raw = {"x": xr, "B": Br, "C": Cr}
    short = s < CONV_W - 1
    if short:
        # every rank's raw rows: a rank's context is the last CONV_W - 1
        # rows of the spans before its own, the global tail the last
        # CONV_W - 1 rows of all of them
        whole = {k: M.all_gather(t, mesh, axis, 1) for k, t in raw.items()}
        ctx = {k: _conv_tail(t[:, :me * s]) for k, t in whole.items()}
        tails = {k: _conv_tail(t) for k, t in whole.items()}
    else:
        ctx = {k: M.shift_next(_conv_tail(t), mesh, axis)
               for k, t in raw.items()}
        tails = {k: _conv_tail(t) for k, t in raw.items()}
    xr, Br, Cr = (_silu(_conv_with_context(
        raw[k], ctx[k], p[f"conv_{k}"].to(cd), p[f"conv_{k}_b"].to(cd)))
        for k in ("x", "B", "C"))
    x = xr.reshape(b, s, n_heads, pdim)
    B = Br.reshape(b, s, g, n)
    C = Cr.reshape(b, s, g, n)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y0, state, cs = ssd_chunked(x, dt, A, B, C, chunk=chunk, return_cs=True)
    dg = M.stack_gather(torch.exp(cs[:, -1]), mesh, axis)   # (nsh, b, h)
    sg = M.stack_gather(state, mesh, axis)                  # (nsh, b,h,n,p)
    run = torch.zeros_like(state)
    h_in = run
    for d in range(nsh):                                    # a tiny fold
        # a select on every rank, as the reference's where: each rank's
        # graph then reaches the gathered states, so every rank runs the
        # all-gathers' backward (a collective) together
        h_in = torch.where(torch.tensor(d == me, device=run.device), run,
                           h_in)
        run = dg[d][:, :, None, None] * run + sg[d]
    Ch = C.repeat_interleave(n_heads // g, dim=2).float()
    y_corr = torch.einsum("bshn,bsh,bhnp->bshp", Ch, torch.exp(cs), h_in)
    y = y0 + y_corr.to(y0.dtype)
    y = y + p["D"].to(cd)[None, None, :, None] * x
    y = y.reshape(b, s, d_inner)
    y = L.rmsnorm_apply(p["gn"], y * _silu(z), cfg.norm_eps)
    out = L.dense_apply(p["out_proj"], y, compute_dtype=cd)
    if not short:
        # the global conv tail is the last rank's: masked, then summed
        last = me == nsh - 1
        tails = {k: M.psum(t if last else torch.zeros_like(t), mesh, axis)
                 for k, t in tails.items()}
    return out, {"ssm": run, "conv": tails}


def _rmsnorm_split(p, x, d: int, eps: float, mesh):
    """``layers.rmsnorm_apply`` over rows whose ``d`` columns are split
    over ``model``: ``x`` and ``p``'s scale the rank's blocks of them.  The
    mean of squares is the ``psum`` of each rank's float32 sum, over the
    whole ``d``."""
    ss = M.psum(x.float().square().sum(dim=-1, keepdim=True), mesh, "model")
    inv = torch.rsqrt(ss / d + eps).to(x.dtype)
    return (x * inv) * p["scale"].to(x.dtype)


def mamba_decode(p, xin, conv_state, ssm_state, cfg, *,
                 compute_dtype=torch.bfloat16, mesh=None):
    """One-token decode.  xin: (B, 1, D); conv_state: {"x", "B", "C"} of
    (B, CONV_W - 1, width); ssm_state: (B, H, N, P).  Returns (out (B, 1, D),
    new conv state, new ssm state); the inputs are not written.

    Over a ``mesh``, ``p`` may hold the rank's blocks over ``model``, as
    ``launch.sharding`` places them: the z, x and dt columns, the
    ``conv_x`` channels and bias, ``A_log`` / ``dt_bias`` / ``D``, the
    ``gn`` scale and the ``out_proj`` rows (B and C whole).  The cache
    then holds the same blocks: the x conv tail's channels and the SSM
    state's heads.  The rank decodes its heads; the gated norm's mean of
    squares and ``out_proj``'s products are summed over ``model``.  Where
    the channels divide ``model`` and the heads do not, the heads' leaves
    and the SSM state are whole: the rank's conv output is gathered and
    every rank runs every head.  Whole weights give the plain decode."""
    b = xin.shape[0]
    pdim, g, n = cfg.mamba_headdim, cfg.mamba_groups, cfg.ssm_state
    cd = compute_dtype
    z, xr, Br, Cr, dt = _projections(p, xin[:, 0], cd)
    d_loc, h_loc = xr.shape[-1], dt.shape[-1]

    def conv_step(state, new, w, bias):
        # the reference's einsum "bwc,wc->bc": products of compute-dtype
        # values summed in float32, rounded once
        seq = torch.cat([state.to(cd), new[:, None, :]], dim=1)
        y = (seq.float() * w.to(cd).float()).sum(dim=1).to(cd) + bias.to(cd)
        return _silu(y), seq[:, 1:]

    xr, ncx = conv_step(conv_state["x"], xr, p["conv_x"], p["conv_x_b"])
    Br, ncB = conv_step(conv_state["B"], Br, p["conv_B"], p["conv_B_b"])
    Cr, ncC = conv_step(conv_state["C"], Cr, p["conv_C"], p["conv_C_b"])
    if h_loc * pdim != d_loc:            # channels split, heads whole
        xr = M.all_gather(xr, mesh, "model", 1)
    x = xr.reshape(b, h_loc, pdim)
    B = _rank_groups(Br.reshape(b, g, n), h_loc, cfg, mesh, 1)
    C = _rank_groups(Cr.reshape(b, g, n), h_loc, cfg, mesh, 1)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    yo, new_ssm = ssd_decode_step(ssm_state, x, dt, A, B, C)
    yo = yo + p["D"].to(cd)[None, :, None] * x
    out = _gated_out(p, yo.reshape(b, h_loc * pdim), z, cfg, cd, mesh)
    return out[:, None, :], {"x": ncx, "B": ncB, "C": ncC}, new_ssm
