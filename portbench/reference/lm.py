"""The plain reference of the benchmark's language models, in float32.

Written from the equations, with plain PyTorch only: it imports nothing
of the program.  It takes the benchmark's own weights (the tree the
benchmark draws from the seed, as the program gets it) and the
configuration's sizes as a plain dict, and computes:

* the Mamba-2 block (arXiv:2405.21060): five input projections, a
  depthwise causal conv of width 4 on x, B and C with SiLU, the SSD
  recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t
  h_t + D x_t`` (:func:`ssd_sequential` states it; :func:`ssd_chunked`
  computes the same sums in chunks, so that an 8k-token sequence runs in
  seconds), the gated RMS norm ``rms(y * silu(z))`` and the out
  projection;
* the repository's hybrid (its zamba2): one shared block, pre-norm
  attention with rotary positions (half-split rotation) and causal
  softmax, then a pre-norm MLP, after every ``attn_every``-th mamba
  layer, with the same weights at every application;
* the final RMS norm and the head: ``lm_head.w`` (D, V), or the
  embedding table's transpose where the configuration ties them;
* serving's weights: every floating weight of two or more dimensions
  quantized per tensor, symmetric, to ``bits`` (Q15 for 16) and
  dequantized exactly in float32 (:func:`served_weights`).

Every product runs in float32 with TF32 off (:func:`fp32`).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

CONV_W = 4


@contextlib.contextmanager
def fp32():
    """Float32 products with TF32 off (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def quantize_dequantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor symmetric quantization to ``bits`` and back, in float32:
    scale = max|w| / (2^(bits-1) - 1), q = clamp(round(w / scale))."""
    qmax = (1 << (bits - 1)) - 1
    w = w.float()
    amax = w.abs().max()
    scale = amax / qmax if float(amax) > 0 else torch.tensor(
        1.0 / qmax, device=w.device)
    return torch.clamp(torch.round(w / scale), -qmax - 1, qmax) * scale


def served_weights(params, bits: int):
    """Float32 weights as served at ``bits`` (0: as drawn): weights of two
    or more dimensions through :func:`quantize_dequantize`, the rest as
    drawn."""
    def one(t):
        if bits and t.ndim >= 2 and t.is_floating_point():
            return quantize_dequantize(t, bits)
        return t.float()
    return _map(one, params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(tree, i: int):
    return _map(lambda t: t[i], tree)


#: ``None``: float32 products.  A function ``t -> t`` rounds both operands
#: of every weight product first: the lower-precision control
#: (:func:`round_fp8`) puts the reference in the program's place that way.
ROUND = None


def mm(a, b):
    if ROUND is not None:
        a, b = ROUND(a), ROUND(b)
    return a @ b


def round_fp8(t):
    """t rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest, 448), back in float32; a gradient passes
    through the rounding unchanged."""
    amax = t.detach().abs().max().clamp_min(1e-30)
    s = 448.0 / amax
    r = (t.detach() * s).to(torch.float8_e4m3fn).float() / s
    return t + (r - t.detach())


ROUNDINGS = {"fp8": round_fp8}


# ---------------------------------------------------------------------------
# The SSD recurrence
# ---------------------------------------------------------------------------

def _heads(t, h: int):
    """(b, s, g, n) -> (b, s, h, n): each group's B or C for its heads."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_sequential(x, dt, A, B, C, h0=None):
    """The recurrence step by step.  x (b, s, h, p); dt (b, s, h); A (h,);
    B, C (b, s, g, n) -> (y (b, s, h, p), final state (b, h, n, p))."""
    b, s, h, p = x.shape
    Bh, Ch = _heads(B, h), _heads(C, h)
    st = x.new_zeros((b, h, B.shape[3], p)) if h0 is None else h0
    ys = []
    for t in range(s):
        st = (torch.exp(dt[:, t] * A)[:, :, None, None] * st
              + (dt[:, t, :, None, None] * Bh[:, t, :, :, None]
                 * x[:, t, :, None, :]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], st))
    return torch.stack(ys, dim=1), st


def ssd_chunked(x, dt, A, B, C, chunk: int = 256):
    """The same sums, chunk by chunk: inside a chunk, y_i = sum_{j<=i}
    (C_i . B_j) exp(cs_i - cs_j) dt_j x_j, with cs the cumulative sum of
    dt A; the state carried into a chunk adds C_i exp(cs_i) h; the state
    leaving it is exp(cs_last) h + sum_j exp(cs_last - cs_j) dt_j B_j
    x_j^T."""
    b, s, h, p = x.shape
    Bh, Ch = _heads(B, h), _heads(C, h)
    st = x.new_zeros((b, h, B.shape[3], p))
    ys = []
    for c0 in range(0, s, chunk):
        xs, dts = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bs, Cs = Bh[:, c0:c0 + chunk], Ch[:, c0:c0 + chunk]
        q = xs.shape[1]
        cs = torch.cumsum(dts * A, dim=1)                       # (b, q, h)
        diff = cs[:, :, None, :] - cs[:, None, :, :]            # (b, i, j, h)
        low = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        dec = torch.exp(torch.where(low[None, :, :, None], diff,
                                    torch.full_like(diff, -math.inf)))
        w = torch.einsum("bihn,bjhn->bijh", Cs, Bs) * dec * dts[:, None]
        y = torch.einsum("bijh,bjhp->bihp", w, xs)
        y = y + torch.einsum("bihn,bhnp->bihp",
                             Cs * torch.exp(cs)[..., None], st)
        to_end = torch.exp(cs[:, -1:] - cs) * dts               # (b, q, h)
        st = (torch.exp(cs[:, -1])[:, :, None, None] * st
              + torch.einsum("bjh,bjhn,bjhp->bhnp", to_end, Bs, xs))
        ys.append(y)
    return torch.cat(ys, dim=1), st


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def causal_conv(u, w, b):
    """Depthwise causal conv: u (b, s, c), w (W, c)."""
    s = u.shape[1]
    up = F.pad(u, (0, 0, w.shape[0] - 1, 0))
    return sum(up[:, i:i + s] * w[i] for i in range(w.shape[0])) + b


def mamba(p, x, d):
    """One Mamba-2 mixer over x (b, s, D)."""
    b, s, _ = x.shape
    di, hd = 2 * d["d_model"], d["mamba_headdim"]
    h, g, n = di // hd, d["mamba_groups"], d["ssm_state"]
    z = mm(x, p["z_proj"]["w"])
    xr = F.silu(causal_conv(mm(x, p["x_proj"]["w"]), p["conv_x"],
                            p["conv_x_b"]))
    Br = F.silu(causal_conv(mm(x, p["B_proj"]["w"]), p["conv_B"],
                            p["conv_B_b"]))
    Cr = F.silu(causal_conv(mm(x, p["C_proj"]["w"]), p["conv_C"],
                            p["conv_C_b"]))
    dt = F.softplus(mm(x, p["dt_proj"]["w"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xr.reshape(b, s, h, hd)
    y, _ = ssd_chunked(xh, dt, A, Br.reshape(b, s, g, n),
                       Cr.reshape(b, s, g, n), d["ssd_chunk"])
    y = (y + p["D"][:, None] * xh).reshape(b, s, di)
    return mm(rms(y * F.silu(z), p["gn"]["scale"], d["norm_eps"]),
              p["out_proj"]["w"])


def rope(x, theta: float):
    """x (b, s, heads, hd): rotation of the two halves of each head."""
    hd, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, d, q_block: int = 1024):
    """Causal multi-head attention (KV heads repeated) over x (b, s, D),
    in blocks of ``q_block`` query rows."""
    b, s, _ = x.shape
    H, KV, hd = d["num_heads"], d["num_kv_heads"], d["head_dim"]
    q = rope(mm(x, p["q"]["w"]).reshape(b, s, H, hd), d["rope_theta"])
    k = rope(mm(x, p["k"]["w"]).reshape(b, s, KV, hd), d["rope_theta"])
    v = mm(x, p["v"]["w"]).reshape(b, s, KV, hd)
    k, v = k.repeat_interleave(H // KV, 2), v.repeat_interleave(H // KV, 2)
    out = []
    for q0 in range(0, s, q_block):
        q1 = min(s, q0 + q_block)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) \
            * hd ** -0.5
        keep = (torch.arange(q1, device=x.device)[None, :]
                <= torch.arange(q0, q1, device=x.device)[:, None])
        sc = torch.where(keep, sc, torch.full_like(sc, -math.inf))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                                v[:, :q1]))
    return mm(torch.cat(out, 1).reshape(b, s, H * hd), p["o"]["w"])


def mlp(p, x, kind: str):
    if kind == "gelu":
        return mm(F.gelu(mm(x, p["w_in"]["w"]), approximate="tanh"),
                  p["w_out"]["w"])
    if kind == "swiglu":
        return mm(F.silu(mm(x, p["w_gate"]["w"])) * mm(x, p["w_in"]["w"]),
                  p["w_out"]["w"])
    raise ValueError(f"reference has no MLP kind {kind!r}")


def mamba_layer(bp, x, d):
    return x + mamba(bp["mamba"], rms(x, bp["ln"]["scale"], d["norm_eps"]),
                     d)


def shared_block(sp, x, d):
    eps = d["norm_eps"]
    x = x + attention(sp["attn"], rms(x, sp["ln1"]["scale"], eps), d)
    return x + mlp(sp["mlp"], rms(x, sp["ln2"]["scale"], eps), d["mlp_kind"])


def hidden(W, tokens, d, *, remat: bool = False):
    """Final normed hidden states (b, s, D) of token ids (b, s)."""
    if d["family"] not in ("ssm", "hybrid"):
        raise ValueError(f"reference has no family {d['family']!r}")
    x = W["embed"]["table"][tokens.long()]
    run = (lambda f, *a: torch.utils.checkpoint.checkpoint(
        f, *a, use_reentrant=False)) if remat else (lambda f, *a: f(*a))
    for i in range(d["num_layers"]):
        x = run(mamba_layer, layer(W["blocks"], i), x, d)
        if d["family"] == "hybrid" and (i + 1) % d["attn_every"] == 0:
            x = run(shared_block, W["shared"], x, d)
    return rms(x, W["final_norm"]["scale"], d["norm_eps"])


def head_weight(W, d):
    if d["tie_embeddings"] or "lm_head" not in W:
        return W["embed"]["table"].T
    return W["lm_head"]["w"]


def logits_at(W, tokens, positions, d):
    """Float32 logits (len(positions), V) of one sequence ``tokens`` (s,)
    at ``positions``."""
    with fp32(), torch.no_grad():
        x = hidden(W, tokens[None], d)[0]
        return mm(x[positions], head_weight(W, d))


# ---------------------------------------------------------------------------
# Training: the loss, its gradient and Adam
# ---------------------------------------------------------------------------

def loss(W, tokens, labels, d):
    """Mean cross-entropy of ``labels`` under the logits of ``tokens``
    (b, s), plus the z-loss ``z_loss * lse^2``; each layer recomputed in
    the backward."""
    x = hidden(W, tokens, d, remat=True)
    logits = mm(x, head_weight(W, d))
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll + d["z_loss"] * lse.square()).mean()


def train_steps(params, batches, d, adam: dict):
    """Adam steps from ``params`` (left as they are), one a batch of
    (tokens, labels): the gradient of :func:`loss` over float32 copies of
    the parameters, clipped to a global norm of ``grad_clip``, then
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr_t
    m_hat / (sqrt(v_hat) + eps)`` with ``lr_t = lr * min(1, t /
    warmup_steps)`` at step t (from 1), each parameter rounded to its own
    dtype.  Returns (losses, the first step's clipped gradient, the
    parameters after the last step), the trees as flat dicts by path."""
    P = {k: t.detach().clone() for k, t in _flat(params)}
    m = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in P.items()}
    v = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in P.items()}
    losses, first = [], None
    for t, (tokens, labels) in enumerate(batches, start=1):
        live = {k: p.to(torch.float32, copy=True).requires_grad_()
                for k, p in P.items()}
        with fp32():
            val = loss(_unflat(live), tokens, labels, d)
            grads = torch.autograd.grad(val, list(live.values()))
        losses.append(float(val.detach()))
        g = dict(zip(live, grads))
        del live, grads
        norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
        scale = torch.clamp(adam["grad_clip"] / (norm + 1e-9), max=1.0)
        lr = adam["lr"] * min(1.0, t / adam["warmup_steps"])
        with torch.no_grad():
            for k, p in P.items():
                gs = g[k] * scale
                m[k].mul_(adam["b1"]).add_(gs, alpha=1 - adam["b1"])
                v[k].mul_(adam["b2"]).add_(gs.square(), alpha=1 - adam["b2"])
                u = (m[k] / (1 - adam["b1"] ** t)) / (
                    (v[k] / (1 - adam["b2"] ** t)).sqrt() + adam["eps"])
                p.copy_(p.float() - lr * u)
                if t == 1:
                    g[k] = gs
        if t == 1:
            first = g
    return losses, first, P


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out
