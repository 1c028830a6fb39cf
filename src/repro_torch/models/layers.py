"""Shared neural building blocks of the LM zoo (reference
``repro.models.layers``).

Every module is a pure function over an explicit parameter dict of
tensors, in the reference's op order and dtypes, so the same parameters
give the reference's numbers.  Initialisers draw from a
``torch.Generator`` on the device the parameters are made on; they cannot
reproduce JAX's PRNG, so parity tests carry the reference's initialised
trees across (:func:`repro_torch.weights.lm_params_from_numpy`).

Where the reference asks for float32 accumulation of a product of
compute-dtype values (``preferred_element_type=jnp.float32``), the port
upcasts both operands to float32 before the product: a product of two
bfloat16 values is exact in float32, so this is the same function.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class _ShapeOnly:
    """A stand-in for a ``torch.Generator`` on the ``meta`` device: the
    initialisers given it build their leaves' shapes and dtypes and draw
    and allocate nothing (``torch.Generator`` has no ``meta`` device)."""
    device = torch.device("meta")


SHAPE_ONLY = _ShapeOnly()


def truncated_normal(generator: torch.Generator, shape, std: float = 0.02,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn in
    float32 on the generator's device and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if generator is not SHAPE_ONLY:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return (std * t).to(dtype)


# ---------------------------------------------------------------------------
# Dense (optionally low-rank factorized: the paper's W = W1 W2^T at LM scale)
# ---------------------------------------------------------------------------

def dense_init(generator, d_in: int, d_out: int, *, bias: bool = False,
               rank: int | None = None, dtype=torch.float32,
               std: float | None = None) -> dict:
    """``{"w"}`` or the low-rank ``{"w1", "w2"}``, plus ``"b"`` (zeros in
    ``dtype``) with ``bias``.  As in the reference, a full-rank weight
    drawn at the default std comes out at least float32 whatever ``dtype``
    says: the reference's ``1 / np.sqrt(d_in)`` is a numpy float64, which
    JAX's type promotion does not let the narrower ``dtype`` win against
    (ROADMAP C2)."""
    w_dtype = dtype
    if std is None:
        std = 1.0 / math.sqrt(d_in)
        w_dtype = torch.promote_types(dtype, torch.float32)
    if rank is None:
        p = {"w": truncated_normal(generator, (d_in, d_out), std, w_dtype)}
    else:
        # product variance matched to the unfactored init
        s = float(math.sqrt(std / math.sqrt(rank)))
        p = {"w1": truncated_normal(generator, (d_in, rank), s, dtype),
             "w2": truncated_normal(generator, (rank, d_out), s, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def dense_apply(p, x, *, compute_dtype=torch.bfloat16):
    x = x.to(compute_dtype)
    if "w" in p:
        y = x @ p["w"].to(compute_dtype)
    else:
        y = (x @ p["w1"].to(compute_dtype)) @ p["w2"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-5):
    """Mean of squares reduced in float32; the rescale stays in x.dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * p["scale"].to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, hd); positions: (..., S) integer.  Computed in
    float32 and cast back to x.dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def mlp_init(generator, d_model: int, d_ff: int, kind: str, *,
             bias: bool = False, rank: int | None = None,
             dtype=torch.float32) -> dict:
    kw = dict(bias=bias, rank=rank, dtype=dtype)
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(generator, d_model, d_ff, **kw),
                "w_in": dense_init(generator, d_model, d_ff, **kw),
                "w_out": dense_init(generator, d_ff, d_model, **kw)}
    # relu2 (squared ReLU) / gelu
    return {"w_in": dense_init(generator, d_model, d_ff, **kw),
            "w_out": dense_init(generator, d_ff, d_model, **kw)}


def mlp_apply(p, x, kind: str, *, compute_dtype=torch.bfloat16,
              act_override=None):
    h = mlp_hidden(p, x, kind, compute_dtype=compute_dtype,
                   act_override=act_override)
    return dense_apply(p["w_out"], h, compute_dtype=compute_dtype)


def mlp_hidden(p, x, kind: str, *, compute_dtype=torch.bfloat16,
               act_override=None):
    """The MLP's activated hidden layer, before ``w_out``."""
    if kind == "swiglu":
        act = act_override or F.silu
        h = act(dense_apply(p["w_gate"], x, compute_dtype=compute_dtype)) \
            * dense_apply(p["w_in"], x, compute_dtype=compute_dtype)
    elif kind == "geglu":
        act = act_override or _gelu
        h = act(dense_apply(p["w_gate"], x, compute_dtype=compute_dtype)) \
            * dense_apply(p["w_in"], x, compute_dtype=compute_dtype)
    elif kind == "relu2":
        h = dense_apply(p["w_in"], x, compute_dtype=compute_dtype)
        h = torch.square(torch.relu(h))
    elif kind == "gelu":
        act = act_override or _gelu
        h = act(dense_apply(p["w_in"], x, compute_dtype=compute_dtype))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(generator, vocab: int, d_model: int,
               dtype=torch.float32) -> dict:
    return {"table": truncated_normal(generator, (vocab, d_model), 0.02,
                                      dtype)}


def embed_apply(p, tokens, compute_dtype=torch.bfloat16):
    return p["table"][tokens].to(compute_dtype)


def unembed_apply(p, x, compute_dtype=torch.bfloat16):
    """Tied unembedding: logits = x @ table^T over compute-dtype values,
    accumulated and returned in float32."""
    return torch.matmul(x.to(compute_dtype).float(),
                        p["table"].to(compute_dtype).float().T)


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean cross-entropy with the optional z-loss ``z_loss * lse^2``;
    logits (..., V) (taken in float32), labels (...) integer.

    The reference picks each label's logit with a one-hot product and
    sum, a layout choice for its vocab-sharded compiler; every other term
    of that sum is an exact zero, so a ``gather`` gives the same value
    for finite logits without the (..., V) float32 one-hot, which at
    Qwen2-1.5B's vocab and 8,192 tokens would be 5 GB."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()
