"""Model FLOPs of one step at the shapes served or trained, from the
configuration alone: the matrix products (2 FLOP a multiply-add), the
SSD scan's chunked algorithm at the configuration's chunk, attention's
scores and mixing (causal: the lower triangle), the depthwise conv.
Norms, gates and softmax are left out.  Training counts the forward
three times (forward and backward); recomputation is not counted."""
from __future__ import annotations


def _mamba_dims(cfg):
    di = 2 * cfg.d_model
    return di, cfg.mamba_headdim, di // cfg.mamba_headdim, \
        cfg.mamba_groups, cfg.ssm_state


def _mamba_token(cfg) -> int:
    """A mamba layer's per-token products: five in projections, the
    conv, the out projection."""
    D = cfg.d_model
    di, _, h, g, n = _mamba_dims(cfg)
    return (2 * D * (2 * di + 2 * g * n + h) + 2 * 4 * (di + 2 * g * n)
            + 2 * di * D)


def ssd_chunked_flops(cfg, s: int) -> int:
    """The SSD scan over s tokens in chunks of ``cfg.ssd_chunk``: C B^T
    over each chunk's lower triangle (per group), M x over it and the
    chunk states and the states' outputs (per head), the passing of the
    state between chunks."""
    _, p, h, g, n = _mamba_dims(cfg)
    q = cfg.ssd_chunk
    nfull, rest = divmod(s, q)
    tri = nfull * (q * (q + 1) // 2) + rest * (rest + 1) // 2
    nck = nfull + (1 if rest else 0)
    return (2 * g * n * tri + 2 * h * p * tri + 4 * h * s * n * p
            + 2 * h * nck * n * p)


def _attn_token(cfg) -> int:
    """An attention block's per-token products: q, k, v, o and the
    MLP."""
    D, hd = cfg.d_model, cfg.head_dim
    proj = 2 * D * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return proj + 2 * mats * D * cfg.d_ff


def _n_attn(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _n_mamba(cfg) -> int:
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


def _head(cfg) -> int:
    return 2 * cfg.d_model * cfg.vocab_size


def prefill_flops(cfg, s: int, head_rows: int = 1) -> int:
    """One prefill of s tokens, the head over ``head_rows`` positions."""
    causal = 2 * 2 * cfg.num_heads * cfg.head_dim * (s * (s + 1) // 2)
    return (_n_mamba(cfg) * (s * _mamba_token(cfg) + ssd_chunked_flops(cfg, s))
            + _n_attn(cfg) * (s * _attn_token(cfg) + causal)
            + head_rows * _head(cfg))


def decode_flops(cfg, keys) -> int:
    """One decode tick over rows that each attend over ``keys[i]``
    cached positions (its own token included)."""
    _, p, h, _, n = _mamba_dims(cfg)
    per_row = (_n_mamba(cfg) * (_mamba_token(cfg) + 6 * h * n * p)
               + _n_attn(cfg) * _attn_token(cfg) + _head(cfg))
    attend = 2 * 2 * cfg.num_heads * cfg.head_dim * _n_attn(cfg)
    return len(keys) * per_row + attend * int(sum(keys))


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """One training step over ``batch`` sequences of ``seq`` tokens, the
    head over every position: three times the forward."""
    return 3 * batch * prefill_flops(cfg, seq, head_rows=seq)
