"""Closed-form per-cell FLOPs and HBM bytes for the roofline (reference
``repro.launch.analytic``), pure arithmetic over the configs.

The reference computes its roofline terms from these formulas because
XLA's ``cost_analysis()`` counts a while-loop body once, so scanned layers
undercount by the depth; a torch step has no compiled cost to read at
all, so the port takes the same formulas.  Every count is GLOBAL (the
whole step on all devices); ``launch.roofline`` divides by the mesh
factors.  FLOPs = 2 * MACs everywhere.  Equal (``==``) to the reference's
for every config and shape (``tests/test_torch_launch_cost.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.moe import capacity


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops_fwd: float            # one forward pass, global
    flops_total: float          # step total (train: fwd + remat + bwd)
    weight_bytes_per_pass: float  # weight HBM reads, one pass, global
    act_bytes: float            # activation HBM traffic, whole step, global
    cache_bytes: float          # decode: KV/SSM cache traffic per step
    opt_bytes: float            # optimizer state + master param RW (train)
    param_count: float
    notes: str = ""

    @property
    def hbm_bytes_total(self) -> float:
        passes = 3.0 if self.flops_total > 1.5 * self.flops_fwd else 1.0
        return (self.weight_bytes_per_pass * passes + self.act_bytes
                + self.cache_bytes + self.opt_bytes)


def _attn_flops_per_token(cfg: ModelConfig, s_ctx: float) -> float:
    """QK^T + PV flops per token at average context s_ctx."""
    A = cfg.num_heads * cfg.head_dim
    return 4.0 * s_ctx * A


def _proj_flops_per_token(cfg: ModelConfig) -> float:
    d = cfg.d_model
    A = cfg.num_heads * cfg.head_dim
    Kv = cfg.num_kv_heads * cfg.head_dim
    return 2.0 * d * (A + 2 * Kv) + 2.0 * A * d


def _mlp_flops_per_token(cfg: ModelConfig, d_ff: int) -> float:
    mults = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return 2.0 * mults * cfg.d_model * d_ff


def _moe_flops_per_token(cfg: ModelConfig, n_tokens_per_shard: float) -> tuple[float, float]:
    """(ideal, with capacity padding) flops per token."""
    router = 2.0 * cfg.d_model * cfg.num_experts
    ideal = cfg.top_k * _mlp_flops_per_token(cfg, cfg.d_ff)
    cap = capacity(int(n_tokens_per_shard), cfg.top_k, cfg.num_experts,
                   cfg.capacity_factor)
    pad_factor = cap * cfg.num_experts / max(n_tokens_per_shard * cfg.top_k, 1)
    return router + ideal, router + ideal * pad_factor


def _mamba_flops_per_token(cfg: ModelConfig, decode: bool) -> float:
    d = cfg.d_model
    di = 2 * d
    P = cfg.mamba_headdim
    H = di // P
    g, n = cfg.mamba_groups, cfg.ssm_state
    proj = 2.0 * d * (2 * di + 2 * g * n + H) + 2.0 * di * d
    conv = 2.0 * 4 * (di + 2 * g * n)
    if decode:
        ssd = 2.0 * H * (3 * n * P)                       # state update + y
    else:
        Q = cfg.ssd_chunk
        # intra: scores Q*N + y_diag Q*P per (token, head); states/off 2*N*P
        ssd = 2.0 * H * (Q * n + Q * P + 2 * n * P)
    return proj + conv + ssd


def _layer_flops_per_token(cfg: ModelConfig, s_ctx: float, decode: bool,
                           tokens_per_shard: float) -> tuple[float, float]:
    """(ideal, padded) — identical unless MoE capacity padding applies."""
    if cfg.family == "ssm":
        f = _mamba_flops_per_token(cfg, decode)
        return f, f
    if cfg.family == "hybrid":
        f = _mamba_flops_per_token(cfg, decode)
        # shared attn+mlp block amortized over attn_every mamba layers
        shared = (_proj_flops_per_token(cfg) + _attn_flops_per_token(cfg, s_ctx)
                  + _mlp_flops_per_token(cfg, cfg.d_ff)) / cfg.attn_every
        return f + shared, f + shared
    base = _proj_flops_per_token(cfg) + _attn_flops_per_token(cfg, s_ctx)
    if cfg.family == "moe":
        ideal, padded = _moe_flops_per_token(cfg, tokens_per_shard)
        return base + ideal, base + padded
    f = base + _mlp_flops_per_token(cfg, cfg.d_ff)
    return f, f


def _param_bytes(cfg: ModelConfig, n_params: float) -> float:
    return n_params * (2 if cfg.param_dtype == "bfloat16" else 4)


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, *, n_params: float,
              batch_shards: int = 32, act_itemsize: int = 2,
              weight_quant_bits: int = 0) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    n_tokens = B * (1 if decode else S)
    if decode:
        s_ctx = S
    else:
        s_ctx = (S + 1) / 2 if cfg.causal else S
        if cfg.sliding_window and shape.name == "long_500k":
            s_ctx = min(s_ctx, cfg.sliding_window)
    tokens_per_shard = n_tokens / batch_shards

    ideal_tok, padded_tok = _layer_flops_per_token(cfg, s_ctx, decode,
                                                   tokens_per_shard)
    fwd = n_tokens * padded_tok * cfg.num_layers
    # unembed (+ vlm patch positions add tokens for every layer: approximate
    # by inflating token count for vlm)
    if cfg.family == "vlm" and not decode:
        fwd *= (S + cfg.num_patches) / S
    fwd += n_tokens * 2.0 * cfg.d_model * cfg.vocab_size
    if shape.kind == "train":
        remat = 1.0 if cfg.remat else 0.0
        total = fwd * (3.0 + remat)
    else:
        total = fwd

    wb = _param_bytes(cfg, n_params)
    if weight_quant_bits:
        wb = n_params * weight_quant_bits / 8.0   # L-S-Q serving weights
    act = n_tokens * cfg.d_model * cfg.num_layers * act_itemsize * 8.0
    if shape.kind == "train":
        act *= 3.0
    cache = 0.0
    if decode:
        if cfg.uses_attention:
            n_attn = (cfg.num_layers if cfg.family != "hybrid"
                      else cfg.num_layers // max(cfg.attn_every, 1))
            ctx = min(S, cfg.sliding_window) if (cfg.sliding_window and
                                                 shape.name == "long_500k") else S
            cache += n_attn * B * ctx * cfg.num_kv_heads * cfg.head_dim * 2 * 2
        if cfg.uses_mamba:
            di = 2 * cfg.d_model
            H = di // cfg.mamba_headdim
            cache += (cfg.num_layers * B * H * cfg.ssm_state *
                      cfg.mamba_headdim * 4 * 2)   # f32 read+write
    opt = 0.0
    if shape.kind == "train":
        os_bytes = 2 if cfg.opt_state_dtype == "bfloat16" else 4
        opt = n_params * (2 * os_bytes * 2 + 2 * _param_bytes(cfg, 1))  # m,v RW + p RW
    notes = ""
    if cfg.family == "moe":
        notes = f"moe capacity padding x{padded_tok / ideal_tok:.2f}"
    return CellCost(flops_fwd=fwd, flops_total=total,
                    weight_bytes_per_pass=wb, act_bytes=act,
                    cache_bytes=cache, opt_bytes=opt,
                    param_count=n_params, notes=notes)
