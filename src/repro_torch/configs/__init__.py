"""Architecture configs: the ten LM architectures, copied as data
from the reference ``repro.configs``.  ``get(name)`` returns a
:class:`ModelConfig`; ``ARCHS`` maps their ids to their configs;
``reduced`` makes a tiny same-family config for CPU tests.  (The paper's
own ``fastgrnn_har`` cell config is ``repro_torch.core.fastgrnn``'s.)"""
import dataclasses as _dc

from .base import ModelConfig, ShapeConfig, SHAPES, applicable  # noqa: F401

from . import (minitron_4b, qwen2_1_5b, deepseek_7b, nemotron_4_340b,
               olmoe_1b_7b, moonshot_v1_16b_a3b, internvl2_76b,
               zamba2_1_2b, hubert_xlarge, mamba2_780m)  # noqa: F401

ARCHS = {
    "minitron-4b": minitron_4b.CONFIG,
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "nemotron-4-340b": nemotron_4_340b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU tests (small layers and width, few
    experts, tiny vocab), the reference's ``reduced``."""
    small = dict(
        num_layers=2, d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128 if cfg.vocab_size else 0,
        head_dim=16 if cfg.num_heads else 0,
        num_experts=4 if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        mamba_headdim=16 if cfg.uses_mamba else 64,
        attn_every=2 if cfg.attn_every else 0,
        num_patches=8 if cfg.frontend == "vision" else cfg.num_patches,
        ssd_chunk=32,
        remat=False,
    )
    small.update(overrides)
    return _dc.replace(cfg, **small)
