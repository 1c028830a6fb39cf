"""Mamba2-780m [arXiv:2405.21060; unverified]: pure SSD, attention-free.
48L d_model=1536, ssm_state=128, vocab=50280, d_inner=2*d_model,
headdim=64 (48 ssm heads), no MLP (d_ff=0)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280, mlp_kind="swiglu",
    ssm_state=128, mamba_headdim=64,
    param_dtype="bfloat16",
)
