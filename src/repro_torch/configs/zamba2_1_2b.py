"""Zamba2-1.2B [arXiv:2411.15242; hf]: Mamba2 backbone + ONE shared
attention+MLP block invoked periodically (weight sharing across depth —
the paper's shared-(W,U) idea at block scale).
38 mamba layers, d_model=2048, shared block: 32H (kv=32) d_ff=8192,
ssm_state=64.  long_500k uses sliding-window attention (w=4096) in the
shared block, so the long shape stays sub-quadratic."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_000, head_dim=64, mlp_kind="gelu",
    ssm_state=64, mamba_headdim=64, attn_every=6, sliding_window=4096,
    param_dtype="bfloat16",
)
