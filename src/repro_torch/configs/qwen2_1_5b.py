"""Qwen2-1.5B [arXiv:2407.10671; hf]: GQA with QKV bias.
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, SwiGLU, tied embeds."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151_936, head_dim=128, mlp_kind="swiglu",
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)
