"""Minitron-4B: depth/width-pruned Nemotron [arXiv:2407.14679; hf].
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, squared-ReLU FFN."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256_000, head_dim=128, mlp_kind="relu2",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)
