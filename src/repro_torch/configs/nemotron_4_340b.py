"""Nemotron-4-340B [arXiv:2402.16819; unverified]: GQA + squared-ReLU.
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Params and optimizer moments in bf16."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18_432, num_heads=96, num_kv_heads=8,
    d_ff=73_728, vocab_size=256_000, head_dim=192, mlp_kind="relu2",
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
)
