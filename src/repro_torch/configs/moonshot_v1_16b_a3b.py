"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 64e top-6 MoE.
48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163_840, head_dim=128, mlp_kind="swiglu",
    num_experts=64, top_k=6,
    param_dtype="bfloat16",
)
