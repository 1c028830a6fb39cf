"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 64 experts top-8.
16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50_304, head_dim=128, mlp_kind="swiglu",
    num_experts=64, top_k=8,
    param_dtype="bfloat16",
)
