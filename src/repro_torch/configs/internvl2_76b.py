"""InternVL2-76B backbone [arXiv:2404.16821; unverified]:
InternLM2-76B language tower: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  The InternViT frontend is a stub: the inputs
are precomputed patch embeddings (B, 256, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28_672, vocab_size=128_256, head_dim=128, mlp_kind="swiglu",
    frontend="vision", num_patches=256,
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
)
