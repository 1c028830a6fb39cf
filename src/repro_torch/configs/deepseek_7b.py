"""DeepSeek-LLM-7B [arXiv:2401.02954; hf]: llama-arch MHA.
30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400, SwiGLU."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102_400, head_dim=128, mlp_kind="swiglu",
    param_dtype="bfloat16",
)
