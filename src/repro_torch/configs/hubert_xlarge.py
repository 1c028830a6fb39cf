"""HuBERT-XLarge [arXiv:2106.07447; unverified]: encoder-only audio.
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets).
The conv waveform frontend is a stub: the inputs are precomputed
frame embeddings (B, S, 1280).  Encoder-only -> no decode shapes."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80, mlp_kind="gelu",
    causal=False, is_encoder=True, frontend="audio",
    param_dtype="bfloat16",
)
