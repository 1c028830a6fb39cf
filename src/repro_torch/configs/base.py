"""Config dataclasses: architectures, input shapes, applicability rules
(a copy of the reference ``repro.configs.base``; ``pdtype`` and ``cdtype``
are ``torch.dtype``s)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"        # swiglu | geglu | gelu | relu2
    causal: bool = True
    is_encoder: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    mamba_headdim: int = 64
    mamba_groups: int = 1
    attn_every: int = 0             # hybrid: shared attn+mlp block period
    sliding_window: int | None = None  # used for hybrid long-context cells
    ssd_chunk: int = 256
    # modality frontend stubs
    frontend: str | None = None     # "vision" | "audio"
    num_patches: int = 256          # vision stub: patches per image
    # numerics / training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    opt_state_dtype: str = "float32"
    z_loss: float = 1e-4
    aux_loss_weight: float = 0.01
    # L-S-Q compression hooks (the paper's technique at LM scale)
    lsq_rank: int | None = None     # low-rank factorized FFN dense layers
    lsq_sparsity: float = 0.0       # IHT target sparsity during training
    lsq_quant_bits: int = 0         # 0=off, 8/16 -> serving weight quant

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_mamba(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Encoder-only archs skip decode shapes; long_500k runs only for
    sub-quadratic (ssm/hybrid) archs."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k needs sub-quadratic attention (ssm/hybrid only)"
    return True, ""
