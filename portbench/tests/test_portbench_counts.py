"""The benchmark's FLOP and byte counts against hand counts at small
shapes."""
import dataclasses

import pytest

from portbench.counts import kernels, model, peaks


@dataclasses.dataclass
class Cfg:
    family: str = "ssm"
    num_layers: int = 1
    d_model: int = 4
    mamba_headdim: int = 2       # d_inner 8, 4 heads
    mamba_groups: int = 1
    ssm_state: int = 2
    ssd_chunk: int = 2
    vocab_size: int = 10
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 2
    d_ff: int = 8
    mlp_kind: str = "gelu"
    attn_every: int = 1


def test_ssd_least_ops_by_hand():
    # h=g=p=n=1, s=2.  Chunk 1: triangle 2, 2 chunks: C B^T 2, M x 2,
    # C H + state sums 4; float32 1 * (4 * 2 + 2) = 10; tensor FLOP
    # 2 * 2 + 6 * 6 = 40.  Chunk 2: triangle 3, 1 chunk: float32 13.
    sec, q, fp32, flop = kernels.ssd_least_ops(1, 1, 2, 1, 1)
    assert (q, fp32, flop) == (1, 10, 40)
    assert sec == pytest.approx(10 / peaks.FP32_OPS_PER_S)


def test_ssd_and_q15_bytes_by_hand():
    # x, y (3, 2, 4) bf16 = 96; dt (3, 2) f32 = 24; A 8; B, C (3, 1, 5)
    # bf16 = 60; state (2, 5, 4) f32 = 160
    assert kernels.ssd_bytes(2, 1, 3, 4, 5) == 348
    # x (2, 3) f32 24, w (3, 5) int16 30, scale 4, out (2, 5) f32 40
    assert kernels.q15_matmul_bytes(2, 3, 5) == 98
    assert kernels.q15_matmul_least_s(2, 3, 5) == pytest.approx(
        98 / peaks.HBM_BYTES_PER_S)
    big = kernels.q15_matmul_least_s(8, 1536, 151936)
    assert big == pytest.approx((8 * 1536 * 4 + 1536 * 151936 * 2 + 4
                                 + 8 * 151936 * 4) / 3.35e12)


def test_model_flops_by_hand():
    c = Cfg()
    # per token: projections 2*4*(16+4+4) = 192, conv 2*4*(8+4) = 96,
    # out 2*8*4 = 64 -> 352.  SSD at s=3, chunk 2: triangles 3 + 1 = 4,
    # 2 chunks: C B^T 2*1*2*4 = 16, M x 2*4*2*4 = 64, states and their
    # outputs 4*4*3*2*2 = 192, passing 2*4*2*2*2 = 64 -> 336.  Head
    # 2*4*10 = 80.
    assert model.ssd_chunked_flops(c, 3) == 336
    assert model.prefill_flops(c, 3) == 3 * 352 + 336 + 80
    # decode: per row 352 + 6*4*2*2 + 80 = 528
    assert model.decode_flops(c, [3, 4]) == 2 * 528
    assert model.train_step_flops(c, 2, 3) == 3 * 2 * (3 * 352 + 336
                                                       + 3 * 80)


def test_hybrid_attention_flops_by_hand():
    c = Cfg(family="hybrid", num_layers=2, attn_every=2)
    # one application: q k v o 2*4*2*(2*2 + 2*2) = 128 a token, MLP
    # 2*2*4*8 = 128; causal scores and mixing at s=3: 2*2*2*2*6 = 96
    attn = 3 * 256 + 96
    ssm = 2 * (3 * 352 + 336)
    assert model.prefill_flops(c, 3) == ssm + attn + 80
    # decode over keys 5: per row 2*(352+96) + 256 + 80, scores 2*2*2*2*5
    assert model.decode_flops(c, [5]) == 2 * 448 + 256 + 80 + 80
