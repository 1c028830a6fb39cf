"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share is
stated against these, with the card's power limit beside it."""

BF16_FLOP_PER_S = 989e12        # bfloat16 / float16 on the tensor cores
FP32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
FP32_OPS_PER_S = FP32_FLOP_PER_S / 2   # float32 instructions (an FMA is 2 FLOP)
HBM_BYTES_PER_S = 3.35e12       # HBM3
HBM_BYTES = 80e9
