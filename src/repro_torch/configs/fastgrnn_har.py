"""The paper's own deployment config (Table X): FastGRNN on HAPT.
H=16, d=3, T=128 @ 50 Hz, 6 classes, r_w=2, r_u=8, s=0.5, Q15+calibration,
256-entry LUT over [-8, 8].  (Reference ``repro.configs.fastgrnn_har``,
with the port's config classes.)"""
from repro_torch.core.fastgrnn import FastGRNNConfig
from repro_torch.core.compression import IHTConfig
from repro_torch.core.quantization import QuantConfig

CELL = FastGRNNConfig(input_dim=3, hidden_dim=16, num_classes=6,
                      rank_w=2, rank_u=8)
CELL_FULL_RANK = FastGRNNConfig(input_dim=3, hidden_dim=16, num_classes=6)
IHT = IHTConfig(target_sparsity=0.5, ramp_epochs=50, finetune_epochs=50)
QUANT = QuantConfig(bits=16, calibration_batches=5, headroom=0.10)

EPOCHS = 100
BATCH_SIZE = 64
LEARNING_RATE = 1e-3
SEEDS = (0, 1, 2, 3, 4)
WINDOW = 128
SAMPLE_RATE_HZ = 50.0
