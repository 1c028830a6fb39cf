"""Quickstart on the PyTorch port: the paper's L-S-Q pipeline in ~40 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
        [--epochs 40]

The port's counterpart of ``examples/quickstart.py``: trains a low-rank
FastGRNN on (synthetic) HAPT, applies IHT sparsity + calibrated Q15
quantization, and runs the deterministic integer runtime, printing F1 and
FP32-vs-Q15 agreement.  ``--device`` defaults to ``cuda`` and raises
without a card; the initial weights are a ``torch.Generator`` draw, not
the reference's.
"""
import argparse

from repro_torch.core import compression as comp
from repro_torch.core import fastgrnn as fg
from repro_torch.core import pipeline as pl
from repro_torch.data import hapt

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
parser.add_argument("--epochs", type=int, default=40)
args = parser.parse_args()

# 1. data (synthetic HAPT: 128-sample tri-axial windows @ 50 Hz, 6 classes)
train = hapt.load("train", n=2000)
test = hapt.load("test", n=600)

# 2. train the low-rank cell (paper config: H=16, r_w=2, r_u=8)
cfg = fg.FastGRNNConfig(rank_w=2, rank_u=8)
iht = comp.IHTConfig(target_sparsity=0.5, ramp_epochs=args.epochs // 2)
result = pl.train_fastgrnn(cfg, train.windows, train.labels,
                           epochs=args.epochs, seed=0, iht=iht,
                           device=args.device)

# 3. deploy: per-tensor Q15 + activation calibration -> integer runtime
runtime = pl.deploy(result.params, train.windows[:5], device=args.device)

# 4. evaluate both paths
fp32_pred = pl.predict_fp32(result.params, test.windows, device=args.device)
q15_pred = runtime.predict_batch(test.windows)
print(f"FP32  macro-F1: {pl.macro_f1(test.labels, fp32_pred):.3f}")
print(f"Q15   macro-F1: {pl.macro_f1(test.labels, q15_pred):.3f}")
print(f"FP32-vs-Q15 prediction agreement: "
      f"{pl.agreement(fp32_pred, q15_pred)*100:.2f}%")
print(f"deployed weights: "
      f"{comp.deployed_param_count(result.params, result.masks) * 2} bytes")
