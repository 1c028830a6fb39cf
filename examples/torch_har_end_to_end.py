"""End-to-end run on the PyTorch port (the paper's kind: train-then-
deploy on-device HAR).

    PYTHONPATH=src python examples/torch_har_end_to_end.py [--fast]
        [--seed 0] [--epochs N] [--device cuda|cpu]

The port's counterpart of ``examples/har_end_to_end.py``, the full Fig.-1
flow at paper scale: float training (100 epochs; ``--fast``: 50 on 2,500
windows; ``--epochs`` sets the count) -> low-rank -> IHT sparsity (cubic
ramp) -> Q15 + activation calibration -> deterministic deploy -> 50 Hz
streaming simulation with warm-up characterization and the MCU
latency/energy model report.  ``--device`` defaults to ``cuda`` and
raises without a card.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import fastgrnn_har as paper
from repro_torch.core import compression as comp
from repro_torch.core import energy as en
from repro_torch.core import mcu, warmup
from repro_torch.core import pipeline as pl
from repro_torch.data import hapt

parser = argparse.ArgumentParser()
parser.add_argument("--fast", action="store_true",
                    help="reduced data/epochs (CI-sized)")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--epochs", type=int, default=None,
                    help="training epochs (default: 50 with --fast, else "
                         "the paper's)")
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

n_train = 2500 if args.fast else None
epochs = args.epochs or (50 if args.fast else paper.EPOCHS)
train = hapt.load("train", n=n_train)
test = hapt.load("test", n=800 if args.fast else None)

print(f"== training FastGRNN (H=16, r_w=2, r_u=8, s=0.5) "
      f"{epochs} epochs on {len(train.labels)} windows ==")
iht = comp.IHTConfig(target_sparsity=0.5, ramp_epochs=epochs // 2)
t0 = time.time()
res = pl.train_fastgrnn(paper.CELL, train.windows, train.labels,
                        epochs=epochs, seed=args.seed, iht=iht,
                        batch_size=paper.BATCH_SIZE, lr=paper.LEARNING_RATE,
                        device=args.device)
print(f"trained in {time.time()-t0:.0f}s")

nz = comp.deployed_param_count(res.params, res.masks)
print(f"deployed parameters: {nz} ({nz*2} bytes at Q15)")

print("== deploying: Q15 + 5-minibatch activation calibration ==")
rt = pl.deploy(res.params, train.windows[:5], device=args.device)
fp32 = pl.predict_fp32(res.params, test.windows, device=args.device)
q15 = rt.predict_batch(test.windows)
print(f"FP32 macro-F1 : {pl.macro_f1(test.labels, fp32):.4f}")
print(f"Q15  macro-F1 : {pl.macro_f1(test.labels, q15):.4f}")
print(f"agreement     : {pl.agreement(fp32, q15)*100:.2f}% "
      f"on {len(test.labels)} windows")

print("== 50 Hz streaming simulation: warm-up latency (paper Sec. VI-A) ==")
preds = []
for w in test.windows[:100]:
    _, traj = rt.run_window(w, return_trajectory=True)
    step_logits = traj @ np.asarray(rt._w["head_w"]) + np.asarray(rt._head_b)
    preds.append(np.argmax(step_logits, -1))
stats = warmup.characterize(np.stack(preds))
print(f"warm-up: {stats.row()}")

print("== MCU latency/energy model (fitted to the paper's measurements) ==")
for plat in (mcu.ARDUINO, mcu.MSP430):
    t = mcu.step_latency_s(paper.CELL, plat, lut=True)
    print(f"{plat.name:32s}: {t*1e3:5.2f} ms/sample "
          f"({mcu.budget_use(paper.CELL, plat)*100:.0f}% of 20 ms budget), "
          f"LUT speedup {mcu.lut_speedup(paper.CELL, plat):.1f}x")
print(f"energy: {en.LUT_BUILD.e_inference_uj:.0f} uJ/inference, "
      f"{en.LUT_BUILD.e_window_mj:.1f} mJ/window, "
      f"battery {en.LUT_BUILD.battery_hours(False):.0f} h streaming")
