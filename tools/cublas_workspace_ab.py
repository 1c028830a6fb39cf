#!/usr/bin/env python3
"""Time phase 15's L-S-Q training loop (``core.pipeline.train_fastgrnn`` on
the card, ``configs.fastgrnn_har``, seed 0) with and without
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, in turns, each run in a fresh
process (cuBLAS reads the variable once, when it starts).

    python3 tools/cublas_workspace_ab.py [--pairs 2] [--epochs 2]

Each pair runs without, with, with, without; every run prints its
ms/step p50 and p99 over ``--epochs`` epochs of 64-window steps.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ":4096:8"


def one_run(epochs: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    from repro_torch.configs import fastgrnn_har as paper
    from repro_torch.core import compression as comp
    from repro_torch.core import pipeline as pl
    from repro_torch.data import hapt

    if not torch.cuda.is_available():
        raise SystemExit("cublas_workspace_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    train = hapt.generate_synthetic("train", 0)
    iht = comp.IHTConfig(target_sparsity=paper.IHT.target_sparsity,
                         ramp_epochs=epochs // 2,
                         finetune_epochs=epochs - epochs // 2)
    res = pl.train_fastgrnn(paper.CELL, train.windows, train.labels,
                            epochs=epochs, batch_size=paper.BATCH_SIZE,
                            lr=paper.LEARNING_RATE, seed=0, iht=iht,
                            device="cuda")
    ms = np.asarray(res.step_seconds) * 1e3
    print(f"CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG', 'unset')}: "
          f"{len(ms)} steps, ms/step p50 {np.percentile(ms, 50):.3f} p99 "
          f"{np.percentile(ms, 99):.3f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_run(args.epochs)
        return 0
    base = {k: v for k, v in os.environ.items()
            if k != "CUBLAS_WORKSPACE_CONFIG"}
    for _ in range(args.pairs):
        for config in (None, CONFIG, CONFIG, None):
            env = dict(base, **({"CUBLAS_WORKSPACE_CONFIG": config}
                                if config else {}))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", "--epochs", str(args.epochs)],
                           env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
