"""LM-scale demo on the PyTorch port: train a reduced assigned architecture
with the production trainer (checkpointing, straggler monitor,
deterministic seekable data).

    PYTHONPATH=src python examples/torch_lm_train_demo.py --arch qwen2-1.5b \\
        --steps 200 [--device cuda|cpu]

The port's counterpart of ``examples/lm_train_demo.py``.  Use --arch with
any of the 10 assigned ids; the config is reduced to a small model of the
same family (the full configs are traced by the dry-run:
``python -m repro_torch.launch.dryrun``).  The weights are drawn from a
``torch.Generator`` on the device seeded 0, not the reference's;
checkpoints go to ``--ckpt-dir``, by default the package's git-ignored
``_build/checkpoints/lm_demo`` (a second run resumes from them).
``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse
import os

import torch

import repro_torch.configs as C
from repro_torch.data import tokens
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

parser = argparse.ArgumentParser()
parser.add_argument("--arch", default="qwen2-1.5b", choices=list(C.ARCHS))
parser.add_argument("--steps", type=int, default=200)
parser.add_argument("--batch", type=int, default=8)
parser.add_argument("--seq", type=int, default=64)
parser.add_argument("--ckpt-dir",
                    default=os.path.join(ckpt.DEFAULT_DIR, "lm_demo"))
parser.add_argument("--device", default="cuda")
args = parser.parse_args()
dev = resolve_device(args.device)

cfg = C.reduced(C.get(args.arch), d_model=128, num_layers=4,
                num_heads=4 if C.get(args.arch).num_heads else 0)
print(f"arch={cfg.name} family={cfg.family} reduced to "
      f"{cfg.num_layers}L x d{cfg.d_model}")

tcfg = tokens.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=args.batch)
acfg = AdamConfig(lr=1e-3, warmup_steps=20)
step = registry.make_train_step(cfg, acfg)


def batch_fn(s):
    b = tokens.lm_batch(tcfg, s)
    out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros(
            (args.batch, cfg.num_patches, cfg.d_model), dtype=torch.float32,
            device=dev)
    if cfg.family == "audio":
        out["frames"] = torch.randn(
            (args.batch, args.seq, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(s), device=dev)
    return out


trainer = Trainer(
    TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                  checkpoint_dir=args.ckpt_dir, log_every=20, adam=acfg),
    init_params_fn=lambda: registry.init(
        cfg, torch.Generator(device=dev).manual_seed(0)),
    step_fn=step, batch_fn=batch_fn,
    on_straggler=lambda s, dt, v: print(f"[straggler] step {s}: {dt:.2f}s"))

hist = trainer.run()
losses = [h["loss"] for h in hist if "loss" in h]
print(f"step 0 loss {losses[0]:.3f} -> step {len(losses)-1} "
      f"loss {losses[-1]:.3f}")
print(f"checkpoints in {args.ckpt_dir} (restart this script to resume)")
