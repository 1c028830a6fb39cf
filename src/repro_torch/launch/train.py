"""Training launcher (reference ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100 \\
        [--reduced] [--device cuda|cpu] [--seq N] [--global-batch N] \\
        [--mesh host|16x16|2x16x16]

Runs ``train.trainer.Trainer`` over ``registry.make_train_step`` and the
seekable token stream (``data.tokens``); restart-safe through its
checkpoints, which go to ``--ckpt-dir`` (default: under the package's
git-ignored ``_build/checkpoints/``).  The weights are drawn by
``registry.init`` from a ``torch.Generator`` on the device seeded
``--seed``: not the reference's values (JAX's PRNG is not reproduced).
``--device`` defaults to ``cuda`` and raises without a card.  The vlm and
audio families need patch or frame embeddings that the token stream does
not make, and are refused.

Several processes: start one per rank with torch's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` set (as ``torchrun`` sets
them; the reference reads ``JAX_COORDINATOR``), or call :func:`main` in
processes whose default group is already up.  The process group is
``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.  ``--mesh host`` lays every
rank along ``data``; ``16x16`` and ``2x16x16`` are the production meshes
(256 and 512 ranks).  Over more than one rank the step is
``registry.make_train_step(..., mesh=...)``: parameters and Adam moments
are DTensors placed by ``launch.sharding.param_pspecs``, every rank
draws the same weights and keeps its blocks, and checkpoints hold the
full arrays (rank 0 writes them).
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "16x16", "2x16x16"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--iht-sparsity", type=float, default=0.0,
                    help="recorded in the trainer's config; the trainer "
                         "does not apply it, nor does the reference's")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _mesh(args):
    """(mesh or None, this rank's device)."""
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as M
    if args.mesh == "host" and not dist.is_initialized() \
            and "WORLD_SIZE" not in os.environ:
        return None, resolve_device(args.device)
    dev = M.init_process_group(args.device)
    mesh = (M.make_host_mesh() if args.mesh == "host" else
            M.make_production_mesh(multi_pod=args.mesh == "2x16x16"))
    return (mesh if mesh.size() > 1 else None), dev


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    import torch
    from repro_torch import configs as C
    from repro_torch.data import tokens
    from repro_torch.launch import sharding as sh
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = C.get(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: a {cfg.family} model trains on "
                         f"{'patch' if cfg.family == 'vlm' else 'frame'} "
                         "embeddings, which the token stream does not make")
    mesh, dev = _mesh(args)
    if args.reduced:
        cfg = C.reduced(cfg)
    seq = args.seq or (64 if args.reduced else 4096)
    gbatch = args.global_batch or (8 if args.reduced else 256)
    acfg = AdamConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    tcfg = tokens.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=gbatch)
    step = registry.make_train_step(cfg, acfg, mesh=mesh)

    def init_params():
        params = registry.init(
            cfg, torch.Generator(device=dev).manual_seed(args.seed))
        if mesh is None:
            return params
        specs = sh.param_pspecs(registry.abstract_params(cfg), mesh)
        return sh.distribute(params, sh.named(mesh, specs))

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in tokens.lm_batch(tcfg, s).items()}

    name = args.arch + ("-reduced" if args.reduced else "")
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.ckpt_dir or os.path.join(
                          ckpt.DEFAULT_DIR, name),
                      iht_sparsity=args.iht_sparsity, adam=acfg),
        init_params_fn=init_params, step_fn=step, batch_fn=batch_fn,
        on_straggler=lambda s, dt, v: print(f"[straggler] step {s}: "
                                            f"{dt:.2f}s"))
    hist = trainer.run()
    losses = [h["loss"] for h in hist if "loss" in h]
    where = f"{dev}" if mesh is None else (
        f"{dev}, mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps, {trainer.restarts} restarts) on {where}")
    return hist


if __name__ == "__main__":
    main()
