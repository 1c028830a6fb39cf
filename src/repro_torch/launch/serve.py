"""Serving launcher (reference ``repro.launch.serve``): batched generation
through ``serve.engine.Engine`` with optional Q7/Q15 weights, on one
device.

    python -m repro_torch.launch.serve --arch mamba2-780m --reduced \\
        --quant-bits 8 --new-tokens 32 [--device cuda|cpu] [--ckpt-dir D]

The weights are drawn by ``registry.init`` from a ``torch.Generator``
seeded ``--seed``, or, with ``--ckpt-dir``, the parameters of that
directory's latest checkpoint (``launch.train``'s), restored onto the
device alone, without the optimizer state.  ``--device`` defaults to
``cuda`` and raises without a card.  An encoder-only arch has no decode
step and exits, as in the reference; a vlm exits too, naming ROADMAP C6:
its requests need patch embeddings, which this launcher has none of.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quant-bits", type=int, default=0, choices=[0, 8, 16])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import checkpoint as ckpt

    cfg = C.get(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only")
    if cfg.family == "vlm":
        raise SystemExit(f"{args.arch}: a vlm request needs its patch "
                         "embeddings (Engine.submit's extra), which this "
                         "launcher has none of (ROADMAP C6)")
    dev = resolve_device(args.device)
    if args.reduced:
        cfg = C.reduced(cfg)
    if args.ckpt_dir:
        step = ckpt.latest_step(args.ckpt_dir)
        if step is None:
            raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
        params = ckpt.restore(args.ckpt_dir, step,
                              {"params": registry.abstract_params(cfg)},
                              device=dev)["params"]
    else:
        params = registry.init(
            cfg, torch.Generator(device=dev).manual_seed(args.seed))
    eng = Engine(cfg, params,
                 ServeConfig(max_len=args.prompt_len + args.new_tokens + 1,
                             quant_bits=args.quant_bits,
                             temperature=args.temperature), device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    out = eng.generate(prompts, max_new=args.new_tokens)
    print(f"generated {out.shape} tokens "
          f"(quant_bits={args.quant_bits or 'off'}) on {dev}")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
