"""CLI: compose compression passes from a config and emit one artifact.

    PYTHONPATH=src python -m repro_torch.compress --preset q15-deploy \
        --out model.fgar --report report.json [--device cpu]

    PYTHONPATH=src python -m repro_torch.compress --config recipe.json \
        --params checkpoint.npz --out model.fgar

Config file shape: a list of pass specs, or ``{"name": ..., "passes":
[...]}``, as the reference CLI ``python -m repro.compress`` reads::

    {"name": "deploy-q15",
     "passes": [
        {"pass": "iht_sparsify", "sparsity": 0.5},
        {"pass": "quantize_ptq", "bits": 15},
        {"pass": "calibrate_activations",
         "windows": "hapt:train:5", "scope": "deploy"},
        {"pass": "pack_lut"}]}

``--device`` (default ``cuda``) is where IHT and quantization run; the
bytes do not depend on it.  With ``--params`` the artifact is byte-
identical to the reference CLI's for the same recipe.  Without it the
float checkpoint is ``core.fastgrnn.init_params`` drawn from a CPU
``torch.Generator`` seeded ``--seed``, which is not the reference's
threefry draw, so those bytes differ from the reference CLI's.  The
emitted ``--report`` JSON carries ``"benchmark": "compress_artifact"``
and validates under ``benchmarks/validate_bench.py``.  ``--emit-image``
also lowers the artifact to a packed deploy image (``.fgrn``) through
``repro_torch.deploy.image.build_image``: the reference CLI's bytes for
the same ``--params``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

from repro_torch.deploy.image import build_image

from .artifact import ModelArtifact
from .pipeline import default_deploy_pipeline, pipeline_from_config

PRESETS = {
    "q15-deploy": lambda device: default_deploy_pipeline(
        bits=15, device=device),
    "q7-deploy": lambda device: default_deploy_pipeline(
        bits=7, device=device),
    "q15-sparse-deploy": lambda device: default_deploy_pipeline(
        bits=15, sparsity=0.5, device=device),
}


def _load_params(args) -> dict:
    if args.params:
        with np.load(args.params, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    from repro_torch.core import fastgrnn as fg
    cfg = fg.FastGRNNConfig(rank_w=args.rank_w or None,
                            rank_u=args.rank_u or None)
    return fg.init_params(cfg, torch.Generator().manual_seed(args.seed))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compress", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_argument_group("model source")
    src.add_argument("--params", default=None,
                     help="float checkpoint .npz (name -> array); default: "
                          "init_params from a CPU torch.Generator seeded "
                          "--seed")
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--rank-w", type=int, default=2)
    src.add_argument("--rank-u", type=int, default=8)
    rec = ap.add_argument_group("recipe")
    rec.add_argument("--config", default=None,
                     help="JSON pipeline config (list of pass specs)")
    rec.add_argument("--preset", default=None, choices=sorted(PRESETS),
                     help="built-in recipe instead of --config")
    rec.add_argument("--device", default="cuda",
                     help="where IHT and quantization run (cuda or cpu); "
                          "the bytes do not depend on it")
    out = ap.add_argument_group("outputs")
    out.add_argument("--out", default=None,
                     help="artifact path (.fgar); omit for a dry run")
    out.add_argument("--report", default=None,
                     help="size-report JSON path, or - for stdout")
    out.add_argument("--emit-image", default=None,
                     help="also lower to a packed deploy image (.fgrn)")
    args = ap.parse_args(argv)

    if args.config and args.preset:
        ap.error("--config and --preset are mutually exclusive")
    if args.config:
        with open(args.config) as f:
            pipe = pipeline_from_config(json.load(f), device=args.device)
    else:
        pipe = PRESETS[args.preset or "q15-deploy"](args.device)

    art = pipe.run(ModelArtifact.from_params(_load_params(args)))
    blob = art.to_bytes()
    sha = hashlib.sha256(blob).hexdigest()
    print(art.summary())
    for r in art.provenance:
        print(f"  pass {r['pass']}")

    if args.out:
        with open(args.out, "wb") as f:
            f.write(blob)
        print(f"wrote {args.out} ({len(blob)} bytes, sha256 {sha[:16]}...)")
    if args.emit_image:
        img = build_image(art)
        with open(args.emit_image, "wb") as f:
            f.write(img.to_bytes())
        print(f"wrote {args.emit_image} ({img.nbytes()} bytes)")
    if args.report:
        report = {"benchmark": "compress_artifact",
                  "pipeline": pipe.name,
                  "sha256": sha,
                  "artifact_bytes": len(blob),
                  "size": art.size_report(),
                  "provenance": art.provenance}
        blob = json.dumps(report, indent=2)
        if args.report == "-":
            print(blob)
        else:
            with open(args.report, "w") as f:
                f.write(blob + "\n")
            print(f"wrote {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
