"""Golden-trace generation for the deployment parity protocol, ported from
the reference ``repro.deploy.goldens``.

A *golden* pins down the full deployed behavior of one exported model on a
fixed batch of HAPT windows:

  * per-step int16 hidden-state trajectories for the first ``n_trace``
    windows (the cross-platform bit-equivalence witness — paper
    contribution (i)),
  * final int32 logits + argmax for every window,
  * the image byte digest, so a golden can only be replayed against the
    exact export that produced it.

Goldens are deterministic end to end: synthetic HAPT is crc32-seeded,
PTQ/calibration are round-to-nearest, and the qvm is integer-only.

Two deliberate divergences from the reference (ROADMAP Queue C):

  * the default model init is ``core.fastgrnn.init_params`` drawn from a
    CPU ``torch.Generator`` seeded ``seed``, not the reference's threefry
    key, so only a run given ``params=`` reproduces the reference's
    artifact (and its committed fixture ``tests/goldens/qvm_reference_s0.npz``);
  * the CLI never writes into ``tests/goldens/``, the reference's
    committed fixture: ``--out`` defaults to the gitignored
    ``src/repro_torch/_build/goldens`` and a path inside ``tests/goldens``
    is refused::

    PYTHONPATH=src python -m repro_torch.deploy.goldens [--out DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import os
from typing import Any

import numpy as np
import torch

from repro_torch.compress import ModelArtifact, default_deploy_pipeline
from repro_torch.core import fastgrnn as fg
from repro_torch.core.quantization import QuantizedParams
from repro_torch.data import hapt
from .image import DeployImage, build_image
from .qvm import QVM

# Fixture geometry: small enough to check in, big enough to exercise the
# recurrence (8 full 128-step trajectories + 256 window predictions).
N_TRACE = 8
N_WINDOWS = 256
CALIB_WINDOWS = 5
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The CLI's default output directory (gitignored), and the reference's
#: committed fixture directory, which the CLI refuses to write into.
DEFAULT_OUT = os.path.join(_PORT, "_build", "goldens")
REFERENCE_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(_PORT)),
                                  "tests", "goldens")


def build_reference_artifact(seed: int = 0, low_rank: bool = True,
                             params: dict | None = None,
                             calib: np.ndarray | None = None,
                             bits: int = 15, *,
                             device: str = "cuda") -> ModelArtifact:
    """Deterministic calibrated model -> compression artifact.

    By default: the paper's low-rank H=16 r_w=2 r_u=8 FastGRNN at random
    init (a CPU ``torch.Generator`` seeded ``seed``) through the
    ``default_deploy_pipeline`` (PTQ at ``bits`` on ``device`` -> Sec.
    III-D 5-window deploy calibration on synthetic HAPT train data -> LUT
    pack).  The bytes do not depend on ``device``.  Pass ``params`` (e.g.
    trained weights, or the reference's init carried across as NumPy) to
    export that checkpoint; ``bits=7`` builds the Q7 artifact.
    """
    if params is None:
        cfg = fg.FastGRNNConfig(rank_w=2 if low_rank else None,
                                rank_u=8 if low_rank else None)
        params = fg.init_params(cfg, torch.Generator().manual_seed(seed))
    if calib is None:
        calib = f"hapt:train:{CALIB_WINDOWS}"
    pipe = default_deploy_pipeline(bits=bits, calib=calib, device=device)
    return pipe.run(ModelArtifact.from_params(params))


def build_reference_model(seed: int = 0, low_rank: bool = True,
                          params: dict | None = None,
                          calib: np.ndarray | None = None, *,
                          device: str = "cuda",
                          ) -> tuple[QuantizedParams, dict[str, float], DeployImage]:
    """The reference artifact unpacked into the ``(qp, act_scales,
    image)`` triple."""
    art = build_reference_artifact(seed=seed, low_rank=low_rank,
                                   params=params, calib=calib, device=device)
    return art.qp, dict(art.act_scales), build_image(art)


def generate_goldens(img: DeployImage, windows: np.ndarray,
                     n_trace: int = N_TRACE) -> dict[str, Any]:
    """Run the qvm over ``windows`` and freeze its observable behavior."""
    vm = QVM(img)
    xq = vm.quantize_input(windows)
    logits, traces = vm.run_windows(xq[:n_trace], return_trajectory=True)
    all_logits = vm.run_windows(xq)
    blob = img.to_bytes()
    return {
        "image_sha256": hashlib.sha256(blob).hexdigest(),
        "image_bytes": np.frombuffer(blob, np.uint8),
        "xq": xq,
        "traces": traces,                       # (n_trace, T, H) int16
        "trace_logits": logits,                 # (n_trace, C) int32
        "logits": all_logits,                   # (N, C) int32
        "preds": np.argmax(all_logits, axis=1).astype(np.int32),
    }


def save_goldens(goldens: dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **goldens)


def load_goldens(path: str) -> dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        return {k: (z[k] if z[k].ndim else z[k].item()) for k in z.files}


def default_fixture(seed: int = 0, *, device: str = "cuda") -> dict[str, Any]:
    """The fixture: reference model + deterministic test windows (the
    synthetic split, as ``hapt.load`` reads no other without a root)."""
    _, _, img = build_reference_model(seed=seed, device=device)
    windows = hapt.load("test", n=N_WINDOWS).windows
    return generate_goldens(img, windows)


def _inside(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory for the .npz fixtures (never inside "
                         "tests/goldens)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where PTQ runs (cuda or cpu); the bytes do not "
                         "depend on it")
    ap.add_argument("--check", action="store_true",
                    help="verify existing fixtures instead of writing")
    args = ap.parse_args(argv)
    if not args.check and _inside(args.out, REFERENCE_FIXTURES):
        ap.error(f"--out {args.out} is inside tests/goldens, the "
                 "reference's committed fixtures: choose another directory")
    g = default_fixture(seed=args.seed, device=args.device)
    path = os.path.join(args.out, f"qvm_reference_s{args.seed}.npz")
    if args.check:
        old = load_goldens(path)
        for k in ("image_bytes", "xq", "traces", "trace_logits", "logits", "preds"):
            np.testing.assert_array_equal(old[k], g[k], err_msg=k)
        assert old["image_sha256"] == g["image_sha256"]
        print(f"OK: {path} reproduces bit-for-bit")
    else:
        save_goldens(g, path)
        print(f"wrote {path} (image sha256 {g['image_sha256'][:16]}..., "
              f"{g['preds'].shape[0]} windows, {g['traces'].shape[0]} traces)")


if __name__ == "__main__":
    main()
