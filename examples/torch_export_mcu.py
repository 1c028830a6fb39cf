"""Export a calibrated FastGRNN to a deployable MCU artifact, end to end, on
the PyTorch port.

    PYTHONPATH=src python examples/torch_export_mcu.py [--outdir DIR]
        [--trained] [--windows 64] [--bits 15] [--device cuda|cpu]

The port's counterpart of ``examples/export_mcu.py`` (the paper's Fig. 1
deployment half):

  1. model     — low-rank FastGRNN (H=16, r_w=2, r_u=8), a
                 ``torch.Generator`` draw (``--trained`` trains the pinned
                 parity-protocol model first);
  2. compress  — ``QuantizePTQ`` (Q15, or Q7 with ``--bits 7``) ->
                 ``CalibrateActivations`` -> ``PackLUT``, recorded on one
                 ``ModelArtifact`` (``model.fgar``);
  3. pack      — the deterministic wire image (``model.fgrn``),
                 size-audited against the AVR + MSP430 budgets;
  4. emit      — C for all three targets x both engines;
  5. verify    — compile the host target with cc and check parity on a
                 window batch: float C bit-identical to the step engine
                 (the Q15 step kernel on ``cuda``), int C bit-identical to
                 the qvm emulator.

``--outdir`` defaults to the package's git-ignored ``_build/export``;
``--device`` defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.data import hapt
from repro_torch.deploy import emit_c, verify
from repro_torch.deploy.goldens import build_reference_artifact
from repro_torch.deploy.image import audit_platforms, build_image, size_report

OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                      "src", "repro_torch", "_build", "export")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outdir", default=os.path.normpath(OUTDIR))
    ap.add_argument("--trained", action="store_true",
                    help="train the pinned parity-protocol model first")
    ap.add_argument("--windows", type=int, default=64,
                    help="parity-check windows")
    ap.add_argument("--bits", type=int, default=15, choices=(15, 7),
                    help="weight format: 15 = Q15/int16 (paper), 7 = Q7/int8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1+2: model -> compression pipeline -> ONE artifact
    if args.trained:
        params, calib = verify.protocol_model(device=args.device)
        art = build_reference_artifact(params=params, calib=calib,
                                       bits=args.bits, device=args.device)
    else:
        art = build_reference_artifact(seed=0, bits=args.bits,
                                       device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    blob = art.save(os.path.join(args.outdir, "model.fgar"))
    print(art.summary())
    print(f"artifact: {len(blob)} bytes -> {args.outdir}/model.fgar "
          f"(sha256 {art.sha256()[:16]}...)")
    srep = art.size_report()
    print(f"  weights {srep['weight_bytes_packed']} B packed "
          f"({srep['q_format']}; paper class: 566 B), "
          f"LUTs {srep['lut_bytes']} B, passes: "
          f"{' -> '.join(art.passes_applied())}")

    # 3: artifact -> wire image + budget audit (raises if unflashable)
    img = build_image(art)
    with open(os.path.join(args.outdir, "model.fgrn"), "wb") as f:
        f.write(img.to_bytes())
    rep = size_report(img)
    print(f"wire image: {rep['total_bytes']} bytes -> "
          f"{args.outdir}/model.fgrn (bits={rep['bits']})")
    for engine in ("float", "int"):
        audit = audit_platforms(img, ("avr", "msp430"), engine=engine)
        for key, a in audit.items():
            print(f"  [{engine:5s}] {key:6s}: flash {a['image_bytes']}/"
                  f"{a['flash_capacity'] - a['code_reserve']} B, "
                  f"sram {a['sram_needed']}/{a['sram_capacity']} B  OK")

    # 4: emit C for every target x engine
    for target in ("avr", "msp430", "host"):
        for engine in ("float", "int"):
            d = os.path.join(args.outdir, target, engine)
            paths = emit_c.write_sources(img, d, target=target, engine=engine)
            print(f"  emitted {target}/{engine}: "
                  f"{', '.join(os.path.basename(p) for p in paths)}")

    # 5: host parity (the artifact is the report's one source of truth)
    if emit_c.find_cc() is None:
        print("no C compiler on PATH — skipping the compile+parity check")
        return
    windows = hapt.load("test", n=args.windows).windows
    report = verify.run_parity(art, windows=windows, use_fp32=False,
                               device=args.device)
    print("parity over", report["n_windows"], "windows:")
    for k, v in report["bitwise"].items():
        print(f"  bitwise {k}: {'OK' if v else 'MISMATCH'}")
    for k, v in report["pairwise"].items():
        print(f"  argmax {k}: {v['agree']:.4f}")
    with open(os.path.join(args.outdir, "parity.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.outdir}/parity.json")


if __name__ == "__main__":
    main()
