"""CLI for the static-analysis gate (reference ``repro.analysis``'s)::

    python -m repro_torch.analysis --fail-on-findings --report ANALYSIS.json
    python -m repro_torch.analysis --detlint-only --fail-on-findings
    python -m repro_torch.analysis --selftest
    python -m repro_torch.analysis --crosscheck [--hapt-root DIR]

``--device`` (default ``cuda``, which raises without a card) is where the
reference artifacts' PTQ runs for qlint and ``--crosscheck``; their
bytes do not depend on it.  The artifacts are
``deploy.goldens.build_reference_artifact(seed=...)``: a CPU
``torch.Generator`` init, not the reference's threefry (ROADMAP Queue
C), so their qlint tables are this package's own.  ``--crosscheck``
reads its windows through ``data.hapt.load`` from ``--hapt-root`` (or
``$HAPT_ROOT``), else the synthetic test split: the port never falls
back to a fixed path.

``--crosscheck`` closes the static/dynamic loop: for each seed it builds
the Q15 and Q7 images, runs the *monitored* qvm over the test windows
(plus a x8 input-amplified stress segment that must witness ``h_next``
saturation), and checks every runtime counter against the fresh qlint
reachability classification (:func:`repro_torch.analysis.crosscheck`).

The report is canonical JSON with no wall-clock, host info, or floats —
two runs over the same tree are byte-identical.
"""
from __future__ import annotations

import argparse
import sys

from . import build_report, crosscheck, dumps, lint_tree, reference_targets, \
    write
from .selftest import run_selftest

#: Input gain for the saturation-stress crosscheck segment: x8 drives the
#: reference model's post-gate state outside int16 (``h_next`` fires) while
#: every matvec/LUT site stays within its proven bounds.
STRESS_GAIN = 8


def run_crosscheck(seeds: tuple[int, ...] = (0,), n_windows: int = 64, *,
                   hapt_root: str | None = None,
                   device: str = "cuda") -> int:
    """Live static/dynamic cross-check over the reference images.

    For each (seed, bits) build: analyze the image (fresh qlint
    reachability), then run the monitored qvm over the test windows twice
    — unmodified, and input-amplified by :data:`STRESS_GAIN` with
    ``expect_nonzero=("h_next",)`` so a silently-dead counter pipeline
    fails the gate rather than passing vacuously.  Exit 0 iff every
    segment's witnesses are contained in the statically reachable site
    set."""
    import numpy as np

    from repro_torch.data import hapt
    from repro_torch.deploy.goldens import build_reference_artifact
    from repro_torch.deploy.image import build_image
    from repro_torch.deploy.qvm import QVM
    from repro_torch.obs.numerics import NumericsMonitor
    from .qlint import analyze_image

    windows = hapt.load("test", root=hapt_root, n=n_windows).windows
    ok = True
    for seed in seeds:
        for bits, label in ((15, "q15"), (7, "q7")):
            art = build_reference_artifact(seed=seed, bits=bits,
                                           device=device)
            img = build_image(art)
            target = analyze_image(img, name=f"reference-{label}-s{seed}")
            for segment, gain, expect in (
                    ("test", 1, ()),
                    ("stress", STRESS_GAIN, ("h_next",))):
                mon = NumericsMonitor()
                vm = QVM(img, monitor=mon)
                vm.run_windows(vm.quantize_input(
                    np.asarray(windows, np.float32) * gain))
                verdict = crosscheck(target, mon.snapshot(),
                                     expect_nonzero=expect)
                ok = ok and verdict["ok"]
                wit = ", ".join(verdict["witnessed"]) or "none"
                print(f"crosscheck: {target['name']} [{segment}]: "
                      f"{'ok' if verdict['ok'] else 'VIOLATION'} "
                      f"(witnessed: {wit}; unwitnessed reachable: "
                      f"{len(verdict['unwitnessed_reachable'])})",
                      file=sys.stderr)
                for v in verdict["violations"]:
                    print(f"  {v}", file=sys.stderr)
    print(f"crosscheck: {'ok' if ok else 'FAILED'}", file=sys.stderr)
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Q15 integer-safety prover + determinism linter")
    ap.add_argument("--report", metavar="PATH",
                    help="write the analysis_report JSON artifact here")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 when any finding survives suppression")
    ap.add_argument("--qlint-only", action="store_true",
                    help="skip the AST determinism linter")
    ap.add_argument("--detlint-only", action="store_true",
                    help="skip the interval prover (no artifact builds)")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated reference-artifact seeds "
                         "(default: 0)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-defect mutation fixtures instead")
    ap.add_argument("--crosscheck", action="store_true",
                    help="run the static/dynamic saturation cross-check "
                         "on the reference images instead")
    ap.add_argument("--windows", type=int, default=64, metavar="N",
                    help="test windows per crosscheck run (default: 64)")
    ap.add_argument("--hapt-root", default=None, metavar="DIR",
                    help="HAPT root for --crosscheck (default: $HAPT_ROOT, "
                         "else the synthetic test split)")
    ap.add_argument("--device", default="cuda",
                    help="where the reference artifacts' PTQ runs (cuda or "
                         "cpu; default cuda)")
    args = ap.parse_args(argv)
    seeds = tuple(int(s) for s in args.seeds.split(",") if s.strip())

    if args.crosscheck:
        return run_crosscheck(seeds=seeds, n_windows=args.windows,
                              hapt_root=args.hapt_root, device=args.device)

    if args.selftest:
        result = run_selftest()
        for name, r in sorted(result["fixtures"].items()):
            mark = "caught" if r["caught"] else "MISSED"
            print(f"  {mark:>6}  {name}  [{r['expect']}]")
        n = len(result["fixtures"])
        ok = result["ok"]
        print(f"selftest: {n} fixtures, "
              f"{'all caught' if ok else 'DEFECTS MISSED'}")
        return 0 if ok else 1

    qlint_targets = []
    if not args.detlint_only:
        qlint_targets = reference_targets(seeds=seeds, device=args.device)
    det = None if args.qlint_only else lint_tree()

    report = build_report(qlint_targets, det)
    if args.report:
        write(report, args.report)
    else:
        sys.stdout.write(dumps(report))

    s = report["summary"]
    for t in qlint_targets:
        status = "proved" if t["proved_overflow_free"] else "FAILED"
        print(f"qlint: {t['name']}: {status} ({t['n_sites']} sites, "
              f"{len(t['saturation']['reachable'])} reachable / "
              f"{len(t['saturation']['dead'])} dead saturations)",
              file=sys.stderr)
    if det is not None:
        print(f"detlint: {det['files']} files, {len(det['checks'])} checks, "
              f"{len(det['findings'])} findings, "
              f"{len(det['suppressions'])} suppressions", file=sys.stderr)
        for f in det["findings"]:
            print(f"  {f['where']}: [{f['check']}] {f['message']}",
                  file=sys.stderr)
    for t in qlint_targets:
        for f in t["findings"]:
            print(f"  {t['name']}:{f['where']}: [{f['check']}] "
                  f"{f['message']}", file=sys.stderr)
    print(f"analysis: {s['findings']} findings, {s['suppressed']} "
          f"suppressed, ok={s['ok']}", file=sys.stderr)
    return 1 if (args.fail_on_findings and not s["ok"]) else 0


if __name__ == "__main__":
    sys.exit(main())
