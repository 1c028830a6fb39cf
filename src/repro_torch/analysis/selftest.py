"""Mutation fixtures: prove every analyzer check can actually fire
(reference ``repro.analysis.selftest``).

A static gate that never fires is indistinguishable from one that is
wired up wrong, so ``python -m repro_torch.analysis --selftest`` plants
seeded defects — a tampered requant, an accumulator-width downgrade, a
reintroduced float atomic — and PASSES only if the corresponding check
catches each.  A fixture whose defect sails through is a selftest
failure (exit 1).

The qlint fixtures drive the port's abstract machine and
``analyze_image`` over the reference's Q15 image: the 4,076 bytes of the
committed fixture ``tests/goldens/qvm_reference_s0.npz`` (read, never
written), since ``deploy.goldens.build_reference_artifact`` without
``params`` draws its init from a ``torch.Generator``, not the
reference's threefry (ROADMAP Queue C).  The detlint fixtures lint small
source strings through the production ``lint_source`` path, one per
check, the four torch/CUDA rules included, plus one that proves the
suppression syntax is honored (a suppressed defect must produce a
recorded suppression and *no* finding).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np

from repro_torch.deploy.goldens import REFERENCE_FIXTURES, load_goldens
from repro_torch.deploy.image import DeployImage
from repro_torch.deploy.qvm import I16_MIN, Requant, plan_from_image
from .detlint import lint_source
from .intervals import Interval
from .qlint import Assumptions, Machine, analyze_image
from .report import Finding

#: The reference's committed Q15 fixture, the qlint fixtures' subject.
FIXTURE = os.path.join(REFERENCE_FIXTURES, "qvm_reference_s0.npz")


def reference_image() -> DeployImage:
    """The reference's seed-0 Q15 image, from the committed fixture."""
    return DeployImage.from_bytes(
        load_goldens(FIXTURE)["image_bytes"].tobytes())


# ---------------------------------------------------------------------------
# qlint fixtures — each takes the image and returns the findings the
# seeded defect produced
# ---------------------------------------------------------------------------

def _fx_acc_width_downgrade(img) -> list[dict[str, Any]]:
    """Downgrade the matvec accumulator to int32: the proven Q15 row-sum
    ranges exceed 32 bits, so q-acc-width must fire."""
    return analyze_image(img, Assumptions(widths={"acc": 32}))["findings"]


def _fx_fine_width_downgrade(img) -> list[dict[str, Any]]:
    """Downgrade the fine intermediates to int16: the ±FINE_CLIP range
    needs 30 bits, so q-acc-width must fire at the .fine sites."""
    return analyze_image(img, Assumptions(widths={"fine": 16}))["findings"]


def _fx_requant_tamper(img) -> list[dict[str, Any]]:
    """Replace the gate requant with a denormalized m=3, sh=0 constant
    (the kind a hand-edited image could carry): q-requant-range fires."""
    plan = dataclasses.replace(plan_from_image(img),
                               rq_gate=Requant(m=3, sh=0, pre=0))
    return analyze_image(img, plan=plan)["findings"]


def _fx_requant_overflow(img) -> list[dict[str, Any]]:
    """Feed a requant an accumulator interval wide enough that
    ``(acc >> pre) * m`` escapes int64 — the acc_bits contract of
    quantize_multiplier, violated on purpose."""
    m = Machine()
    m.requant("fx", Requant(m=(1 << 24), sh=30, pre=0),
              Interval(-(1 << 45), (1 << 45) - 1))
    return [f.to_dict() for f in m.findings]


def _fx_lut_truncated(img) -> list[dict[str, Any]]:
    """Hand the LUT primitive a 128-entry table while the program still
    computes 256-entry indices: q-lut-bounds fires."""
    m = Machine()
    m.lut("fx", Interval(-(1 << 20), 1 << 20), m=1 << 10, sh=15,
          table=np.zeros(128, np.int64))
    return [f.to_dict() for f in m.findings]


def _fx_int16_neg(img) -> list[dict[str, Any]]:
    """Negate an interval containing INT16_MIN into an int16 slot:
    ``-(-32768)`` does not exist in int16, q-int16-neg fires."""
    m = Machine()
    m.neg("fx", Interval(I16_MIN, 0), bits=16)
    return [f.to_dict() for f in m.findings]


def _fx_shift_hazard(img) -> list[dict[str, Any]]:
    """A shift amount outside [0, 63] and a right shift of a negative
    operand outside the documented arithmetic sites: q-shift-neg."""
    m = Machine()
    m.shr("fx.amount", Interval(0, 100), 64, 64, arith_ok=True)
    m.shr("fx.negative", Interval(-5, 5), 1, 64, arith_ok=False)
    return [f.to_dict() for f in m.findings]


# ---------------------------------------------------------------------------
# detlint fixtures — seeded-defect sources through the production linter
# ---------------------------------------------------------------------------

_DET_SOURCES: dict[str, tuple[str, str]] = {
    "det-builtin-hash": ("data/fx.py", (
        "def seed_for(split):\n"
        "    return hash(split) % 2**32\n")),
    "det-wallclock": ("serve/fx.py", (
        "import time\n"
        "def snapshot(state):\n"
        "    state['saved_at'] = time.time()\n"
        "    return state\n")),
    "det-torch-compile": ("kernels/fx.py", (
        "import torch\n"
        "@torch.compile\n"
        "def step(h, x):\n"
        "    return h * x + 1.0\n")),
    "det-float-atomics": ("models/fx.py", (
        "import torch\n"
        "def combine(idx, ye, n, d):\n"
        "    y = torch.zeros(n, d, device=ye.device)\n"
        "    return y.index_add_(0, idx, ye)\n")),
    "det-tf32": ("core/fx.py", (
        "import torch\n"
        "def fast():\n"
        "    torch.backends.cuda.matmul.allow_tf32 = True\n")),
    # the flag in parts, so that this fixture is not a finding of the tree
    "det-fast-math": ("kernels/fx.py", (
        "FLAGS = ['-O3', '--use_fast" + "_math', '-shared']\n")),
    "det-set-iteration": ("serve/fx.py", (
        "def dispatch_order(shards):\n"
        "    return [s for s in set(shards)]\n")),
    "det-span-pairing": ("serve/fx.py", (
        "def tick(self, tr):\n"
        "    t0 = tr.t()\n"
        "    self.work()\n")),
    "det-span-registry": ("serve/fx.py", (
        "def tick(self, tr):\n"
        "    t0 = tr.t()\n"
        "    self.work()\n"
        "    tr.rec('fleet.dispach', t0)\n")),
    "det-conserved-counters": ("serve/fleet/engine.py", (
        "class FleetEngine:\n"
        "    def __init__(self):\n"
        "        self._retired = {'stream_steps': 0, 'completed': 0,\n"
        "                         'ring_spills': 0}\n")),
}


def _det_fixture(check: str) -> Callable[[Any], list[dict[str, Any]]]:
    def run(img) -> list[dict[str, Any]]:
        path, src = _DET_SOURCES[check]
        findings, _ = lint_source(src, path)
        return [f.to_dict() for f in findings]
    return run


def _fx_suppression_honored(img) -> list[dict[str, Any]]:
    """The inverse fixture: a defect carrying a well-formed suppression
    comment must yield zero findings and exactly one recorded
    suppression — silence without a record would hide exceptions from
    review."""
    src = ("def count(counts, idx, ones):\n"
           "    return counts.index_add_(0, idx, ones)"
           "  # detlint: ignore[det-float-atomics] integer counts\n")
    findings, suppressions = lint_source(src, "models/fx.py")
    ok = (not findings and len(suppressions) == 1
          and suppressions[0].check == "det-float-atomics"
          and suppressions[0].reason == "integer counts")
    if ok:
        # report the expected check as "caught" via a synthetic marker
        return [Finding("suppression-honored", "models/fx.py:2",
                        "suppressed defect recorded, not silenced").to_dict()]
    return []


#: fixture name -> (check id that must appear in the findings, runner)
FIXTURES: dict[str, tuple[str, Callable[[Any], list[dict[str, Any]]]]] = {
    "acc-width-downgrade": ("q-acc-width", _fx_acc_width_downgrade),
    "fine-width-downgrade": ("q-acc-width", _fx_fine_width_downgrade),
    "requant-tamper": ("q-requant-range", _fx_requant_tamper),
    "requant-overflow": ("q-requant-overflow", _fx_requant_overflow),
    "lut-truncated": ("q-lut-bounds", _fx_lut_truncated),
    "int16-neg": ("q-int16-neg", _fx_int16_neg),
    "shift-hazard": ("q-shift-neg", _fx_shift_hazard),
    **{f"seeded-{c}": (c, _det_fixture(c)) for c in _DET_SOURCES},
    "suppression-honored": ("suppression-honored", _fx_suppression_honored),
}


def run_selftest() -> dict[str, Any]:
    """Run every fixture (the qlint ones over :func:`reference_image`);
    ``ok`` is True only when every seeded defect was caught by exactly
    the check it targets."""
    img = reference_image()
    results = {}
    for name, (expect, fn) in FIXTURES.items():
        findings = fn(img)
        caught = any(f["check"] == expect for f in findings)
        results[name] = {"expect": expect, "caught": caught,
                         "n_findings": len(findings)}
    return {"fixtures": results,
            "ok": all(r["caught"] for r in results.values())}
