"""Static analysis for the port, ported from the reference
``repro.analysis``.  Two pillars:

* :mod:`.qlint` — the interval / bit-width abstract interpreter (over the
  exact integer domain of :mod:`.intervals`) of the integer step + head
  program shared by :mod:`repro_torch.deploy.qvm` and the emitted C,
  seeded with the actual tensors of a packed
  :class:`~repro_torch.deploy.image.DeployImage`: it proves every
  accumulator fits its declared width and classifies each saturation
  site as reachable or dead; :mod:`.crosscheck` holds runtime
  saturation witnesses against that classification;
* :mod:`.detlint` — an AST linter over ``src/repro_torch`` encoding the
  determinism and bit-exactness rules of both packages, torch/CUDA
  rules in place of the reference's JAX ones (each check's docstring
  cites its trap).

``python -m repro_torch.analysis`` runs both and emits one
canonical-JSON ``analysis_report`` (:mod:`.report`); ``--selftest``
runs the seeded-defect mutation fixtures (:mod:`.selftest`) that prove
every check can fire.
"""
from .crosscheck import crosscheck, target_by_name
from .detlint import CHECK_IDS, CHECKS, lint_source, lint_tree
from .intervals import Interval, WIDTH_RANGE
from .qlint import (DEFAULT_WIDTHS, QLINT_CHECKS, Assumptions, Machine,
                    analyze_image, reference_targets)
from .report import (SCHEMA_VERSION, Finding, Suppression, build_report,
                     dumps, write)
from .selftest import FIXTURES, run_selftest

__all__ = [
    "Interval", "WIDTH_RANGE",
    "Machine", "Assumptions", "analyze_image", "reference_targets",
    "QLINT_CHECKS", "DEFAULT_WIDTHS",
    "lint_tree", "lint_source", "CHECKS", "CHECK_IDS",
    "Finding", "Suppression", "build_report", "dumps", "write",
    "SCHEMA_VERSION",
    "run_selftest", "FIXTURES",
    "crosscheck", "target_by_name",
]
