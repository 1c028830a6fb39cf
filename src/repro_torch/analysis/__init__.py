"""Static analysis of the deployed integer program, ported from the
reference ``repro.analysis`` (the half the deploy parity protocol needs):

* :mod:`.intervals` — the exact integer interval domain;
* :mod:`.qlint` — the interval / bit-width abstract interpreter over the
  integer step + head program shared by :mod:`repro_torch.deploy.qvm`
  and the emitted C, seeded with the actual tensors of a packed
  :class:`~repro_torch.deploy.image.DeployImage`: it proves every
  accumulator fits its declared width and classifies each saturation
  site as reachable or dead;
* :mod:`.crosscheck` — runtime saturation witnesses against that
  classification;
* :mod:`.report` — the canonical-JSON ``analysis_report`` layout.

The determinism linter and the CLI (``detlint``, ``selftest``,
``__main__``) are not ported yet (ROADMAP A8).
"""
from .crosscheck import crosscheck, target_by_name
from .intervals import Interval, WIDTH_RANGE
from .qlint import (DEFAULT_WIDTHS, QLINT_CHECKS, Assumptions, Machine,
                    analyze_image, reference_targets)
from .report import SCHEMA_VERSION, Finding, build_report, dumps

__all__ = [
    "Interval", "WIDTH_RANGE",
    "Machine", "Assumptions", "analyze_image", "reference_targets",
    "QLINT_CHECKS", "DEFAULT_WIDTHS",
    "Finding", "build_report", "dumps", "SCHEMA_VERSION",
    "crosscheck", "target_by_name",
]
