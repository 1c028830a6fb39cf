"""Machine-readable report for the static-analysis gate, ported from the
reference ``repro.analysis.report``.

One ``analysis_report`` JSON artifact (the schema of the committed
``ANALYSIS_report.json``) carries two pillars:

* ``qlint``  — per-target instruction table with the *proven* interval
  bound, minimum signed width, declared width, and saturation
  classification per site, plus any findings;
* ``detlint`` — per-file findings of the determinism linter
  (:mod:`.detlint`) and the suppressions that were honored (an
  intentional exception is part of the record, not silence); pass
  ``None`` to skip it and the block reads ``{"skipped": true}``.

Determinism contract: the report contains no wall-clock, no host info,
and no floats — ints, strings and bools only, serialized as canonical
JSON (sorted keys, fixed separators), so two runs over the same images
are byte-identical.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

#: Bumped when the report layout changes incompatibly.
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified rule violation (either pillar)."""
    check: str          # check id, e.g. "q-acc-width" / "det-donate-argnums"
    where: str          # qlint: site name; detlint: "path:line"
    message: str        # human-readable statement of the violation

    def to_dict(self) -> dict[str, str]:
        return {"check": self.check, "where": self.where,
                "message": self.message}


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One honored inline suppression (``# detlint: ignore[check] reason``)."""
    check: str
    where: str
    reason: str

    def to_dict(self) -> dict[str, str]:
        return {"check": self.check, "where": self.where,
                "reason": self.reason}


def build_report(qlint_targets: list[dict[str, Any]],
                 detlint_result: dict[str, Any] | None) -> dict[str, Any]:
    """Assemble the full report dict from the two pillars' outputs."""
    findings = sum(len(t["findings"]) for t in qlint_targets)
    suppressed = 0
    det_block: dict[str, Any] = {"skipped": True}
    if detlint_result is not None:
        det_block = detlint_result
        findings += len(detlint_result["findings"])
        suppressed = len(detlint_result["suppressions"])
    return {
        "benchmark": "analysis_report",
        "schema_version": SCHEMA_VERSION,
        "qlint": {"targets": qlint_targets},
        "detlint": det_block,
        "summary": {
            "findings": findings,
            "suppressed": suppressed,
            "ok": findings == 0,
        },
    }


def dumps(report: dict[str, Any]) -> str:
    """Canonical JSON: sorted keys, fixed separators, trailing newline —
    the byte-stable form of the committed ``ANALYSIS_report.json``."""
    return json.dumps(report, sort_keys=True, indent=1,
                      separators=(",", ": ")) + "\n"


def write(report: dict[str, Any], path: str) -> None:
    """The report's canonical JSON (:func:`dumps`) into ``path``."""
    with open(path, "w") as f:
        f.write(dumps(report))
