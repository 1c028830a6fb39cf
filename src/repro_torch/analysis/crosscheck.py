"""Static/dynamic cross-check: runtime saturation witnesses vs the prover,
ported from the reference ``repro.analysis.crosscheck``.

The qlint abstract interpreter (:mod:`repro_torch.analysis.qlint`) classifies
every saturation site in the integer program as **reachable** (the
proven operand interval actually exceeds the clamp bounds) or **dead**
(the clamp is documentation — the interval already fits).  The runtime
:class:`repro_torch.obs.numerics.NumericsMonitor` counts, per site, how often
a concrete execution actually hit each clamp.  This module closes the
loop between the two:

* a *dead* site with a nonzero runtime count is a soundness bug — the
  abstract interpreter under-approximated a range, exactly the class of
  error the analysis gate exists to rule out;
* a site the prover never modeled (present in the counter vocabulary
  but in neither classification list) firing at runtime means the
  instrumented program and the analyzed program have diverged;
* a *reachable* site with a zero count is fine — the prover
  over-approximates by design (``gate.hf_clip`` is the canonical
  example: statically reachable, dynamically never hit on the
  reference traces).  Callers that *expect* a witness (e.g. the
  stress-amplified golden segment driving ``h_next`` into saturation)
  pass ``expect_nonzero=`` to turn a missing witness into a violation
  too — that direction catches instrumentation rot, where counters
  silently stop counting.

The check is pure data -> data (no model builds, no RNG, no clock):
one qlint target dict from the ``analysis_report`` artifact on the
static side, one ``NumericsMonitor.snapshot()`` dict on the dynamic
side.  ``deploy/verify.py`` runs it as part of the parity protocol.
"""
from __future__ import annotations

from typing import Any


def target_by_name(report: dict[str, Any], name: str) -> dict[str, Any]:
    """Pick one qlint target out of a full ``analysis_report`` dict."""
    for t in report["qlint"]["targets"]:
        if t["name"] == name:
            return t
    known = [t["name"] for t in report["qlint"]["targets"]]
    raise KeyError(f"no qlint target {name!r} in report (have {known})")


def crosscheck(target: dict[str, Any], snapshot: dict[str, Any],
               expect_nonzero: tuple[str, ...] = ()) -> dict[str, Any]:
    """Check one runtime counter snapshot against one qlint target.

    ``target`` is a qlint target dict (``analysis_report`` schema:
    must carry ``saturation.reachable`` / ``saturation.dead``);
    ``snapshot`` is a ``NumericsMonitor.snapshot()`` dict (or any dict
    with a ``"sites"`` name->count mapping, e.g. the C engine's
    counters zipped with ``site_order``).  Returns a verdict dict::

        {"ok": bool,
         "violations": [str, ...],       # empty iff ok
         "witnessed": [site, ...],       # nonzero-count sites
         "unwitnessed_reachable": [...]} # reachable, count == 0

    The containment law: dynamic witnesses must be a subset of the
    statically reachable sites.  ``expect_nonzero`` additionally
    requires a witness at the named sites.
    """
    sat = target["saturation"]
    reachable = set(sat["reachable"])
    dead = set(sat["dead"])
    counts: dict[str, int] = snapshot["sites"]

    violations: list[str] = []
    witnessed: list[str] = []
    for site in sorted(counts):
        n = int(counts[site])
        if n == 0:
            continue
        witnessed.append(site)
        if site in dead:
            violations.append(
                f"{site}: statically dead saturation fired {n} times — "
                f"the abstract interpreter under-approximated its range")
        elif site not in reachable:
            violations.append(
                f"{site}: fired {n} times but the prover never "
                f"classified it — instrumented and analyzed programs "
                f"have diverged")
    for site in expect_nonzero:
        if int(counts.get(site, 0)) == 0:
            violations.append(
                f"{site}: expected a runtime witness but the counter "
                f"is zero — saturation instrumentation is not counting")
    unwitnessed = sorted(reachable - set(witnessed))
    return {
        "ok": not violations,
        "violations": violations,
        "witnessed": witnessed,
        "unwitnessed_reachable": unwitnessed,
    }
