"""Numeric-health telemetry: runtime saturation counters + calibration drift.

The Q15 integer contracts are *statically* provable: ``repro_torch.analysis``
re-executes the deployed step/head program over exact integer intervals and
classifies every saturation site reachable or dead (``ANALYSIS_report.json``).
This module is the dynamic half of that loop — at serving time it counts how
often each named site actually fires and how far live activations drift from
the ranges the artifact was calibrated on:

* **Per-site saturation counters.**  One monotonic counter per named clamp
  site, reusing the analyzer's site IDs verbatim (``gate.hf_clip``,
  ``h_next``, ``w2.out`` / ``w2.fine`` requant + fine clips, ``act.z.idx`` /
  ``act.ht.idx`` LUT index clamps, ``head.logits`` narrowing cast) so a
  runtime snapshot and the static report key the same vocabulary.  Counted
  in the qvm (``deploy/qvm.py``), the emitted C (``FG_NUMERIC_COUNTERS``
  block, parity-gated against the qvm), and the batched float kernels
  (where the integer sites collapse to the LUT domain saturations).
* **Per-tensor activation ranges.**  min / max / |v|-ratio histogram per
  named tensor against the artifact's calibration limit, folded into a
  deterministic ``calibration_drift`` score (range-overflow fraction plus
  p99 quantile shift) — the early-warning signal that a tenant's sensor
  left the calibrated envelope *before* argmax agreement degrades.
* **Static cross-check.**  :func:`repro_torch.analysis.crosscheck` asserts every
  runtime witness is a statically-reachable site (a dead site firing is a
  hard invariant violation); ``deploy/verify.py`` runs it as part of the
  parity protocol.

Determinism contract: monitors hang off the ``Observability`` bundle and
default to ``None`` (every hook skipped — the bit-exact fast path is
untouched); a *monitored* run only ever reads intermediate values, so it is
byte-identical to an unmonitored run on every backend (test-gated like the
tracer).  Snapshots contain no wall-clock fields and round floats, so two
identical runs serialize byte-identically.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np

#: Q15 code range — calibration scales are value-per-LSB, so the calibrated
#: amplitude limit of a tensor with scale ``s`` is ``s * Q15_LIMIT``.
Q15_LIMIT = 32767

#: Saturation sites of the integer cell shared by every image geometry, in
#: program order (the matvec sites come first, per-image — see
#: :func:`site_order`).
CELL_SITES = (
    "act.z.idx",    # sigmoid LUT index clamp (qlint: act.z.idx)
    "act.ht.idx",   # tanh LUT index clamp
    "gate.out",     # gate requant int32 saturation
    "gate.hf_clip", # gate-combine accumulator ±2^31 clip
    "hstore.out",   # h-store requant int32 saturation
    "h_next",       # h-store int16 saturation (load-bearing, reachable)
    "head.logits",  # head narrowing cast int64 -> int32
)

#: Per-matvec sites: requant int32 saturation then the ±(2^29-1) fine clip.
MATVEC_SITES = ("out", "fine")


def site_order(low_rank: bool = True) -> tuple[str, ...]:
    """The canonical ordered site vocabulary of one deployed image — the
    contract between the qvm monitor, the emitted C counter block
    (``FG_SITE_*`` indices are positions in this tuple) and the analyzer's
    report.  Matvec sites appear in the qvm's execution order."""
    names = ("w2", "w1", "u2", "u1") if low_rank else ("w", "u")
    mv = tuple(f"{n}.{k}" for n in names for k in MATVEC_SITES)
    return mv + CELL_SITES


def site_index(site: str, low_rank: bool = True) -> int:
    return site_order(low_rank).index(site)


def limits_from_scales(act_scales: dict[str, float] | None,
                       q_max: int = Q15_LIMIT) -> dict[str, float]:
    """Calibrated per-tensor amplitude limits from deploy calibration
    scales (value-per-LSB): ``limit = scale * 32767`` — the largest
    magnitude representable without saturating at that scale."""
    if not act_scales:
        return {}
    return {k: float(act_scales[k]) * q_max
            for k in sorted(act_scales) if float(act_scales[k]) > 0.0}


# ---------------------------------------------------------------------------
# Per-tensor range statistics
# ---------------------------------------------------------------------------

#: |v|/limit ratio histogram: 16 buckets of width 1/8 over [0, 2) plus one
#: overflow bucket (ratio >= 2).  Fixed edges so shard histograms merge by
#: adding count vectors, same property as the metrics bucket ladder.
RATIO_BUCKETS = 17

#: Registry-publish cadence (engine ticks).  ``publish`` walks every
#: site and tensor and recomputes drift — per-tick export dominates the
#: monitor's cost on small models, and since counters are delta-tracked
#: a throttled publish drops nothing.
PUBLISH_EVERY = 32


class RangeStats:
    """Running min/max + |v|/limit histogram for one named tensor.

    Two observation paths: :meth:`observe` (full — histogram + extrema,
    used on the rare emission/trace paths) and :meth:`note` (light —
    pre-reduced extrema and overflow count from the hot tick loop, no
    histogram).  Both feed the same drift score."""

    __slots__ = ("limit", "n", "n_over", "vmin", "vmax", "hist")

    def __init__(self, limit: float | None = None):
        self.limit = None if limit is None else float(limit)
        self.n = 0
        self.n_over = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.hist = np.zeros(RATIO_BUCKETS, np.int64)

    def observe(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        self.n += int(v.size)
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        if self.limit is not None:
            a = np.abs(v)
            self.n_over += int(np.count_nonzero(a > self.limit))
            idx = np.minimum((a * (8.0 / self.limit)).astype(np.int64),
                             RATIO_BUCKETS - 1)
            np.add.at(self.hist, idx, 1)

    def note(self, vmin: float, vmax: float, n: int, n_over: int = 0) -> None:
        """Fold pre-reduced extrema (hot-path form: the caller already has
        the reduction, no histogram pass)."""
        if n <= 0:
            return
        self.n += int(n)
        self.n_over += int(n_over)
        self.vmin = min(self.vmin, float(vmin))
        self.vmax = max(self.vmax, float(vmax))

    def merge(self, other: "RangeStats") -> None:
        if other.n == 0:
            return
        if self.limit is None:
            self.limit = other.limit
        self.n += other.n
        self.n_over += other.n_over
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self.hist += other.hist

    # -- drift ----------------------------------------------------------
    def p99_ratio(self) -> float:
        """Bucket-resolution 99th-percentile |v|/limit ratio (upper edge
        of the bucket holding the p99 observation; histogram-less stats
        fall back to the max-ratio, the only quantile they know)."""
        if self.limit is None or self.n == 0:
            return 0.0
        total = int(self.hist.sum())
        if total == 0:
            m = max(abs(self.vmin), abs(self.vmax))
            return m / self.limit
        cum = np.cumsum(self.hist)
        i = int(np.searchsorted(cum, 0.99 * total, side="left"))
        return (i + 1) / 8.0

    def drift(self) -> float:
        """Deterministic calibration-drift score: the fraction of
        observations outside the calibrated limit plus the p99 quantile
        shift beyond it.  0.0 = fully inside calibration; ~0 < drift <= 1
        = tail excursions; > 1 = bulk shift."""
        if self.limit is None or self.n == 0:
            return 0.0
        over = self.n_over / self.n
        return over + max(0.0, self.p99_ratio() - 1.0)

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "n": int(self.n),
            "n_over": int(self.n_over),
            "min": 0.0 if self.n == 0 else round(self.vmin, 6),
            "max": 0.0 if self.n == 0 else round(self.vmax, 6),
            "limit": None if self.limit is None else round(self.limit, 6),
            "drift": round(self.drift(), 6),
        }
        if self.hist.any():
            out["hist"] = [int(c) for c in self.hist]
        return out


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------

class NumericsMonitor:
    """Per-site saturation counters + per-tensor range stats, with
    per-shard children for fleet aggregation.

    The parent monitor rides ``Observability.numerics``; each serving
    engine counts into its own :meth:`shard` child (shard index, or -1
    for a standalone engine), and :meth:`snapshot` aggregates parent +
    children deterministically.  All hooks are pure reads of intermediate
    values — attaching a monitor never changes a computed result."""

    def __init__(self, limits: dict[str, float] | None = None):
        self._limits: dict[str, float] = dict(limits or {})
        self._sites: dict[str, int] = {}
        self._tensors: dict[str, RangeStats] = {}
        self._children: dict[int, "NumericsMonitor"] = {}
        self._published: dict[str, int] = {}

    @classmethod
    def from_scales(cls, act_scales: dict[str, float] | None
                    ) -> "NumericsMonitor":
        return cls(limits_from_scales(act_scales))

    # -- configuration --------------------------------------------------
    def set_default_limits(self, limits: dict[str, float]) -> None:
        """Install calibration limits for tensors that do not have one yet
        (late binding: the artifact is often only known to the engine)."""
        for k in sorted(limits):
            if k not in self._limits:
                self._limits[k] = float(limits[k])
                st = self._tensors.get(k)
                if st is not None and st.limit is None:
                    st.limit = float(limits[k])

    def limit(self, tensor: str) -> float | None:
        return self._limits.get(tensor)

    def declare(self, sites: Iterable[str]) -> None:
        """Pre-register sites at zero so an un-fired site still appears in
        the snapshot (the cross-check needs zero counts to be visible)."""
        for s in sites:
            self._sites.setdefault(s, 0)

    # -- observation ----------------------------------------------------
    def count(self, site: str, n: int) -> None:
        if n:
            self._sites[site] = self._sites.get(site, 0) + int(n)
        else:
            self._sites.setdefault(site, 0)

    def count_events(self, events: dict[str, int]) -> None:
        for site in sorted(events):
            self.count(site, events[site])

    def observe(self, tensor: str, values) -> None:
        st = self._tensors.get(tensor)
        if st is None:
            st = self._tensors[tensor] = RangeStats(self._limits.get(tensor))
        st.observe(values)

    def note_range(self, tensor: str, vmin: float, vmax: float, n: int,
                   n_over: int = 0) -> None:
        st = self._tensors.get(tensor)
        if st is None:
            st = self._tensors[tensor] = RangeStats(self._limits.get(tensor))
        st.note(vmin, vmax, n, n_over)

    # -- fleet sharding -------------------------------------------------
    def shard(self, index: int) -> "NumericsMonitor":
        """Get-or-create the child monitor for one shard (index -1 = a
        standalone engine).  Children share the parent's limit table."""
        child = self._children.get(index)
        if child is None:
            child = self._children[index] = NumericsMonitor()
            child._limits = self._limits   # shared (not copied): limits
            # late-bound on the parent reach already-created children
        return child

    def shard_indices(self) -> list[int]:
        return sorted(self._children)

    def reset(self) -> None:
        """Zero this monitor's own counters/stats (crash-retirement path:
        the fleet folds the child's snapshot into its retired accumulator
        first, so nothing is lost).  Children are left alone."""
        self._sites = {}
        self._tensors = {}
        self._published = {}

    # -- aggregation / export -------------------------------------------
    def _aggregate(self) -> tuple[dict[str, int], dict[str, RangeStats]]:
        sites = dict(self._sites)
        tensors = {k: v for k, v in self._tensors.items()}
        agg_tensors: dict[str, RangeStats] = {}
        for name in sorted(tensors):
            st = RangeStats(tensors[name].limit)
            st.merge(tensors[name])
            agg_tensors[name] = st
        for idx in sorted(self._children):
            csites, ctensors = self._children[idx]._aggregate()
            for s in sorted(csites):
                sites[s] = sites.get(s, 0) + csites[s]
            for name in sorted(ctensors):
                st = agg_tensors.get(name)
                if st is None:
                    st = agg_tensors[name] = RangeStats(ctensors[name].limit)
                st.merge(ctensors[name])
        return sites, agg_tensors

    def site_counts(self) -> dict[str, int]:
        """Aggregated per-site counters (self + shard children)."""
        return self._aggregate()[0]

    def drift(self) -> float:
        """The worst per-tensor drift score (the fleet's one-number
        health gauge)."""
        _, tensors = self._aggregate()
        return max((t.drift() for t in tensors.values()), default=0.0)

    def snapshot(self, per_shard: bool = False) -> dict[str, Any]:
        """One deterministic dict: aggregated site counters, per-tensor
        range stats + drift, worst drift.  ``per_shard=True`` adds each
        child's own snapshot keyed by shard index."""
        sites, tensors = self._aggregate()
        out: dict[str, Any] = {
            "schema": "numerics_snapshot",
            "sites": {k: int(sites[k]) for k in sorted(sites)},
            "tensors": {k: tensors[k].snapshot() for k in sorted(tensors)},
            "drift": round(max((t.drift() for t in tensors.values()),
                               default=0.0), 6),
        }
        if per_shard:
            out["per_shard"] = {
                str(i): self._children[i].snapshot()
                for i in sorted(self._children)}
        return out

    def publish(self, reg) -> None:
        """Export into a :class:`repro_torch.obs.metrics.MetricsRegistry`:
        monotone per-site counters (delta-tracked so repeated publishes
        never double-count) and per-tensor / overall drift gauges."""
        sites, tensors = self._aggregate()
        for site in sorted(sites):
            prev = self._published.get(site, 0)
            delta = sites[site] - prev
            c = reg.counter(f"numerics.sat.{site}",
                            "saturation/clamp events at this site")
            if delta > 0:
                c.inc(delta)
                self._published[site] = sites[site]
        worst = 0.0
        for name in sorted(tensors):
            d = tensors[name].drift()
            worst = max(worst, d)
            reg.gauge(f"numerics.drift.{name}",
                      "calibration-drift score for this tensor").set(d)
        reg.gauge("numerics.drift",
                  "worst per-tensor calibration-drift score").set(worst)


def merge_site_counts(into: dict[str, int],
                      counts: dict[str, int]) -> dict[str, int]:
    """Fold one site-counter dict into an accumulator (the fleet's
    crash-retirement helper; conservation is checked by
    ``obs.invariants.check_numerics_conservation``)."""
    for site in sorted(counts):
        into[site] = into.get(site, 0) + int(counts[site])
    return into
