"""Deterministic, low-overhead observability for the serving stack.

Three cooperating pieces (see ``docs/observability.md``):

* :mod:`repro_torch.obs.trace` — tick-phase tracer: fixed-size span rings,
  no allocation on the hot path, a :data:`~repro_torch.obs.trace.NULL_TRACER`
  default that keeps the bit-exact fast path untouched.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed log2-bucket
  histograms behind one schema, with canonical-JSON and Prometheus
  exporters and a ``validate_bench``-style schema gate.
* :mod:`repro_torch.obs.flight` — flight recorder: the tracer ring plus the
  last N stream events per shard, dumped as a typed artifact on
  ``FleetEngine.crash_shard``.

:class:`Observability` bundles them with the SLO deadline config; every
serving layer (``FleetEngine``, ``StreamingEngine``, ``SlotScheduler``,
the LM ``Engine``) accepts one via ``obs=`` and defaults to
:data:`NULL_OBS` (all hooks no-ops).
"""
from __future__ import annotations

import dataclasses

from .flight import DEFAULT_EVENTS_PER_SHARD, FlightRecorder
from .invariants import (CONSERVED_SCHED, CONSERVED_WORKLOAD,
                         assert_conservation, check_conservation,
                         check_numerics_conservation)
from .metrics import (BUCKET_EDGES_US, SNAPSHOT_SCHEMA_VERSION, Counter,
                      Gauge, Histogram, MetricsRegistry,
                      merge_histogram_counts, validate_snapshot)
from .numerics import (CELL_SITES, NumericsMonitor, RangeStats,
                       limits_from_scales, merge_site_counts, site_order)
from .phases import PHASES, assert_registered, registered
from .trace import NULL_TRACER, NullTracer, Tracer
from .transfers import TRANSFER_KEYS, TransferLedger, sum_transfers


@dataclasses.dataclass
class Observability:
    """The bundle a serving layer consumes.

    ``deadline_ms`` is the per-tick SLO budget for deadline-miss
    accounting; ``None`` derives it from the engine's sample rate
    (50 Hz -> 20 ms, the paper's real-time bar).  ``debug=True`` turns
    on invariant checking in ``FleetEngine.stats()``
    (:func:`repro_torch.obs.invariants.assert_conservation`)."""
    tracer: Tracer | NullTracer = NULL_TRACER
    metrics: MetricsRegistry | None = None
    recorder: FlightRecorder | None = None
    deadline_ms: float | None = None
    debug: bool = False
    numerics: NumericsMonitor | None = None

    @property
    def enabled(self) -> bool:
        """True when any instrumentation is active (tracing or metrics);
        engines use this to skip obs-only branches entirely."""
        return self.tracer.enabled or self.metrics is not None

    @classmethod
    def null(cls) -> "Observability":
        """The shared all-off bundle (module-level :data:`NULL_OBS`)."""
        return NULL_OBS

    @classmethod
    def full(cls, *, capacity: int = 4096, deadline_ms: float | None = None,
             events_per_shard: int = DEFAULT_EVENTS_PER_SHARD,
             debug: bool = False, numerics: bool = False) -> "Observability":
        """Everything on: tracer + metrics registry + flight recorder.
        ``numerics=True`` additionally attaches a bare
        :class:`~repro_torch.obs.numerics.NumericsMonitor` (no calibration
        limits — engines late-bind those from the artifact; build the
        monitor via ``NumericsMonitor.from_scales`` to set them up
        front)."""
        tracer = Tracer(capacity=capacity)
        return cls(tracer=tracer, metrics=MetricsRegistry(),
                   recorder=FlightRecorder(
                       tracer, events_per_shard=events_per_shard),
                   deadline_ms=deadline_ms, debug=debug,
                   numerics=NumericsMonitor() if numerics else None)


#: The default bundle: all hooks no-ops, zero hot-path cost.
NULL_OBS = Observability()

__all__ = [
    "Observability", "NULL_OBS",
    "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "BUCKET_EDGES_US", "SNAPSHOT_SCHEMA_VERSION",
    "validate_snapshot", "merge_histogram_counts",
    "FlightRecorder", "DEFAULT_EVENTS_PER_SHARD",
    "TransferLedger", "TRANSFER_KEYS", "sum_transfers",
    "check_conservation", "assert_conservation",
    "check_numerics_conservation",
    "CONSERVED_WORKLOAD", "CONSERVED_SCHED",
    "PHASES", "registered", "assert_registered",
    "NumericsMonitor", "RangeStats", "CELL_SITES", "site_order",
    "limits_from_scales", "merge_site_counts",
]
