"""Flight recorder: what happened in the seconds before a shard crash.

A crash report that only says "shard 3 died at tick 812" is useless for
diagnosing *why*; the flight recorder pairs the tracer's chronological
span ring (the exact pre-crash tick phases, in order) with the last N
stream-event summaries per shard, and dumps both as one typed artifact
the moment ``FleetEngine.crash_shard`` runs.

Determinism contract: ``dumps(deterministic=True)`` keeps each span's
deterministic fields alone (``trace.DETERMINISTIC_FIELDS``) and
serializes with sorted keys, so two identical runs under
the same ``ScheduledFaults`` (reference package ``repro.serve.fleet.faults``) schedule
produce **byte-identical** crash dumps — asserted across the full
phase x shard crash matrix in ``tests/test_obs.py`` and recorded in
``BENCH_obs.json``.

Event summaries are deliberately compact (tick, shard, event count, the
tail of (stream_id, kind, step) triples): at fleet scale a lockstep
window boundary emits 100k+ events in one tick, and the recorder must
not turn delivery into an O(events) copy — it keeps the count and the
last few, bounded by ``events_per_shard``.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any

from .trace import DETERMINISTIC_FIELDS, NullTracer, Tracer

#: Per-shard cap on retained (stream_id, kind, step) event triples.
DEFAULT_EVENTS_PER_SHARD = 64


class FlightRecorder:
    """Crash-dump assembler over a :class:`~repro_torch.obs.trace.Tracer`."""

    def __init__(self, tracer: Tracer | NullTracer, *,
                 events_per_shard: int = DEFAULT_EVENTS_PER_SHARD,
                 max_crashes: int = 16):
        self.tracer = tracer
        self.events_per_shard = events_per_shard
        self._events: dict[int, deque] = {}
        self._event_counts: dict[int, int] = {}
        self._crashes: deque = deque(maxlen=max_crashes)

    # ------------------------------------------------------------------
    # Live feed (called by the fleet during delivery)
    # ------------------------------------------------------------------
    def note_events(self, shard: int, tick: int, summaries: list,
                    total: int | None = None) -> None:
        """Record one shard's tick emission: ``summaries`` is a short
        list of (stream_id, kind, step) triples (the caller truncates to
        ``events_per_shard``; columnar batches summarize, they do not
        expand).  ``total`` is the true emission count when the
        summaries are a truncation of a larger batch."""
        q = self._events.get(shard)
        if q is None:
            q = self._events[shard] = deque(maxlen=self.events_per_shard)
            self._event_counts[shard] = 0
        self._event_counts[shard] += (len(summaries) if total is None
                                      else total)
        for sid, kind, step in summaries[-self.events_per_shard:]:
            q.append((tick, sid, kind, int(step)))

    # ------------------------------------------------------------------
    # Crash capture
    # ------------------------------------------------------------------
    def record_crash(self, report: dict, *, tick: int,
                     counters: dict | None = None) -> dict[str, Any]:
        """Assemble and retain one crash dump from a
        ``FleetEngine.crash_shard`` recovery report.  Returns the dump."""
        shard = report.get("shard")
        dump: dict[str, Any] = {
            "artifact": "flight_record",
            "version": 1,
            "tick": int(tick),
            "shard": shard,
            "phase": report.get("phase"),
            "recovery": {k: report[k] for k in sorted(report)},
            "trace": self.tracer.flight(),
            "recent_events": {
                str(s): {
                    "total_events": self._event_counts.get(s, 0),
                    "tail": [{"tick": t, "stream": sid, "kind": kind,
                              "step": step}
                             for t, sid, kind, step in self._events.get(
                                 s, ())],
                } for s in sorted(self._events)},
            "counters": counters or {},
        }
        self._crashes.append(dump)
        return dump

    # ------------------------------------------------------------------
    # Introspection / export
    # ------------------------------------------------------------------
    @property
    def n_crashes(self) -> int:
        return len(self._crashes)

    def last(self) -> dict[str, Any] | None:
        """The most recent crash dump (None if no crash was recorded)."""
        return self._crashes[-1] if self._crashes else None

    def crashes(self) -> list[dict[str, Any]]:
        return list(self._crashes)

    def dumps(self, deterministic: bool = False) -> str:
        """Canonical JSON of every retained crash dump.  With
        ``deterministic=True`` wall-clock span fields are stripped from
        the embedded traces, making the bytes stable across identical
        runs (the crash-matrix byte-stability gate)."""
        crashes = [self._strip(c) if deterministic else c
                   for c in self._crashes]
        return json.dumps({"artifact": "flight_record_log",
                           "deterministic": bool(deterministic),
                           "crashes": crashes},
                          sort_keys=True, separators=(",", ":"))

    @staticmethod
    def _strip(dump: dict) -> dict:
        out = dict(dump)
        out["trace"] = [{k: rec[k] for k in DETERMINISTIC_FIELDS}
                        for rec in dump["trace"]]
        return out
