"""Tick-phase tracer: fixed-size span rings for the serving hot path.

The paper's headline is a *latency* claim — 9.21 ms/sample against a
20 ms 50 Hz tick budget — so the serving stack needs to answer "where
does a tick spend its time?" without perturbing the thing it measures.
This tracer is built around two constraints:

* **No allocation on the hot path.**  A span is recorded with two calls
  — ``t0 = tracer.t()`` before the work and ``tracer.rec(phase, t0)``
  after — that write into preallocated NumPy rings through an integer
  cursor.  Phase names are interned to integer ids on first use; the
  steady state is one dict hit plus a handful of array stores.
* **Zero cost when disabled.**  :data:`NULL_TRACER` (the engines'
  default) implements the same surface as no-ops: ``t()`` returns the
  cached small int ``0`` and ``rec`` returns immediately, so the
  bit-exact fast path stays untouched (gated by the zero-allocation
  test in ``tests/test_obs.py`` and the <2 % overhead budget in
  ``benchmarks/obs_bench.py``).

Two views of the recorded spans:

* **Per-phase duration rings** — ``phase_stats()`` folds the last
  ``capacity`` durations of every phase into count / total / p50 / p99 /
  max (the latency-breakdown surface ``BENCH_obs.json`` publishes).
* **The flight ring** — one chronological ring over *all* spans
  (sequence number, fleet tick, phase, shard, start, duration, and the
  caller's request id and count).  ``flight()`` returns its tail: the
  exact pre-crash phase history the
  :class:`repro_torch.obs.flight.FlightRecorder` dumps on ``crash_shard``,
  with each span's enclosing span (``parent``) worked out at read time.

Wall-clock fields (``t0_us`` / ``dur_us``, and ``parent``, which follows
from them) are intrinsically nondeterministic; every exporter that
promises byte-stable output (``flight(deterministic=True)``, the metrics
snapshot) keeps only the deterministic skeleton
(:data:`DETERMINISTIC_FIELDS`).  ``clock()`` pairs the span clock with
Unix time, the clock of ``torch.profiler``'s events, so spans and a
device trace line up.

``detail`` is an operator's switch: while it is True the LM engine also
records a span per model layer (``model.mamba``, ``model.ssd``,
``model.attn``).  It is False by default, and the per-tick span count
then does not depend on the model's depth.
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np

from repro_torch.device import clock_pair

#: The fields of a flight record that identical runs reproduce bit for bit.
DETERMINISTIC_FIELDS = ("seq", "tick", "phase", "shard")


class _NullSpan:
    """Reusable no-op context manager (one shared instance, no alloc)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: the engines' default.  Every method is a no-op
    cheap enough for the fused-tick hot path (no timestamps taken, no
    objects allocated)."""
    enabled = False
    detail = False
    __slots__ = ()

    def t(self) -> int:
        return 0

    def rec(self, phase: str, t0: int, shard: int = -1, *, req=None,
            n: int = 0) -> int:
        return 0

    def clock(self) -> tuple[int, int]:
        return (0, 0)

    def set_tick(self, tick: int) -> None:
        pass

    def span(self, phase: str, shard: int = -1):
        return _NULL_SPAN

    def phase_stats(self) -> dict:
        return {}

    def flight(self, last: int | None = None,
               deterministic: bool = False) -> list:
        return []

    def totals_s(self) -> dict:
        return {}


NULL_TRACER = NullTracer()


class _Span:
    """Context-manager adapter over the ``t()``/``rec()`` pair, for call
    sites that are not allocation-sensitive (harnesses, ``deploy.verify``).
    Exposes the recorded duration as ``.dur_ns`` after exit."""
    __slots__ = ("_tracer", "_phase", "_shard", "_t0", "dur_ns")

    def __init__(self, tracer: "Tracer", phase: str, shard: int):
        self._tracer = tracer
        self._phase = phase
        self._shard = shard
        self.dur_ns = 0

    def __enter__(self):
        self._t0 = self._tracer.t()
        return self

    def __exit__(self, *exc):
        self.dur_ns = self._tracer.rec(self._phase, self._t0, self._shard)
        return False


class Tracer:
    """Span recorder with fixed-size rings (see module docstring).

    ``capacity`` bounds both the chronological flight ring and each
    phase's duration ring; recording wraps, it never grows."""
    enabled = True

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.detail = False
        self._clock = clock_pair()
        self._epoch = self._clock[0]
        self._tick = 0
        # phase interning
        self._phase_ids: dict[str, int] = {}
        self._phase_names: list[str] = []
        # per-phase duration rings + monotonic totals
        self._durs: list[np.ndarray] = []
        self._cursors: list[int] = []
        self._counts: list[int] = []
        self._total_ns: list[int] = []
        # chronological flight ring
        self._seq = 0
        self._fl_seq = np.full(capacity, -1, np.int64)
        self._fl_tick = np.zeros(capacity, np.int64)
        self._fl_phase = np.full(capacity, -1, np.int32)
        self._fl_shard = np.full(capacity, -1, np.int32)
        self._fl_t0 = np.zeros(capacity, np.int64)     # ns since epoch
        self._fl_dur = np.zeros(capacity, np.int64)    # ns
        self._fl_req: list = [None] * capacity         # the caller's objects
        self._fl_n = np.zeros(capacity, np.int64)

    # ------------------------------------------------------------------
    # Hot-path surface
    # ------------------------------------------------------------------
    def t(self) -> int:
        """Span start: a raw ``perf_counter_ns`` timestamp."""
        return time.perf_counter_ns()

    def set_tick(self, tick: int) -> None:
        """Tag subsequent spans with the current fleet tick (flight-ring
        context; called once per tick, not per span)."""
        self._tick = tick

    def rec(self, phase: str, t0: int, shard: int = -1, *, req=None,
            n: int = 0) -> int:
        """Record a span that started at ``t0`` and ends now, with an
        optional request id ``req`` (a reference is kept, nothing is
        copied) and count ``n`` (rows, requests, positions).  Returns the
        span duration in ns (callers layer deadline accounting on top
        without a second clock read)."""
        t1 = time.perf_counter_ns()
        dur = t1 - t0
        pid = self._phase_ids.get(phase)
        if pid is None:
            pid = self._intern(phase)
        # per-phase duration ring
        cur = self._cursors[pid]
        self._durs[pid][cur] = dur
        self._cursors[pid] = (cur + 1) % self.capacity
        self._counts[pid] += 1
        self._total_ns[pid] += dur
        # chronological flight ring
        i = self._seq % self.capacity
        self._fl_seq[i] = self._seq
        self._fl_tick[i] = self._tick
        self._fl_phase[i] = pid
        self._fl_shard[i] = shard
        self._fl_t0[i] = t0 - self._epoch
        self._fl_dur[i] = dur
        self._fl_req[i] = req
        self._fl_n[i] = n
        self._seq += 1
        return dur

    def span(self, phase: str, shard: int = -1) -> _Span:
        """Context-manager convenience for cold call sites."""
        return _Span(self, phase, shard)

    def clock(self) -> tuple[int, int]:
        """``(perf_counter_ns, time_ns)`` read at one instant when the
        tracer was built.  A flight record's ``t0_us`` counts from the
        first; Unix time, the clock of ``torch.profiler``'s events, is
        ``clock()[1] + t0_us * 1000`` ns."""
        return self._clock

    # ------------------------------------------------------------------
    # Views
    # ------------------------------------------------------------------
    def phase_stats(self) -> dict[str, dict[str, Any]]:
        """Per-phase latency breakdown over each phase's retained ring:
        ``{phase: {count, total_us, p50_us, p99_us, max_us}}`` (count and
        total are monotonic over the tracer's whole lifetime; the
        percentiles cover the last ``capacity`` spans).  Phases sort by
        name so the snapshot is structurally deterministic."""
        out: dict[str, dict[str, Any]] = {}
        for name in sorted(self._phase_ids):
            pid = self._phase_ids[name]
            n = min(self._counts[pid], self.capacity)
            durs = self._durs[pid][:n]
            us = durs / 1e3
            out[name] = {
                "count": int(self._counts[pid]),
                "total_us": round(self._total_ns[pid] / 1e3, 3),
                "p50_us": round(float(np.percentile(us, 50)), 3),
                "p99_us": round(float(np.percentile(us, 99)), 3),
                "max_us": round(float(us.max()), 3),
            }
        return out

    def totals_s(self) -> dict[str, float]:
        """Total recorded seconds per phase (the ``deploy.verify`` timing
        surface: one span per protocol section, summed)."""
        return {name: self._total_ns[self._phase_ids[name]] / 1e9
                for name in sorted(self._phase_ids)}

    def flight(self, last: int | None = None,
               deterministic: bool = False) -> list[dict[str, Any]]:
        """Chronological tail of the flight ring (oldest first), each
        span as a dict.  ``deterministic=True`` keeps the fields of
        :data:`DETERMINISTIC_FIELDS` alone, so two identical runs produce
        byte-identical dumps — the flight-recorder stability contract.
        The full view adds ``t0_us`` / ``dur_us``, the ``req`` and ``n``
        given to :meth:`rec`, and ``parent``: the ``seq`` of the shortest
        span that encloses this one and closed after it, or -1 (spans
        nest by time on the recording thread)."""
        n = min(self._seq, self.capacity)
        if last is not None:
            n = min(n, last)
        idx = [k % self.capacity for k in range(self._seq - n, self._seq)]
        parents = [] if deterministic else _parents(
            self._fl_t0[idx], self._fl_dur[idx], self._fl_seq[idx])
        out = []
        for j, i in enumerate(idx):
            rec: dict[str, Any] = {
                "seq": int(self._fl_seq[i]),
                "tick": int(self._fl_tick[i]),
                "phase": self._phase_names[int(self._fl_phase[i])],
                "shard": int(self._fl_shard[i]),
            }
            if not deterministic:
                rec["t0_us"] = round(int(self._fl_t0[i]) / 1e3, 3)
                rec["dur_us"] = round(int(self._fl_dur[i]) / 1e3, 3)
                rec["parent"] = parents[j]
                rec["req"] = self._fl_req[i]
                rec["n"] = int(self._fl_n[i])
            out.append(rec)
        return out

    # ------------------------------------------------------------------
    def _intern(self, phase: str) -> int:
        pid = len(self._phase_names)
        self._phase_ids[phase] = pid
        self._phase_names.append(phase)
        self._durs.append(np.zeros(self.capacity, np.int64))
        self._cursors.append(0)
        self._counts.append(0)
        self._total_ns.append(0)
        return pid


def _parents(t0: np.ndarray, dur: np.ndarray, seq: np.ndarray) -> list[int]:
    """For each span, the ``seq`` of the shortest span that encloses it
    (starts no later, ends no earlier) and closed after it, or -1.  Spans
    visited by start, the longer first, against a stack of those not yet
    ended: a span that ended before the visited one starts can enclose
    neither it nor any later one."""
    order = np.lexsort((-seq, -(t0 + dur), t0)).tolist()
    t0, dur, seq = t0.tolist(), dur.tolist(), seq.tolist()
    parent = [-1] * len(seq)
    stack: list[int] = []
    for j in order:
        a, b, s = t0[j], t0[j] + dur[j], seq[j]
        while stack and t0[stack[-1]] + dur[stack[-1]] < a:
            stack.pop()
        best = -1
        for k in stack:
            if t0[k] + dur[k] >= b and seq[k] > s and (
                    best < 0 or dur[k] < dur[best]):
                best = k
        if best >= 0:
            parent[j] = seq[best]
        stack.append(j)
    return parent
