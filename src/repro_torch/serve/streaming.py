"""Multi-stream streaming inference engine for the deployed Q15 FastGRNN.

The paper deploys one 566-byte FastGRNN per microcontroller, classifying a
live 50 Hz tri-axial accelerometer stream in real time.  This module is the
server-side analogue of a *fleet* of such sensors: thousands of concurrent
stateful sessions (one hidden state + warm-up counter each) stepped in
lockstep by the batched Q15 single-step kernel
(``kernels/fastgrnn_cell.ops.Q15StreamStep``).  Ported from the reference
``repro.serve.streaming``; on a CUDA device the step is the hand-written
kernel ``csrc/q15_step.cu`` and the hidden-state table lives on the card.

Placement — which stream occupies which resident slot, FIFO admission from
the pending queue, slot recycling when a stream finishes or detaches — is
delegated to the engine-agnostic :class:`repro_torch.serve.scheduler.SlotScheduler`;
this module implements the workload half of that split (the
:class:`~repro_torch.serve.scheduler.SlotProgram` protocol): per-slot
FastGRNN state, sample rings, window counters, and event emission.

Workload state is a **NumPy slot table** on the host, not per-session
Python objects:
per-slot step counters, window positions, stream lengths and sample
cursors are columns of (S,)-shaped arrays, and buffered samples live in
one offset-major (cap, S, d) ring buffer — a lockstep fleet's per-tick
gather is then one contiguous (S, d) slab read — so a tick costs a
handful of vectorized ops instead of a Python loop over every resident
stream.  Python loops remain only on the rare paths: admission,
completion, and event emission.

Device: ``StreamingConfig.device`` (default ``"cuda"``).  On the card the
hidden-state table is always device-resident: each tick only x and the
active mask cross host-to-device, and only emitting / tapped / snapshot
rows come back.  ``device="cpu"`` keeps the table in a CPU tensor and runs
the plain torch step over the advancing rows.

Determinism contract: on either device every stream's hidden trajectory,
logits and predictions are **bit-identical** to running the scalar
``core/qruntime.QRuntime`` over the same samples (paper contribution (i) —
cross-platform agreement — preserved at batch scale), and to the
reference engine's ``backend="exact"``.

Lifecycle::

    engine = StreamingEngine(qp, StreamingConfig(device="cuda"))
    engine.attach("sensor-7", samples, total_steps=128)
    events = engine.step()        # one synchronous tick over all slots
    events += engine.drain()      # tick until no stream can advance
    engine.detach("sensor-7")     # early termination -> final event

Each emitted :class:`StreamEvent` carries the per-stream warm-up counter
state: predictions before ``warmup_samples`` total steps (paper Sec. VI-A:
median stabilization 74 samples = 1.48 s at 50 Hz) are flagged cold.

Trajectory taps (deployment parity): ``attach(..., record_trajectory=True)``
captures the stream's per-step hidden states; :meth:`StreamingEngine.trajectory`
returns them (bit-identical to ``QRuntime.run_window``'s trajectory).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.compress.artifact import ModelArtifact
from repro_torch.core import quantization as q
from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.obs.numerics import PUBLISH_EVERY, limits_from_scales
from repro_torch.serve.scheduler import HostProgram, SlotScheduler, TickReport


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    max_slots: int = 1024        # resident batch width (concurrent streams)
    window: int = 128            # samples per classification window (paper)
    warmup_samples: int = 74     # paper Sec. VI-A median t* at 50 Hz
    sample_rate_hz: float = 50.0
    reset_on_emit: bool = True   # tumbling windows (matches QRuntime.predict)
    device: Any = "cuda"         # "cuda" (the step kernel; h table resident
    # on the card, zero steady-state h bytes across the boundary) or "cpu"
    # (the plain torch step); "cuda" without a card raises
    batch_events: bool = False   # emit one columnar StreamEventBatch per
    # tick instead of per-stream StreamEvent objects (the fleet-scale path)
    ring_capacity: int = 256     # initial per-slot sample ring (grows 2x)
    max_ring_capacity: int = 1024  # growth cap: the ring is (cap, S, d)
    # shared, so one stream's deep backlog must not allocate O(S * backlog);
    # samples beyond the cap spill to a per-slot chunk queue and drain into
    # the ring as it frees


@dataclasses.dataclass
class StreamEvent:
    """One emitted prediction (window boundary, stream end, or detach)."""
    stream_id: str
    kind: str                    # "window" | "final"
    step: int                    # total per-stream samples consumed so far
    window_step: int             # samples in the window this was emitted from
    prediction: int
    logits: np.ndarray           # (C,) f32
    warm: bool                   # step >= warmup_samples (Sec. VI-A)


@dataclasses.dataclass
class StreamEventBatch:
    """Columnar emission record (``StreamingConfig.batch_events=True``):
    ONE object per tick carrying every stream that emitted, as arrays.
    At fleet scale a lockstep window boundary means 100k+ simultaneous
    emissions — building that many per-stream event objects costs more
    than the tick's model math, so the fleet path delivers predictions
    column-wise and lets the consumer fan out only where needed
    (:meth:`events` expands to per-stream :class:`StreamEvent`)."""
    stream_ids: list
    final: np.ndarray            # (k,) bool — True = "final", else "window"
    steps: np.ndarray            # (k,) int64
    window_steps: np.ndarray     # (k,) int64
    predictions: np.ndarray      # (k,) int32
    logits: np.ndarray           # (k, C) f32
    warm: np.ndarray             # (k,) bool

    def __len__(self) -> int:
        return len(self.stream_ids)

    def events(self) -> list[StreamEvent]:
        """Expand to per-stream events (convenience / compatibility)."""
        return [StreamEvent(stream_id=sid, kind="final" if f else "window",
                            step=int(st), window_step=int(ws),
                            prediction=int(p), logits=lg, warm=bool(w))
                for sid, f, st, ws, p, lg, w in zip(
                    self.stream_ids, self.final, self.steps,
                    self.window_steps, self.predictions, self.logits,
                    self.warm)]


@dataclasses.dataclass
class StreamState:
    """Portable bit-exact snapshot of one live stream (host numpy arrays)
    — the unit of fleet migration.  :meth:`StreamingEngine.export_stream`
    detaches a stream into this form (hidden state, counters, every
    not-yet-consumed sample, trajectory tap) and
    :meth:`StreamingEngine.import_stream` re-attaches it on any engine built
    from the same weights; the continued trajectory is bit-identical to
    never having moved."""
    stream_id: str
    h: np.ndarray                        # (H,) f32 hidden state
    steps: int                           # total samples consumed so far
    wstep: int                           # position in the current window
    total: int | None                    # finite stream length; None = open
    samples: np.ndarray                  # (k, d) f32 buffered, unconsumed
    record_trajectory: bool = False
    trajectory: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Session:
    """Thin per-stream handle.  Counters/cursors live in the engine's slot
    table; this only tracks identity, placement, the not-yet-placed sample
    chunks of pending streams, the finite-length target, and the
    trajectory-tap flag."""
    stream_id: str
    slot: int = -1                       # -1 -> pending (no resident slot)
    total: int | None = None             # finite stream length; None = open
    chunks: collections.deque = dataclasses.field(
        default_factory=collections.deque)   # buffered while pending
    record_trajectory: bool = False
    restore: tuple | None = None         # (h, steps, wstep, suppress)
    # migrated-in state; ``suppress`` is the replay cursor — events up to
    # and including that step were already delivered upstream and are
    # swallowed when the stream re-runs them after a crash recovery


def coerce_samples(samples, input_dim: int, stream_id: str) -> np.ndarray:
    """Canonicalize fed samples to (k, input_dim) float32 — the one
    validation shared by the engine's ``feed`` and the fleet's spillover
    queue, so the two paths cannot drift."""
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[None, :]
    if samples.ndim != 2 or samples.shape[1] != input_dim:
        raise ValueError(
            f"stream {stream_id!r}: samples must be (k, "
            f"{input_dim}), got {samples.shape}")
    return samples


def coerce_qp(params_or_qp, quant: q.QuantConfig | None = None
              ) -> q.QuantizedParams:
    """Normalize any accepted model form to :class:`QuantizedParams`:
    a :class:`ModelArtifact` yields its quantized params (deployed config:
    FP32 acts through the LUT — the artifact's deploy calibration scales
    are export-compiler scales, NOT activation-storage scales; opt into
    Table V storage quant via ``from_artifact(quantized_acts=True)``);
    a float param dict gets per-tensor Q15 PTQ (Appendix B)."""
    if isinstance(params_or_qp, ModelArtifact):
        return params_or_qp.require_qp()
    if isinstance(params_or_qp, q.QuantizedParams):
        return params_or_qp
    return q.quantize_params(params_or_qp, quant or q.QuantConfig())


class StreamingEngine:
    """Slot-based continuous batching of stateful FastGRNN sessions."""

    def __init__(self, params_or_qp, config: StreamingConfig | None = None,
                 *, quant: q.QuantConfig | None = None,
                 act_scales: dict[str, float] | None = None,
                 naive_acts: bool = False,
                 obs: Observability | None = None):
        self.qp = coerce_qp(params_or_qp, quant)
        config = config or StreamingConfig()
        self.config = config
        # observability seam (repro_torch.obs): NULL_OBS keeps every hook a
        # no-op so the bit-exact fast path is untouched by default
        self._obs = obs or NULL_OBS
        self._tracer = self._obs.tracer
        self._obs_shard = -1        # fleet shard index tag (set by owner)
        self._last_advanced = 0
        # numeric-health seam (repro_torch.obs.numerics): resolved lazily
        # via _numerics(); the kernel-side event dict is engine-owned and
        # flushed per tick
        self._num_cache: tuple[int, Any] | None = None
        self._num_events: dict[str, Any] = {}
        self._num_pub_tick = 0
        self.kernel = Q15StreamStep(self.qp, act_scales=act_scales,
                                    naive_acts=naive_acts,
                                    device=config.device)
        self._device_resident = self.kernel.supports_device_state
        S, d = config.max_slots, self.kernel.input_dim
        self._h = (self.kernel.init_state_device(S) if self._device_resident
                   else self.kernel.init_state(S))
        self._h_inflight = False  # a step_resident launch is in flight:
        # _advance_begin must wait for its x/mask h2d copies before the
        # gather overwrites the pinned _x staging buffer they read from
        self._h_prefetch = None   # identity-keyed (h, {slot: row}) one-shot
        # cache for batched snapshot pulls; every step/reset returns a NEW
        # h tensor (the kernel never updates in place), which invalidates it
        self._x = self.kernel.staging_buffer(S)
        # --- slot table (vectorized workload state) --------------------
        self._steps = np.zeros(S, np.int64)      # samples consumed
        self._wstep = np.zeros(S, np.int64)      # position in current window
        self._total = np.full(S, -1, np.int64)   # finite length; -1 = open
        self._head = np.zeros(S, np.int64)       # ring read cursor (absolute)
        self._tail = np.zeros(S, np.int64)       # ring write cursor (absolute)
        self._cap = max(8, min(config.ring_capacity, config.max_ring_capacity))
        # ring layout is (cap, S, d) — offset-major, not slot-major: a
        # fleet of 50 Hz sensors advances in lockstep, so the per-tick
        # gather usually reads ONE contiguous (S, d) slab instead of S
        # strided rows (measured ~50x cheaper at 16k slots; the slot-major
        # layout made the gather cost more than the step kernel)
        self._ring = np.zeros((self._cap, S, d), np.float32)
        self._spill: dict[int, collections.deque] = {}  # slot -> chunk queue
        self._tap = np.zeros(S, bool)            # trajectory-tap flag
        self._n_taps = 0                         # fast skip of the tap scan
        self._suppress = np.full(S, -1, np.int64)  # replay cursor: events at
        # steps <= this were already delivered before a crash; re-emissions
        # during replay are swallowed (state transitions still happen, so
        # the recovered trajectory stays bit-identical)
        self._warm_seen = np.zeros(S, bool)  # per-slot: this stream already
        # emitted a warm (post-warm-up) prediction — gates the once-per-
        # stream warm-up-samples metric (paper contribution ii, measured
        # continuously in serving)
        # --- placement: delegated to the shared slot scheduler ---------
        self._sched = SlotScheduler(S, HostProgram(self),
                                    tracer=self._tracer)
        self._sessions: dict[str, _Session] = {}
        self._trajectories: dict[str, list[np.ndarray]] = {}
        # telemetry (workload side; placement counters live in the scheduler)
        self._stream_steps = 0
        self._ring_spills = 0
        self._replay_suppressed = 0   # events swallowed by the replay cursor

    @classmethod
    def from_artifact(cls, artifact: ModelArtifact,
                      config: StreamingConfig | None = None, *,
                      quantized_acts: bool = False,
                      naive_acts: bool = False,
                      obs: Observability | None = None) -> "StreamingEngine":
        """Build the engine from a compression-pipeline artifact.  The
        default is the deployed configuration (FP32 acts, bit-identical to
        ``QRuntime.from_artifact``); ``quantized_acts=True`` selects the
        Table V calibrated-Q15-activation mode via
        ``ModelArtifact.runtime_scales`` (the gate shared with QRuntime).
        When the bundle carries a :class:`~repro_torch.obs.numerics.NumericsMonitor`,
        the artifact's deploy calibration scales are late-bound into it as
        per-tensor drift limits."""
        eng = cls(artifact, config,
                  act_scales=artifact.runtime_scales(quantized_acts),
                  naive_acts=naive_acts, obs=obs)
        if obs is not None and obs.numerics is not None \
                and artifact.act_scales:
            obs.numerics.set_default_limits(
                limits_from_scales(artifact.act_scales))
        return eng

    # ------------------------------------------------------------------
    # Session lifecycle
    # ------------------------------------------------------------------
    def attach(self, stream_id: str, samples: np.ndarray | None = None, *,
               total_steps: int | None = None,
               record_trajectory: bool = False) -> str:
        """Register a stream.  Returns ``"active"`` if a slot was free,
        ``"pending"`` if the stream was queued for the next free slot.

        ``samples``: optional initial (k, d) buffer; more via :meth:`feed`.
        ``total_steps``: finite stream length — the session auto-finishes
        (emitting a final event and recycling its slot) after that many
        samples.  ``None`` keeps the stream open until :meth:`detach`.
        ``record_trajectory``: tap the per-step hidden states (bit-identical
        to the scalar reference trajectory).
        """
        if stream_id in self._sessions:
            raise ValueError(f"stream {stream_id!r} already attached")
        s = _Session(stream_id=stream_id, total=total_steps,
                     record_trajectory=record_trajectory)
        self._sessions[stream_id] = s
        if record_trajectory:
            self._trajectories[stream_id] = []
        if samples is not None:
            self.feed(stream_id, samples)
        # the scheduler preserves FIFO fairness: a free slot goes to the
        # new stream only when no earlier stream is already waiting
        return self._sched.submit(stream_id, s)

    def feed(self, stream_id: str, samples: np.ndarray) -> None:
        """Append samples ((d,) or (k, d)) to a stream's input buffer."""
        s = self._sessions[stream_id]
        samples = coerce_samples(samples, self.kernel.input_dim, stream_id)
        if s.slot < 0:
            s.chunks.append(samples)
        else:
            self._ring_write(s.slot, samples)

    def detach(self, stream_id: str) -> StreamEvent | None:
        """Terminate a stream at a step boundary.  If it consumed samples
        since its last window emission, a ``"final"`` event for the partial
        window is returned; its slot is recycled to the pending queue."""
        if stream_id not in self._sessions:
            raise KeyError(f"stream {stream_id!r} is not attached")
        ev = self._sched.cancel(stream_id)
        self._sessions.pop(stream_id, None)   # pending path (resident path
        return ev                             # popped in _release_slot)

    # ------------------------------------------------------------------
    # Live migration (fleet rebalancing / shard drain)
    # ------------------------------------------------------------------
    def snapshot_stream(self, stream_id: str) -> StreamState:
        """Copy a live stream into a portable :class:`StreamState` —
        hidden state, step/window counters, every buffered-but-unconsumed
        sample (ring + spill backlog, FIFO order preserved), and a copy of
        the trajectory tap — *without* detaching it.  This is the fleet's
        periodic-checkpoint primitive: the stream keeps running, and the
        snapshot (wire-encoded via ``serve/fleet/wire.py``) plus the
        samples fed after it deterministically reproduce the stream's
        future on a replacement shard."""
        if stream_id not in self._sessions:
            raise KeyError(f"stream {stream_id!r} is not attached")
        s = self._sessions[stream_id]
        d = self.kernel.input_dim
        if s.slot >= 0:
            slot = s.slot
            n = int(self._tail[slot] - self._head[slot])
            idx = (self._head[slot] + np.arange(n)) % self._cap
            parts = [self._ring[idx, slot]] if n else []
            parts += list(self._spill.get(slot, ()))
            return StreamState(
                stream_id=stream_id,
                h=self._h_row(slot),
                steps=int(self._steps[slot]),
                wstep=int(self._wstep[slot]),
                total=None if self._total[slot] < 0 else int(self._total[slot]),
                samples=(np.concatenate(parts) if parts
                         else np.zeros((0, d), np.float32)),
                record_trajectory=s.record_trajectory,
                trajectory=list(self._trajectories.get(stream_id, ())))
        # pending: never stepped HERE — but a migrated-in stream that
        # is still waiting for a slot carries its restored hidden
        # state/counters on the session; those must travel onward, or
        # a second migration would silently rewind the stream to zero
        if s.restore is not None:
            h0, steps0, wstep0 = s.restore[:3]
            h0 = h0.copy()
        else:
            h0 = np.zeros(self.kernel.hidden_dim, np.float32)
            steps0 = wstep0 = 0
        parts = list(s.chunks)
        return StreamState(
            stream_id=stream_id,
            h=h0, steps=steps0, wstep=wstep0, total=s.total,
            samples=(np.concatenate(parts) if parts
                     else np.zeros((0, d), np.float32)),
            record_trajectory=s.record_trajectory,
            trajectory=list(self._trajectories.get(stream_id, ())))

    def export_stream(self, stream_id: str) -> StreamState:
        """Detach a stream into a portable :class:`StreamState` snapshot
        (see :meth:`snapshot_stream` for what travels).  No event is
        emitted and the departure is counted as a scheduler *eviction*,
        not a cancellation.  Re-attaching the snapshot via
        :meth:`import_stream` on any engine built from the same weights
        continues the stream bit-identically."""
        state = self.snapshot_stream(stream_id)
        self._trajectories.pop(stream_id, None)
        self._sched.evict(stream_id)          # resident path pops session
        self._sessions.pop(stream_id, None)   # pending path
        return state

    def import_stream(self, state: StreamState, *,
                      suppress_steps_until: int | None = None) -> str:
        """Re-attach a migrated stream from a :class:`StreamState`.
        Returns ``"active"``/``"pending"`` like :meth:`attach`.  The
        snapshot's hidden state and counters are restored into the slot at
        admission time, so a stream that waits in the pending queue first
        still resumes exactly where it left off.

        ``suppress_steps_until``: replay cursor for crash failover — the
        consumer already saw this stream's events up to and including
        that step, so re-emissions at steps <= it are swallowed (counted
        in ``stats()["replay_suppressed"]``) while the state transitions
        they mark (window reset, completion) still run, keeping the
        recovered trajectory bit-identical to the uninterrupted one."""
        if state.stream_id in self._sessions:
            raise ValueError(f"stream {state.stream_id!r} already attached")
        s = _Session(stream_id=state.stream_id, total=state.total,
                     record_trajectory=state.record_trajectory,
                     restore=(np.asarray(state.h, np.float32).copy(),
                              int(state.steps), int(state.wstep),
                              -1 if suppress_steps_until is None
                              else int(suppress_steps_until)))
        self._sessions[state.stream_id] = s
        if state.record_trajectory:
            self._trajectories[state.stream_id] = list(state.trajectory)
        if len(state.samples):
            s.chunks.append(np.asarray(state.samples, np.float32))
        return self._sched.submit(state.stream_id, s)

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------
    def step(self) -> list[StreamEvent]:
        """One synchronous tick: the scheduler admits pending streams into
        free slots, the program advances every resident stream that has a
        buffered sample by exactly one step, and window/final events are
        emitted.  Streams without buffered samples idle (hidden state held
        bit-for-bit)."""
        if not self._obs.enabled:
            return self._sched.tick()
        tr = self._tracer
        self._last_advanced = 0
        t0 = tr.t()
        events = self._sched.tick()
        dur_ns = tr.rec("engine.tick", t0, self._obs_shard)
        if self._obs.metrics is not None:
            self._tick_metrics(dur_ns, self._last_advanced)
        return events

    def _tick_metrics(self, dur_ns: int, advanced: int) -> None:
        """Tick-latency SLO accounting for a standalone engine (a fleet
        shard's ticks are accounted by the fleet front door instead)."""
        reg = self._obs.metrics
        us = dur_ns / 1e3
        reg.histogram("engine.tick_us", "wall time of one engine tick",
                      wallclock=True).observe_us(us)
        deadline_ms = self._obs.deadline_ms
        if deadline_ms is None:
            deadline_ms = 1e3 / self.config.sample_rate_hz
        if us > deadline_ms * 1e3 and advanced:
            reg.counter("engine.deadline_miss_ticks",
                        "ticks over the per-sample deadline",
                        wallclock=True).inc()
            reg.counter("engine.deadline_miss_stream_ticks",
                        "stream-steps advanced in ticks that missed "
                        "the deadline", wallclock=True).inc(advanced)
        mon = self._numerics()
        if mon is not None and self._obs_shard < 0:
            # standalone engines publish their own (-1) child; a fleet
            # shard's counts are published by the fleet front door instead
            # (publishing both would double-count into the same registry).
            # Publish on a cadence, not per tick: the export walks every
            # site/tensor and recomputes drift, which dominates monitor
            # cost on small models; counters are delta-tracked so a
            # throttled publish loses nothing.
            self._num_pub_tick += 1
            if self._num_pub_tick >= PUBLISH_EVERY:
                self._num_pub_tick = 0
                mon.publish(reg)

    def drain(self) -> list[StreamEvent]:
        """Tick until no resident or pending stream can advance (buffers
        empty).  Open streams stay attached; feed more and step again."""
        events: list[StreamEvent] = []
        while self._any_buffered():
            out = self.step()
            if not out and not bool(np.any(
                    self._sched.resident & (self._tail > self._head))):
                break  # only pending streams hold samples and no slot frees
            events.extend(out)
        return events

    # ------------------------------------------------------------------
    # Trajectory taps (deployment parity harness)
    # ------------------------------------------------------------------
    def trajectory(self, stream_id: str) -> np.ndarray:
        """(steps, H) hidden trajectory of a tapped stream (attach with
        ``record_trajectory=True``).  Survives stream completion/detach."""
        if stream_id not in self._trajectories:
            raise KeyError(f"stream {stream_id!r} was not tapped")
        rows = self._trajectories[stream_id]
        H = self.kernel.hidden_dim
        return (np.stack(rows) if rows else np.zeros((0, H), np.float32))

    # ------------------------------------------------------------------
    # SlotProgram hooks (called by the scheduler via HostProgram)
    # ------------------------------------------------------------------
    def _admit_slot(self, slot: int, stream_id: str, s: _Session,
                    reset: bool) -> None:
        s.slot = slot
        if reset:  # recycled slot: zero the previous stream's hidden state
            mask = np.arange(self.config.max_slots) == slot
            if self._device_resident:
                self._h = self.kernel.reset_device(self._h, mask)
            else:
                self._h = self.kernel.reset(self._h, mask)
        self._steps[slot] = 0
        self._wstep[slot] = 0
        self._total[slot] = -1 if s.total is None else int(s.total)
        self._head[slot] = 0
        self._tail[slot] = 0
        self._tap[slot] = s.record_trajectory
        self._n_taps += int(s.record_trajectory)
        self._suppress[slot] = -1
        self._warm_seen[slot] = False
        if s.restore is not None:     # migrated-in stream: resume, don't reset
            h0, steps0, wstep0, suppress0 = s.restore
            if self._device_resident:
                self._h = self.kernel.set_rows_device(
                    self._h, np.array([slot]), h0[None])
            else:
                self._h[slot] = torch.from_numpy(h0)
            self._steps[slot] = steps0
            self._wstep[slot] = wstep0
            self._suppress[slot] = suppress0
            # a migrated-in stream past warm-up already reported its
            # warm-up sample count on its previous shard
            self._warm_seen[slot] = steps0 >= self.config.warmup_samples
            s.restore = None
        while s.chunks:
            self._ring_write(slot, s.chunks.popleft())

    def _numerics(self):
        """This engine's numeric-health monitor — the shard child of the
        bundle's :class:`~repro_torch.obs.numerics.NumericsMonitor`
        (resolved lazily and cached; -1 = standalone).  None when
        monitoring is off, which keeps every numerics hook a dead branch."""
        mon = self._obs.numerics
        if mon is None:
            return None
        cache = self._num_cache
        if cache is not None and cache[0] == self._obs_shard:
            return cache[1]
        child = mon.shard(self._obs_shard)
        child.declare(("act.z.idx", "act.ht.idx"))
        self._num_cache = (self._obs_shard, child)
        return child

    def _flush_numeric_events(self, mon) -> None:
        """Fold the kernel-side event dict (filled by
        ``qstep.tally_step_events``) into the monitor, once per tick."""
        ev = self._num_events
        counts = {}
        for k in ("act.z.idx", "act.ht.idx"):
            n = ev.pop(k, 0)
            if n:
                counts[k] = n
        if counts:
            mon.count_events(counts)
        pr = ev.pop("pre_range", None)
        if pr is not None:
            mon.note_range("pre", pr[0], pr[1], pr[2], pr[3])

    def _advance(self, resident: np.ndarray) -> TickReport:
        handle = self._advance_begin(resident)
        if handle is None:
            return TickReport()
        avail, rows = handle
        mon = self._numerics()
        tr = self._tracer
        t0 = tr.t()
        if self._device_resident:
            # asynchronous launch into a NEW h tensor, adopted at once —
            # emission/tap row pulls (and the staging wait at the top of
            # the NEXT _advance_begin) are the only places the host waits
            # on the card.  Per-tick numeric tallies are skipped on the
            # resident path (a host recompute would defeat the zero-h-copy
            # contract); emission-row drift telemetry still applies.
            h_new = self.kernel.step_resident(self._h, self._x, avail)
            self._h_inflight = True
        else:
            if mon is not None:
                self.kernel.numeric_events = self._num_events
            h_new = self.kernel.step_rows(self._h, self._x, avail, rows)
            if mon is not None:
                self.kernel.numeric_events = None
                self._flush_numeric_events(mon)
        tr.rec("engine.kernel", t0, self._obs_shard)
        return self._advance_finish(handle, h_new)

    def _advance_begin(self, resident: np.ndarray):
        """Phase one of a tick: compute the advancing-row set and gather one
        sample per advancing slot from the ring into ``self._x``.  Returns
        ``(avail, rows)`` for :meth:`_advance_finish`, or ``None`` when no
        resident stream has a buffered sample.  Split from the kernel call
        so a fleet front door can batch every shard's step into one fused
        launch per tick."""
        if self._h_inflight:
            # the previous tick's asynchronous h2d copy may still be
            # reading the pinned _x staging buffer — wait for it before
            # the gather below overwrites it (everything since the last
            # launch overlapped device work)
            t0 = self._tracer.t()
            self.kernel.wait_staged()
            self._tracer.rec("engine.device_wait", t0, self._obs_shard)
            self._h_inflight = False
        avail = resident & (self._tail > self._head)
        rows = np.nonzero(avail)[0]
        if rows.size == 0:
            return None
        t0 = self._tracer.t()
        # gather one sample per advancing slot from the ring (vectorized)
        x = self._x
        full = rows.size == x.shape[0]
        heads = self._head if full else self._head[rows]
        if np.all(heads == heads[0]):  # lockstep fleet: contiguous slab
            o = int(heads[0]) % self._cap
            if full:
                x[:] = self._ring[o]
            else:
                x[:] = 0.0
                x[rows] = self._ring[o, rows]
        else:                          # streams drifted apart: 2-d gather
            x[:] = 0.0
            x[rows] = self._ring[heads % self._cap, rows]
        self._tracer.rec("engine.gather", t0, self._obs_shard)
        mon = self._numerics()
        if mon is not None:
            # input-range telemetry from the already-gathered staging slab
            # (runs on both the standalone _advance path and the fleet's
            # fused tick, which calls the begin/finish halves directly)
            xv = x[rows]
            xl = mon.limit("x")
            xmin, xmax = float(xv.min()), float(xv.max())
            # min/max bound the elementwise scan: only count when the
            # slab actually crosses the calibration amplitude
            n_over = int(np.count_nonzero(np.abs(xv) > xl)) \
                if xl and (xmax > xl or xmin < -xl) else 0
            mon.note_range("x", xmin, xmax, int(xv.size), n_over)
            lim = mon.limit("pre")
            if lim:
                self._num_events["pre_limit"] = lim
        return (avail, rows)

    def _advance_finish(self, handle, h_new: torch.Tensor) -> TickReport:
        """Phase two of a tick: accept the stepped hidden states and do the
        bookkeeping — cursors, counters, trajectory taps, window/final
        emission, tumbling-window resets."""
        avail, rows = handle
        t_fin = self._tracer.t()
        self._last_advanced = int(rows.size)
        self._h = h_new
        if rows.size == self._head.size:     # steady state: every slot moved
            self._head += 1
            self._steps += 1
            self._wstep += 1
        else:
            self._head[rows] += 1
            self._steps[rows] += 1
            self._wstep[rows] += 1
        self._stream_steps += int(rows.size)
        if self._spill:
            self._drain_spill()

        if self._n_taps and np.any(self._tap[rows]):
            tap_rows = np.nonzero(self._tap & avail)[0]
            vals = self._h_rows(tap_rows)
            for i, slot in enumerate(tap_rows):
                sid = self._sched.request_at(int(slot))
                self._trajectories[sid].append(vals[i].copy())

        # emission: window boundaries + finished streams (rare -> loops)
        window = self.config.window
        at_window = avail & (self._wstep == window)
        finished = avail & (self._total >= 0) & (self._steps >= self._total)
        emit_rows = np.nonzero(at_window | finished)[0]
        events: list[StreamEvent] = []
        finished_rows: list[int] = []
        if emit_rows.size:               # rare tick: something emits
            t_emit = self._tracer.t()
            # replay cursor: events the consumer already saw before a
            # crash are swallowed; window-reset/finish bookkeeping below
            # still uses the full emit set, so the recovered state
            # transitions are identical to the uninterrupted run
            deliver = emit_rows[
                self._steps[emit_rows] > self._suppress[emit_rows]]
            self._replay_suppressed += int(emit_rows.size - deliver.size)
            if deliver.size:
                h_emit = self._h_rows(deliver)
                logits = self.kernel.head_logits(h_emit).numpy()
                mon = self._numerics()
                if mon is not None:
                    # full-histogram drift stats on the rare emission path
                    mon.observe("h", h_emit)
                    mon.observe("logits", logits)
                if self.config.batch_events:
                    events.append(self._event_batch(deliver, at_window,
                                                    logits))
                else:
                    for i, slot in enumerate(deliver):
                        kind = "window" if at_window[slot] else "final"
                        events.append(self._event(
                            self._sched.request_at(int(slot)), int(slot),
                            kind, int(self._wstep[slot]), logits[i]))
                if self._obs.metrics is not None:
                    self._emit_metrics(deliver)
            finished_rows = np.nonzero(finished)[0].tolist()
            if np.any(at_window):
                self._wstep[at_window] = 0
                if self.config.reset_on_emit:
                    if self._device_resident:
                        self._h = self.kernel.reset_device(self._h, at_window)
                    else:
                        self._h = self.kernel.reset(self._h, at_window)
            self._tracer.rec("engine.emit", t_emit, self._obs_shard)
        self._tracer.rec("engine.finish", t_fin, self._obs_shard)
        return TickReport(events=events, finished=finished_rows,
                          advanced=int(rows.size))

    def _emit_metrics(self, deliver: np.ndarray) -> None:
        """Per-emission SLO metrics (only when a registry is attached):
        warm/cold prediction counters, and the once-per-stream warm-up
        sample count — how many samples a stream consumed before its
        first confident (post-warm-up) prediction, the paper's Sec. VI-A
        stabilization latency measured continuously in serving."""
        reg = self._obs.metrics
        steps = self._steps[deliver]
        warm = steps >= self.config.warmup_samples
        n_warm = int(warm.sum())
        reg.counter("stream.warm_emissions",
                    "predictions at/after the warm-up threshold").inc(n_warm)
        reg.counter("stream.cold_emissions",
                    "predictions before the warm-up threshold").inc(
                        int(deliver.size) - n_warm)
        first = warm & ~self._warm_seen[deliver]
        if np.any(first):
            reg.histogram(
                "stream.warmup_samples",
                "samples consumed before a stream's first warm "
                "prediction (axis = samples, not us)").observe_many_us(
                    steps[first])
            self._warm_seen[deliver[first]] = True

    def _release_slot(self, slot: int, stream_id: str,
                      reason: str) -> StreamEvent | None:
        ev = None
        if reason == "cancelled" and self._wstep[slot] > 0:
            if self._steps[slot] > self._suppress[slot]:
                # detach mid-window: emit the partial-window prediction
                logits = self.kernel.head_logits(
                    self._h_rows(np.array([slot])))[0].numpy()
                ev = self._event(stream_id, slot, "final",
                                 int(self._wstep[slot]), logits)
            else:
                self._replay_suppressed += 1
        s = self._sessions.pop(stream_id, None)
        if s is not None:
            s.slot = -1
        self._n_taps -= int(self._tap[slot])
        self._tap[slot] = False
        self._head[slot] = 0
        self._tail[slot] = 0
        self._spill.pop(slot, None)
        return ev

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _h_rows(self, rows) -> np.ndarray:
        """Host values of the given hidden-state rows, device-agnostic:
        a plain fancy-index copy on the CPU path, a booked (k, H) d2h
        pull on the device-resident path (only the rows the host actually
        needs — emission, taps — ever cross the boundary)."""
        if self._device_resident:
            return self.kernel.rows_to_host(self._h, rows)
        return self._h.numpy()[np.asarray(rows)]

    def _h_row(self, slot: int) -> np.ndarray:
        """One hidden-state row as a fresh host copy (snapshot path).
        Consults the :meth:`prefetch_h` cache so fleet-wide periodic
        checkpoints cost one batched gather, not one device round-trip
        per checkpointed stream."""
        if self._device_resident:
            cache = self._h_prefetch
            if cache is not None and cache[0] is self._h and slot in cache[1]:
                return cache[1][slot].copy()
            return self.kernel.rows_to_host(self._h, np.array([slot]))[0]
        return self._h[slot].numpy().copy()

    def prefetch_h(self, slots) -> None:
        """Batch-pull the given slots' hidden rows into a one-shot cache
        keyed on the current device tensor's *identity* — any subsequent
        step/reset rebinds ``self._h`` to a new tensor and invalidates it
        automatically.  No-op on the host path, where the rows are already
        resident."""
        if not self._device_resident or len(slots) == 0:
            return
        rows = np.asarray(slots)
        h = self._h
        vals = self.kernel.rows_to_host(h, rows)
        self._h_prefetch = (h, {int(s): v for s, v in zip(rows, vals)})

    def _any_buffered(self) -> bool:
        if bool(np.any(self._sched.resident & (self._tail > self._head))):
            return True
        if self._spill:
            return True
        return any(s.chunks for s in self._sessions.values() if s.slot < 0)

    def _ring_write(self, slot: int, samples: np.ndarray) -> None:
        k = len(samples)
        if k == 0:
            return
        if slot in self._spill:          # keep FIFO order behind the spill
            self._spill[slot].append(samples)
            return
        needed = int(self._tail[slot] - self._head[slot]) + k
        if needed > self._cap and self._cap < self.config.max_ring_capacity:
            self._grow_ring(min(needed, self.config.max_ring_capacity))
        space = self._cap - int(self._tail[slot] - self._head[slot])
        take = min(space, k)
        if take:
            idx = (self._tail[slot] + np.arange(take)) % self._cap
            self._ring[idx, slot] = samples[:take]
            self._tail[slot] += take
        if take < k:                     # backlog beyond the shared ring
            self._spill[slot] = collections.deque([samples[take:]])
            self._ring_spills += 1

    def _drain_spill(self) -> None:
        """Refill rings from spilled backlogs as space frees (rare path —
        only slots that were ever fed past max_ring_capacity)."""
        for slot in list(self._spill):
            q = self._spill[slot]
            while q:
                space = self._cap - int(self._tail[slot] - self._head[slot])
                if space <= 0:
                    break
                chunk = q.popleft()
                take = min(space, len(chunk))
                idx = (self._tail[slot] + np.arange(take)) % self._cap
                self._ring[idx, slot] = chunk[:take]
                self._tail[slot] += take
                if take < len(chunk):
                    q.appendleft(chunk[take:])
                    break
            if not q:
                del self._spill[slot]

    def _grow_ring(self, needed: int) -> None:
        new_cap = self._cap
        while new_cap < needed:
            new_cap *= 2
        new_cap = min(new_cap, max(self.config.max_ring_capacity, self._cap))
        if new_cap == self._cap:
            return
        ring = np.zeros((new_cap, self._ring.shape[1], self._ring.shape[2]),
                        np.float32)
        navail = self._tail - self._head
        for slot in np.nonzero(navail > 0)[0]:
            n = int(navail[slot])
            idx = (self._head[slot] + np.arange(n)) % self._cap
            ring[:n, slot] = self._ring[idx, slot]
        self._head[:] = 0                 # re-base cursors onto the copy
        self._tail[:] = navail
        self._ring, self._cap = ring, new_cap

    def _event_batch(self, emit_rows: np.ndarray, at_window: np.ndarray,
                     logits: np.ndarray) -> StreamEventBatch:
        """Columnar emission: every per-stream field sliced as an array;
        the only per-row Python is the slot -> stream-id lookup."""
        req = self._sched._slot_request
        steps = self._steps[emit_rows]
        return StreamEventBatch(
            stream_ids=[req[i] for i in emit_rows.tolist()],
            final=~at_window[emit_rows],
            steps=steps,
            window_steps=self._wstep[emit_rows],
            predictions=np.argmax(logits, axis=1).astype(np.int32),
            logits=np.asarray(logits, np.float32),
            warm=steps >= self.config.warmup_samples)

    def _event(self, stream_id: str, slot: int, kind: str, window_step: int,
               logits: np.ndarray) -> StreamEvent:
        steps = int(self._steps[slot])
        return StreamEvent(
            stream_id=stream_id, kind=kind, step=steps,
            window_step=window_step or self.config.window,
            prediction=int(np.argmax(logits)),
            logits=np.asarray(logits, np.float32).copy(),
            warm=steps >= self.config.warmup_samples)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return self._sched.n_active

    @property
    def n_pending(self) -> int:
        return self._sched.n_pending

    def stats(self) -> dict[str, Any]:
        sched = self._sched.stats()
        mon = self._numerics()
        extra = {} if mon is None else {"numerics": mon.snapshot()}
        return {
            **extra,
            "device": str(self.kernel.device),
            "device_resident": self._device_resident,
            "transfers": self.kernel.transfers.snapshot(),
            "max_slots": self.config.max_slots,
            "active": sched["active"],
            "pending": sched["pending"],
            "peak_active": sched["peak_active"],
            "ticks": sched["ticks"],
            "stream_steps": self._stream_steps,
            "completed": sched["completed"] + sched["cancelled"],
            "ring_capacity": self._cap,
            "ring_spills": self._ring_spills,
            "replay_suppressed": self._replay_suppressed,
            # scheduler counters (admissions/recycles/spills/occupancy):
            # the observability surface the sharded-streaming work needs
            "scheduler": sched,
        }


def classify_windows(engine: StreamingEngine, windows: np.ndarray,
                     ids: Iterable[str] | None = None) -> np.ndarray:
    """Convenience: replay (N, T, d) windows as N finite streams through the
    engine (continuous batching if N > max_slots) and return the (N,) final
    predictions — the streaming equivalent of ``QRuntime.predict_batch``."""
    windows = np.asarray(windows, np.float32)
    ids = list(ids) if ids is not None else [f"w{i}" for i in range(len(windows))]
    for sid, w in zip(ids, windows):
        engine.attach(sid, w, total_steps=len(w))
    events = engine.drain()
    final: dict[str, int] = {}
    for e in events:
        if isinstance(e, StreamEventBatch):
            final.update(zip(e.stream_ids, (int(p) for p in e.predictions)))
        elif e.kind in ("window", "final"):
            final[e.stream_id] = e.prediction
    return np.array([final[sid] for sid in ids], np.int32)
