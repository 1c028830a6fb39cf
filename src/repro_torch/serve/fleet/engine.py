"""FleetEngine: one front door over N independent StreamingEngine shards.

The port of the reference's ``repro.serve.fleet.engine``.  On the CPU every
fleet event log is byte-identical to the reference's exact fleet
(``tests/test_torch_fleet.py``, ``tests/test_torch_failover.py``).  On the
card each device group's fused tick is ONE launch of the step kernel
(``csrc/q15_step.cu``, or ``csrc/q15_step_dense.cu`` under
``StreamingConfig.mxu``) over the group's device-resident hidden-state
table; only x and the active mask cross host-to-device on a steady tick.

The paper deploys one FastGRNN per device at 50 Hz; the cloud-side
complement is a process that serves *fleets* of such sensors — more
concurrent streams than one slot table should hold.  This module shards
the slot axis: N :class:`~repro_torch.serve.streaming.StreamingEngine`
shards, each with its own :class:`~repro_torch.serve.scheduler.SlotScheduler` (slot
table, pending FIFO, counters), composed behind one engine-shaped API.

Design
------
* **Routing** — deterministic rendezvous (HRW) hashing
  (``fleet/routing.py``): a stream's home shard is a pure function of its
  id and the eligible-shard set, stable across processes and under shard
  drain (removing a shard remaps only that shard's streams).
* **Admission** — shard-local: the home shard's scheduler places or
  queues the stream.  With ``max_pending_per_shard`` set, a saturated
  shard overflows into the fleet-level FIFO *spillover queue*; every tick
  drains it into the home shard when room frees, or the least-loaded
  eligible shard (deterministic tie-break) when the home stays hot.
* **Migration** — live and bit-exact: ``migrate()`` snapshots a stream
  off its shard (:meth:`StreamingEngine.export_stream` — hidden state,
  counters, unconsumed samples, trajectory tap) and re-attaches it on the
  destination (:meth:`~StreamingEngine.import_stream`).  The continued
  trajectory is bit-identical to never having moved; ``decommission()``
  uses this to drain a shard onto each
  stream's next-best rendezvous shard.
* **Fused ticks** — "batch across shards in one tick": shards run
  admission and sample-gather independently (`SlotScheduler.tick_begin` +
  `StreamingEngine._advance_begin`), then the fleet concatenates every
  co-located shard's (h, x, active) and makes ONE batched
  ``Q15StreamStep`` launch per device group, then each shard finishes
  its own bookkeeping.  The per-row math is row-independent, so fusion
  preserves the bit-exactness contract while amortizing per-launch
  overhead across shards.
* **Placement** — every shard runs on the device of
  ``config.stream.device`` (``fleet/placement.py``): round-robin over the
  cards for ``cuda``, the CPU for ``cpu``.  Asking for the card without
  one raises; nothing falls back to the CPU.
* **Counters compose** — ``stats()`` sums every scheduler/workload
  counter across shards (admissions, recycles, spills, occupancy,
  evictions, …) and preserves the per-shard breakdown, plus fleet-level
  counters (``global_spills``, ``migrations``, fleet ticks).

Every stream remains **bit-identical** to the single-engine
``StreamingEngine`` regardless of shard count, routing, or mid-stream
migration, on the CPU and on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable

import numpy as np

import torch

from repro_torch.core import quantization as q
from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
from repro_torch.obs import (NULL_OBS, TRANSFER_KEYS, Observability,
                             assert_conservation, merge_site_counts,
                             sum_transfers)
from repro_torch.obs.numerics import PUBLISH_EVERY
from repro_torch.serve.scheduler import TickReport
from repro_torch.serve.streaming import (StreamEvent, StreamEventBatch,
                                         StreamState, StreamingConfig,
                                         StreamingEngine, classify_windows,
                                         coerce_qp, coerce_samples)
from . import placement, routing, wire
from .faults import PHASES, FaultInjector


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet shape.  ``stream`` is the per-shard template —
    ``stream.max_slots`` is the *per-shard* resident width, so fleet
    capacity is ``shards * stream.max_slots`` resident streams."""
    shards: int = 4
    stream: StreamingConfig = dataclasses.field(
        default_factory=StreamingConfig)
    max_pending_per_shard: int | None = None  # None = shard FIFOs unbounded
    # (nothing ever reaches the fleet spillover queue)
    snapshot_every: int | None = None   # crash-failover checkpoint cadence
    # in fleet ticks (None = failover disabled: no snapshots, no sample
    # journal, ``crash_shard`` refuses).  Every ``snapshot_every`` ticks
    # each live stream is wire-encoded (``fleet/wire.py``) into the
    # snapshot store; samples fed since a stream's last stored snapshot
    # are journaled, so snapshot + journal replay reconstructs the stream
    # bit-exactly on a replacement shard


@dataclasses.dataclass
class _JournalEntry:
    """Replay journal of one failover-protected stream: every sample
    chunk fed since the stream's last *stored* snapshot (cleared only on
    a successful store, so a dropped/duplicated snapshot just deepens the
    replay), plus the attach-time facts a zero-state recovery needs when
    no snapshot was ever stored."""
    total: int | None
    record_trajectory: bool
    chunks: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _SpillEntry:
    """A stream waiting in the fleet-level spillover queue (every shard it
    may route to is saturated).  Buffers samples until placement."""
    chunks: list
    total: int | None
    record_trajectory: bool


@dataclasses.dataclass
class _DeviceGroup:
    """Fused-launch state of one device group (the co-located shards
    whose ticks batch into ONE kernel launch).  ``x_big`` is the group
    kernel's staging buffer (pinned host memory on the card) and each
    shard's ``_x`` is a view of it, so phase-1 ring gathers write the fused
    x operand in place and the launch copies it h2d with no host copy;
    ``h_big`` is last tick's fused output with per-shard views handed
    back, adopted as this tick's h operand whenever every shard still
    holds its view (steady state: zero copies besides the kernel's own
    output — and on the card ``h_big`` stays device-resident, so
    steady-state ticks never move a single h byte across the host/device
    boundary)."""
    device: torch.device
    idxs: list                  # shard indices, fleet order
    kernel: Q15StreamStep
    offsets: np.ndarray         # (len(idxs)+1,) row offsets into the batch
    x_big: np.ndarray           # (total, d) fused x staging
    av_big: np.ndarray          # (total,) fused active-mask staging
    h_big: Any = None           # last fused output (a tensor)
    h_views: list = dataclasses.field(default_factory=list)


class FleetEngine:
    """Sharded multi-stream serving: StreamingEngine semantics at fleet
    scale.  The public surface mirrors :class:`StreamingEngine`
    (``attach / feed / step / drain / detach / trajectory / stats``) plus
    the fleet verbs (``migrate / decommission / recommission /
    shard_of``), so callers of the engine — ``classify_windows``, for
    one — run unchanged against a fleet."""

    def __init__(self, params_or_qp, config: FleetConfig | None = None,
                 *, quant: q.QuantConfig | None = None,
                 act_scales: dict[str, float] | None = None,
                 naive_acts: bool = False,
                 faults: FaultInjector | None = None,
                 obs: Observability | None = None):
        config = config or FleetConfig()
        if config.shards < 1:
            raise ValueError("shards must be >= 1")
        if config.snapshot_every is not None and config.snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1 (or None)")
        self.config = config
        self._act_scales = act_scales     # kept to rebuild a crashed shard
        self._naive_acts = naive_acts
        self._faults = faults
        # observability seam (repro_torch.obs): every shard shares the fleet's
        # tracer/registry (spans carry the shard index; fixed-bucket
        # histograms merge by construction); NULL_OBS = all hooks no-ops
        self.obs = obs or NULL_OBS
        self._tracer = self.obs.tracer
        self.qp = coerce_qp(params_or_qp, quant)
        devices = placement.shard_devices(config.shards, config.stream.device)
        self.shard_keys = [f"shard-{i}" for i in range(config.shards)]
        self.shards = [
            self._make_shard(devices[i], i)
            for i in range(config.shards)]
        self._routable = [True] * config.shards
        # device groups for fused launches: co-located shards batch into
        # one kernel launch per tick (keyed by device)
        groups = placement.device_groups(devices)
        self._group_kernels = {
            dev: Q15StreamStep(self.qp, act_scales=act_scales,
                               naive_acts=naive_acts, device=dev,
                               mxu=config.stream.mxu)
            for dev, _ in groups}
        self._devices = devices
        # device-resident fused ticks: h lives on the card between ticks
        # and the fused step is an ASYNC launch (all shards' config is
        # the template, so the residency is uniform)
        self._device_resident = self.shards[0]._device_resident
        self._owner: dict[str, int] = {}   # stream -> shard (incl. pending)
        self._spilled: "collections.OrderedDict[str, _SpillEntry]" = \
            collections.OrderedDict()      # fleet-level FIFO spillover
        self._ticks = 0
        self._global_spills = 0
        self._migrations = 0
        # --- crash failover (active when config.snapshot_every is set) --
        self._snapshots: dict[str, bytes] = {}   # stream -> last stored blob
        self._journal: dict[str, _JournalEntry] = {}   # live streams only
        self._cursor: dict[str, int] = {}  # stream -> last delivered step
        self._failovers = 0
        self._replayed_samples = 0
        self._snapshots_taken = 0
        self._snapshots_dropped = 0
        self._snapshots_duplicated = 0
        # monotonic counters of crashed shards, folded in so fleet totals
        # stay conserved across a shard rebuild (stats()["retired"])
        self._retired = {"stream_steps": 0, "completed": 0,
                         "ring_spills": 0, "replay_suppressed": 0}
        self._retired_sched = {k: 0 for k in (
            "admissions", "recycles", "spills", "completed", "cancelled",
            "evictions", "ticks")}
        self._retired_transfers = dict.fromkeys(TRANSFER_KEYS, 0)
        # numeric-health counters of crashed shards (site -> count): a
        # crash folds the dying shard's monitor child in here and resets
        # the child for the replacement engine, so live + retired stays
        # conserved (obs.invariants.check_numerics_conservation)
        self._retired_numerics: dict[str, int] = {}
        self._num_pub_tick = 0
        # --- fused-tick staging (one _DeviceGroup per device) ----------
        # One (sum S_i, ...) buffer per kernel operand per group, with
        # each shard's segment handed out as a view: phase-1 ring gathers
        # write the fused x operand in place (zero concat), and the fused
        # step's output h is adopted back as next tick's input when no
        # shard rebound its hidden state in between.
        self._group_list: list[_DeviceGroup] = []
        self._group_of: dict[int, _DeviceGroup] = {}
        for dev, idxs in groups:
            widths = [self.shards[i].config.max_slots for i in idxs]
            offs = np.concatenate([[0], np.cumsum(widths)])
            kern = self._group_kernels[dev]
            g = _DeviceGroup(device=dev, idxs=list(idxs), kernel=kern,
                             offsets=offs,
                             x_big=kern.staging_buffer(int(offs[-1])),
                             av_big=np.zeros(int(offs[-1]), bool),
                             h_views=[None] * len(idxs))
            self._group_list.append(g)
            for j, i in enumerate(idxs):
                self._group_of[i] = g
                self.shards[i]._x = g.x_big[offs[j]:offs[j + 1]]
        # groups whose launch was issued this tick: the next tick waits for
        # their x/mask h2d copies (fleet.device_wait) BEFORE phase 1
        # overwrites the pinned staging those copies read from
        self._inflight: list[_DeviceGroup] = []
        # per-tick SLO deadline (ns): the paper's real-time bar is one
        # sample period (50 Hz -> 20 ms); overridable via obs.deadline_ms
        deadline_ms = self.obs.deadline_ms
        if deadline_ms is None:
            deadline_ms = 1e3 / config.stream.sample_rate_hz
        self._deadline_ns = deadline_ms * 1e6
        self._advanced_per_shard = [0] * config.shards
        if self.obs.metrics is not None:
            self._init_fleet_metrics()

    def _init_fleet_metrics(self) -> None:
        """Pre-register the fleet's SLO metric handles (no per-tick dict
        lookups on the instrumented path)."""
        reg = self.obs.metrics
        self._m_tick = reg.histogram(
            "fleet.tick_us", "wall time of one fleet tick", wallclock=True)
        self._m_ticks = reg.counter("fleet.ticks", "fleet ticks")
        self._m_events = reg.counter(
            "fleet.events_emitted", "stream events delivered to the consumer")
        self._m_miss_ticks = reg.counter(
            "fleet.deadline_miss_ticks",
            "ticks whose wall time exceeded the per-sample deadline",
            wallclock=True)
        self._m_miss_streams = reg.counter(
            "fleet.deadline_miss_stream_ticks",
            "stream-steps advanced in ticks that missed the deadline "
            "(each is one stream observing one late 50 Hz sample)",
            wallclock=True)
        self._m_shard_miss = [
            reg.counter(f"fleet.shard{i}.deadline_miss_stream_ticks",
                        "per-shard share of deadline-missed stream-steps",
                        wallclock=True)
            for i in range(self.config.shards)]
        self._m_active = reg.gauge("fleet.active", "resident streams")
        self._m_pending = reg.gauge("fleet.pending", "shard-queued streams")
        self._m_spilled = reg.gauge(
            "fleet.spilled", "streams in the fleet spillover queue")
        self._m_occupancy = reg.gauge(
            "fleet.occupancy", "resident streams / total slots")
        self._m_failovers = reg.counter(
            "fleet.failovers", "shard crash-failovers", wallclock=True)
        self._m_migrations = reg.counter(
            "fleet.migrations", "live stream migrations")
        # host<->device transfer bytes (logical volume; deterministic):
        # the steady-state fused tick on the device-resident path must
        # add ZERO to the h_* pair — the measured zero-copy invariant
        self._m_transfers = {
            "h2d_bytes": reg.counter(
                "fleet.h2d_bytes", "host->device bytes staged"),
            "d2h_bytes": reg.counter(
                "fleet.d2h_bytes", "device->host bytes pulled"),
            "h_h2d_bytes": reg.counter(
                "fleet.h_h2d_bytes", "hidden-state bytes uploaded"),
            "h_d2h_bytes": reg.counter(
                "fleet.h_d2h_bytes", "hidden-state bytes downloaded"),
        }
        self._last_transfers = self._transfer_totals()

    def _tick_metrics(self, dur_ns: int, events: list) -> None:
        """Per-tick SLO accounting: tick-latency histogram, 50 Hz
        deadline-miss counters (fleet and per-shard, in stream-ticks),
        occupancy/queue-depth gauges."""
        self._m_ticks.inc()
        self._m_tick.observe_us(dur_ns / 1e3)
        advanced = sum(self._advanced_per_shard)
        if advanced and dur_ns > self._deadline_ns:
            self._m_miss_ticks.inc()
            self._m_miss_streams.inc(advanced)
            for i, a in enumerate(self._advanced_per_shard):
                if a:
                    self._m_shard_miss[i].inc(a)
        n_ev = sum(len(e.stream_ids) if isinstance(e, StreamEventBatch)
                   else 1 for e in events)
        self._m_events.inc(n_ev)
        self._m_active.set(self.n_active)
        self._m_pending.set(self.n_pending)
        self._m_spilled.set(len(self._spilled))
        slots = self.max_streams
        self._m_occupancy.set(self.n_active / slots if slots else 0.0)
        cur = self._transfer_totals()
        for k, c in self._m_transfers.items():
            delta = cur[k] - self._last_transfers[k]
            if delta:
                c.inc(delta)
        self._last_transfers = cur
        mon = self.obs.numerics
        if mon is not None:
            # parent publish aggregates every shard child (delta-tracked);
            # shard engines skip their own publish when fleet-owned.
            # Throttled like the standalone engine: the export walk is
            # the expensive part, and deltas survive the wait.
            self._num_pub_tick += 1
            if self._num_pub_tick >= PUBLISH_EVERY:
                self._num_pub_tick = 0
                mon.publish(self.obs.metrics)

    def _note_shard_events(self, shard: int, evs: list) -> None:
        """Feed the flight recorder one shard's tick emission as compact
        (stream_id, kind, step) triples — columnar batches contribute
        their tail, never a full O(events) expansion."""
        rec = self.obs.recorder
        cap = rec.events_per_shard
        total = 0
        summ: list[tuple] = []
        for e in evs:
            if isinstance(e, StreamEventBatch):
                n = len(e.stream_ids)
                total += n
                take = min(cap, n)
                summ.extend(zip(
                    e.stream_ids[n - take:],
                    ("final" if f else "window" for f in e.final[n - take:]),
                    e.steps[n - take:].tolist()))
            else:
                total += 1
                summ.append((e.stream_id, e.kind, e.step))
        rec.note_events(shard, self._ticks, summ[-cap:], total=total)

    def _make_shard(self, device, index: int) -> StreamingEngine:
        """Construct one shard engine wired into the fleet's shared
        observability bundle (spans/metrics tagged with the shard index)."""
        sh = StreamingEngine(
            self.qp,
            dataclasses.replace(self.config.stream, device=device),
            act_scales=self._act_scales, naive_acts=self._naive_acts,
            obs=self.obs)
        sh._obs_shard = index
        sh._sched.shard = index
        return sh

    @classmethod
    def from_artifact(cls, artifact, config: FleetConfig | None = None, *,
                      quantized_acts: bool = False,
                      naive_acts: bool = False,
                      faults: FaultInjector | None = None,
                      obs: Observability | None = None) -> "FleetEngine":
        """Build the fleet from a compression-pipeline artifact — the same
        contract as :meth:`StreamingEngine.from_artifact`."""
        return cls(artifact, config,
                   act_scales=artifact.runtime_scales(quantized_acts),
                   naive_acts=naive_acts, faults=faults, obs=obs)

    # ------------------------------------------------------------------
    # Session lifecycle (StreamingEngine-shaped)
    # ------------------------------------------------------------------
    def attach(self, stream_id: str, samples: np.ndarray | None = None, *,
               total_steps: int | None = None,
               record_trajectory: bool = False) -> str:
        """Register a stream on its rendezvous home shard.  Returns
        ``"active"`` / ``"pending"`` (shard-local placement) or
        ``"spilled"`` when every admissible shard is saturated and the
        stream joined the fleet-level spillover queue."""
        self._reclaim(stream_id)
        if stream_id in self._owner or stream_id in self._spilled:
            raise ValueError(f"stream {stream_id!r} already attached")
        coerced = (None if samples is None
                   else self._check_samples(stream_id, samples))
        if self.config.snapshot_every is not None:
            self._drop_failover_state(stream_id)   # reused finished id
            self._journal[stream_id] = _JournalEntry(
                total=total_steps, record_trajectory=record_trajectory,
                chunks=[] if coerced is None else [coerced])
        dst = self._pick_shard(stream_id)
        if dst is None:
            entry = _SpillEntry(chunks=[], total=total_steps,
                                record_trajectory=record_trajectory)
            if coerced is not None:
                entry.chunks.append(coerced)
            self._spilled[stream_id] = entry
            self._global_spills += 1
            return "spilled"
        status = self.shards[dst].attach(
            stream_id, coerced, total_steps=total_steps,
            record_trajectory=record_trajectory)
        self._owner[stream_id] = dst
        return status

    def feed(self, stream_id: str, samples: np.ndarray) -> None:
        """Append samples to a stream, wherever it lives (shard-resident,
        shard-pending, or fleet-spilled)."""
        shard = self._owner.get(stream_id)
        if shard is not None and stream_id in self.shards[shard]._sessions:
            coerced = self._check_samples(stream_id, samples)
            self._journal_feed(stream_id, coerced)
            self.shards[shard].feed(stream_id, coerced)
            return
        if stream_id in self._spilled:
            coerced = self._check_samples(stream_id, samples)
            self._journal_feed(stream_id, coerced)
            self._spilled[stream_id].chunks.append(coerced)
            return
        raise KeyError(f"stream {stream_id!r} is not attached")

    def detach(self, stream_id: str) -> StreamEvent | None:
        """Terminate a stream (partial-window final event if it consumed
        samples since its last emission, exactly like the single engine)."""
        shard = self._owner.get(stream_id)
        if shard is not None and stream_id in self.shards[shard]._sessions:
            ev = self.shards[shard].detach(stream_id)
            del self._owner[stream_id]
            self._drop_failover_state(stream_id)
            return ev
        if stream_id in self._spilled:
            del self._spilled[stream_id]
            self._drop_failover_state(stream_id)
            return None
        self._owner.pop(stream_id, None)      # already finished: stale owner
        raise KeyError(f"stream {stream_id!r} is not attached")

    def trajectory(self, stream_id: str) -> np.ndarray:
        """(steps, H) hidden trajectory of a tapped stream — served by the
        shard that currently (or last) held it; migration carries the
        recorded prefix along, so the result spans shard moves."""
        shard = self._owner.get(stream_id)
        if shard is not None:
            return self.shards[shard].trajectory(stream_id)
        raise KeyError(f"stream {stream_id!r} was not tapped")

    # ------------------------------------------------------------------
    # Ticking
    # ------------------------------------------------------------------
    def step(self) -> list[StreamEvent]:
        """One fleet tick: drain the spillover queue into shards with
        room, then advance every shard in one fused step (one kernel
        launch per device group).  Events are returned in shard order;
        per-stream ordering matches the single engine.

        With failover enabled (``snapshot_every``), the tick additionally
        checkpoints every live stream on cadence and polls the fault
        injector at each phase boundary (``faults.PHASES``): before any
        work, between the fused launch's two halves, and after events
        were handed to the consumer."""
        tr = self._tracer
        self._ticks += 1
        tr.set_tick(self._ticks)
        t_tick = tr.t()
        self._fire("pre_tick")
        se = self.config.snapshot_every
        if se is not None and self._ticks % se == 0:
            t0 = tr.t()
            self.snapshot_now()
            tr.rec("fleet.snapshot", t0)
        if self._spilled:
            t0 = tr.t()
            self._flush_spill()
            tr.rec("fleet.flush_spill", t0)
        live = self.n_active + self.n_pending
        if len(self._owner) > 2 * live + 1024:
            self._compact_owners()       # bound stale finished-id entries
        events = self._step_fused()
        t0 = tr.t()
        self._deliver(events)
        tr.rec("fleet.deliver", t0)
        self._fire("post_emit")
        dur_ns = tr.rec("fleet.tick", t_tick)
        if self.obs.metrics is not None:
            self._tick_metrics(dur_ns, events)
        return events

    def _step_fused(self) -> list[StreamEvent]:
        tr = self._tracer
        # phase 0 (device-resident only): wait for last tick's x/mask h2d
        # copies.  Everything between last tick's launch and here —
        # bookkeeping, emission, delivery, the caller's own work —
        # overlapped the device.  The wait MUST precede phase 1: the
        # asynchronous copies read the pinned staging buffers that the
        # phase-1 gather overwrites.  The kernel's output needs no wait:
        # the stream orders every later use of it.
        if self._inflight:
            t0 = tr.t()
            for g in self._inflight:
                g.kernel.wait_staged()
            self._inflight.clear()
            tr.rec("fleet.device_wait", t0)
        # phase 1: every shard runs admission + ring gather (no kernel)
        t0 = tr.t()
        begun: list[tuple] = []
        for shard in self.shards:
            resident = shard._sched.tick_begin()
            handle = (shard._advance_begin(resident)
                      if resident is not None else None)
            begun.append((resident, handle))
        tr.rec("fleet.begin", t0)
        # a shard crashed between the tick's two halves never reaches the
        # kernel: its gathered handle points at the dead engine's arrays
        for i in self._fire("mid_dispatch"):
            begun[i] = (None, None)
        # phase 2: one batched kernel launch per device group.  On the
        # device-resident path every group's launch is ISSUED before any
        # is waited on — co-located shards batch, distinct cards compute
        # concurrently.
        h_out: dict[int, Any] = {}
        t0 = tr.t()
        for g in self._group_list:
            self._dispatch_group(g, begun, h_out)
        tr.rec("fleet.dispatch", t0)
        # phase 3: per-shard bookkeeping + scheduler release accounting
        t0 = tr.t()
        events: list[StreamEvent] = []
        rec = self.obs.recorder
        for i, (resident, handle) in enumerate(begun):
            self._advanced_per_shard[i] = 0
            if resident is None:
                continue
            shard = self.shards[i]
            report = (shard._advance_finish(handle, h_out[i])
                      if handle is not None else TickReport())
            self._advanced_per_shard[i] = report.advanced
            out = shard._sched.tick_finish(report)
            if rec is not None and out:
                self._note_shard_events(i, out)
            events.extend(out)
        tr.rec("fleet.finish", t0)
        return events

    def _dispatch_group(self, g: _DeviceGroup, begun: list,
                        h_out: dict) -> None:
        """One group's fused launch.  Host path (CPU): synchronous
        ``step_rows`` over the fused operands (adopting last tick's
        output as this tick's h when every shard still holds its view;
        a shard rebinding ``_h`` — window reset, admission — falls back
        to one concatenate).  Device-resident path (card): ``step_resident``
        — an ASYNC launch that consumes the resident fused h, returns
        immediately, and whose staging copies the NEXT tick's
        ``device_wait`` waits for; per-shard h views are lazy device
        slices, so steady-state ticks move zero h bytes through the
        host."""
        idxs, off, tr = g.idxs, g.offsets, self._tracer
        live = [i for i in idxs if begun[i][1] is not None]
        if not live:
            return
        if not self._device_resident and len(live) == 1:
            # host fast path: a lone advancing shard steps its own table
            # (only the active rows are computed)
            i = live[0]
            sh, (avail, rows) = self.shards[i], begun[i][1]
            h_out[i] = g.kernel.step_rows(sh._h, sh._x, avail, rows)
            g.h_big = None
            return
        av = g.av_big
        if len(live) < len(idxs):
            av[:] = False
        for j, i in enumerate(idxs):
            if begun[i][1] is not None:
                av[off[j]:off[j + 1]] = begun[i][1][0]
        if self._device_resident:
            # adoption token: every shard's lazy view spec still points
            # at this group's last fused output (a shard that rebound
            # its h — reset, admission, migration restore — cleared it)
            adopted = (g.h_big is not None and
                       all((p := self.shards[i]._h_pending) is not None
                           and p[0] is g.h_big for i in idxs))
            t0 = tr.t()
            h_cat = (g.h_big if adopted
                     else g.kernel.concat_device(
                         [self.shards[i]._resolve_h() for i in idxs]))
            h_new = g.kernel.step_resident(h_cat, g.x_big, av)
            tr.rec("fleet.dispatch_issue", t0, idxs[0])
            self._inflight.append(g)
            g.h_big = h_new
            # per-shard views are LAZY: each shard gets a provenance spec
            # and materializes its slice only when it touches rows
            # (emission, taps, snapshots, resets).  Idle shards' rows
            # passed through the kernel masked (bit-preserved), so the
            # same spec keeps their state current with no host traffic.
            whole = h_new if len(idxs) == 1 else None
            for j, i in enumerate(idxs):
                sh = self.shards[i]
                sh._h = whole
                sh._h_pending = (h_new, off[j], off[j + 1])
                g.h_views[j] = None
                if i in live:
                    h_out[i] = None
            return
        adopted = (g.h_big is not None and
                   all(self.shards[i]._h is g.h_views[j]
                       for j, i in enumerate(idxs)))
        h_cat = (g.h_big if adopted    # steady state: no copy at all
                 else torch.cat([self.shards[i]._h for i in idxs]))
        h_new = g.kernel.step_rows(h_cat, g.x_big, av, None)
        g.h_big = h_new
        for j, i in enumerate(idxs):
            view = h_new[off[j]:off[j + 1]]
            g.h_views[j] = view
            if i in live:
                h_out[i] = view

    def drain(self) -> list[StreamEvent]:
        """Tick until no stream anywhere in the fleet can advance.  Open
        streams stay attached, exactly like the single engine."""
        events: list[StreamEvent] = []
        while self._any_buffered():
            # a failover counts as progress: the crash tick itself advances
            # no stream, but recovery re-queued work that the next ticks
            # will replay — without this a crash mid-drain looks like a
            # stall and drain returns early
            before = (self._stream_steps(), self._failovers)
            out = self.step()
            events.extend(out)
            if not out and (self._stream_steps(), self._failovers) == before:
                break    # only unplaceable/pending streams hold samples
        return events

    # ------------------------------------------------------------------
    # Fleet verbs: migration, drain, decommission
    # ------------------------------------------------------------------
    def migrate(self, stream_id: str, dst: int | None = None) -> str:
        """Move a live stream to shard ``dst`` (default: its next-best
        rendezvous shard), bit-exactly: hidden state, counters, buffered
        samples and trajectory tap travel with it.  Returns the
        destination admission status (``"active"``/``"pending"``)."""
        src = self._owner.get(stream_id)
        if src is None or stream_id not in self.shards[src]._sessions:
            raise KeyError(f"stream {stream_id!r} is not on any shard")
        if dst is None:
            order = routing.rank_shards(stream_id, self.shard_keys)
            dst = next((i for i in order
                        if i != src and self._routable[i]), None)
            if dst is None:
                raise ValueError(
                    f"stream {stream_id!r}: no routable destination shard "
                    f"other than its current shard {src}")
        else:
            if not (0 <= dst < len(self.shards)):
                raise ValueError(f"no such shard: {dst}")
            if not self._routable[dst]:
                raise ValueError(
                    f"shard {dst} is decommissioned; recommission it "
                    "before migrating streams onto it")
        if dst == src:
            raise ValueError(f"stream {stream_id!r} is already on shard {src}")
        state = self.shards[src].export_stream(stream_id)
        self._owner[stream_id] = dst
        self._migrations += 1
        if self.obs.metrics is not None:
            self._m_migrations.inc()
        # carry the delivered-step watermark: a stream migrated while
        # replaying a crash recovery must keep suppressing already-seen
        # events on its new shard
        return self.shards[dst].import_stream(
            state, suppress_steps_until=self._cursor.get(stream_id))

    def decommission(self, shard: int) -> list[str]:
        """Drain shard ``shard``: remove it from routing and migrate every
        stream it holds to that stream's next-best rendezvous shard (HRW:
        streams on other shards are untouched).  The shard keeps ticking
        (it is empty) and can be brought back with :meth:`recommission`.
        Returns the migrated stream ids."""
        if not (0 <= shard < len(self.shards)):
            raise ValueError(f"no such shard: {shard}")
        self._routable[shard] = False
        if not any(self._routable):
            self._routable[shard] = True
            raise ValueError("cannot decommission the last routable shard")
        src = self.shards[shard]
        moved = [sid for sid, o in self._owner.items()
                 if o == shard and sid in src._sessions]
        # one batched pull of every resident row to move (the card's
        # identity-keyed row cache; evictions do not rebind the table)
        src.prefetch_h([src._sessions[sid].slot for sid in moved
                        if src._sessions[sid].slot >= 0])
        for sid in moved:
            state = self.shards[shard].export_stream(sid)
            dst = routing.route(sid, self.shard_keys, self._routable)
            self._owner[sid] = dst
            self._migrations += 1
            self.shards[dst].import_stream(
                state, suppress_steps_until=self._cursor.get(sid))
        if moved and self.obs.metrics is not None:
            self._m_migrations.inc(len(moved))
        return moved

    def recommission(self, shard: int) -> None:
        """Return a drained shard to the routing set.  Existing streams
        stay where they are; new streams whose rendezvous home is this
        shard land here again."""
        if not (0 <= shard < len(self.shards)):
            raise ValueError(f"no such shard: {shard}")
        self._routable[shard] = True

    # ------------------------------------------------------------------
    # Crash failover (snapshot + journal replay; see fleet/wire.py)
    # ------------------------------------------------------------------
    def snapshot_now(self) -> int:
        """Checkpoint every live shard-held stream: wire-encode a
        non-destructive :meth:`StreamingEngine.snapshot_stream` of each
        and store the blob (through the fault injector's snapshot filter,
        which may drop/duplicate/corrupt it).  A stream's replay journal
        is trimmed only when its snapshot is actually stored.  Returns
        the number of snapshots stored."""
        if self.config.snapshot_every is None:
            raise ValueError(
                "failover is disabled; construct the fleet with "
                "FleetConfig(snapshot_every=N) to enable snapshots")
        stored = 0
        for i, shard in enumerate(self.shards):
            # device-resident shards: pull every checkpointed resident
            # slot's h in ONE batched gather instead of a device
            # round-trip per stream (snapshot_stream then reads the
            # identity-keyed cache)
            shard.prefetch_h([s.slot for s in shard._sessions.values()
                              if s.slot >= 0])
            for sid in list(shard._sessions):
                blob = wire.encode_stream_state(shard.snapshot_stream(sid))
                self._snapshots_taken += 1
                out = (self._faults.filter_snapshot(i, sid, blob)
                       if self._faults is not None else (blob,))
                if not out:
                    self._snapshots_dropped += 1
                    continue
                self._snapshots_duplicated += len(out) - 1
                self._snapshots[sid] = out[-1]   # idempotent: last write wins
                ent = self._journal.get(sid)
                if ent is not None:
                    ent.chunks.clear()
                stored += 1
        return stored

    def crash_shard(self, shard: int, *, phase: str | None = None
                    ) -> dict[str, Any]:
        """Crash-fail shard ``shard``: its engine is dropped on the floor
        (no export, no drain — everything resident dies with it) and a
        fresh engine takes its place; every stream the fleet owned there
        is reconstructed from its last stored snapshot plus journal
        replay, with the replay cursor suppressing re-emission of events
        the consumer already saw.  Every recovered stream's subsequent
        output is bit-identical to an uninterrupted run (gated in
        ``tests/test_torch_failover.py`` and ``chip_smoke.py``).

        Returns a recovery report: streams recovered, samples queued for
        replay, wire bytes decoded."""
        if self.config.snapshot_every is None:
            raise ValueError(
                "failover is disabled; construct the fleet with "
                "FleetConfig(snapshot_every=N) before crashing shards")
        if not (0 <= shard < len(self.shards)):
            raise ValueError(f"no such shard: {shard}")
        old = self.shards[shard]
        num_crash = None
        mon = self.obs.numerics
        if mon is not None:
            # the dying shard's numeric-health child: fold its counters
            # into the retired accumulator and reset it — the replacement
            # engine resolves the SAME child (same shard index) and must
            # start from zero for conservation to hold
            child = mon.shard(shard)
            num_crash = child.snapshot()
            merge_site_counts(self._retired_numerics, num_crash["sites"])
            child.reset()
        self._retire(old.stats())
        victims = [sid for sid, o in self._owner.items()
                   if o == shard and sid in self._journal]
        new = self._make_shard(old.config.device, shard)
        self.shards[shard] = new
        g = self._group_of[shard]
        j = g.idxs.index(shard)       # rewire the fused-x view segment
        new._x = g.x_big[g.offsets[j]:g.offsets[j + 1]]
        g.h_big = None                # fused-h adoption restarts from concat
        g.h_views = [None] * len(g.idxs)
        replayed = 0
        wire_bytes = 0
        d = new.kernel.input_dim
        for sid in victims:
            ent = self._journal[sid]
            blob = self._snapshots.get(sid)
            if blob is not None:
                state = wire.decode_stream_state(blob)
                wire_bytes += len(blob)
            else:   # never checkpointed: journal holds its whole history
                state = StreamState(
                    stream_id=sid,
                    h=np.zeros(new.kernel.hidden_dim, np.float32),
                    steps=0, wstep=0, total=ent.total,
                    samples=np.zeros((0, d), np.float32),
                    record_trajectory=ent.record_trajectory)
            replayed += len(state.samples)
            new.import_stream(
                state, suppress_steps_until=self._cursor.get(sid))
            for chunk in ent.chunks:
                new.feed(sid, chunk)
                replayed += len(chunk)
        self._failovers += 1
        self._replayed_samples += replayed
        report = {"shard": shard, "phase": phase,
                  "streams_recovered": len(victims),
                  "replayed_samples": replayed, "wire_bytes": wire_bytes}
        if self.obs.metrics is not None:
            self._m_failovers.inc()
        if self.obs.recorder is not None:
            # the black box: dump the tracer's pre-crash span ring plus
            # the last events each shard emitted, as a typed artifact
            counters = {"ticks": self._ticks,
                        "failovers": self._failovers,
                        "migrations": self._migrations,
                        "global_spills": self._global_spills}
            if num_crash is not None:
                # black-box numeric health at the moment of death: the
                # dead shard's own sites/drift, plus what was already
                # retired fleet-wide (deterministic snapshot — no clocks)
                counters["numerics"] = num_crash
                counters["retired_numerics"] = dict(sorted(
                    self._retired_numerics.items()))
            self.obs.recorder.record_crash(
                report, tick=self._ticks, counters=counters)
        return report

    def _fire(self, phase: str) -> list[int]:
        """Poll the fault injector at a tick phase; crash-fail whatever
        shards it names.  Returns the crashed shard indices."""
        if self._faults is None:
            return []
        crashed = []
        for s in self._faults.crashes(self, phase, self._ticks):
            self.crash_shard(int(s), phase=phase)
            crashed.append(int(s))
        return crashed

    def _deliver(self, events: list) -> None:
        """Record what the consumer has now seen: per-stream delivered-step
        watermarks (the replay cursor crash recovery suppresses up to) and
        final-event cleanup of failover state."""
        if self.config.snapshot_every is None:
            return
        for e in events:
            if isinstance(e, StreamEventBatch):
                for sid, st, fin in zip(e.stream_ids, e.steps, e.final):
                    self._note_delivery(sid, int(st), bool(fin))
            else:
                self._note_delivery(e.stream_id, e.step, e.kind == "final")

    def _note_delivery(self, sid: str, step: int, final: bool) -> None:
        if final:   # stream completed: nothing left to protect
            self._drop_failover_state(sid)
        elif step > self._cursor.get(sid, -1):
            self._cursor[sid] = step

    def _journal_feed(self, sid: str, coerced: np.ndarray) -> None:
        ent = self._journal.get(sid)
        if ent is not None and len(coerced):
            ent.chunks.append(coerced)

    def _drop_failover_state(self, sid: str) -> None:
        self._journal.pop(sid, None)
        self._snapshots.pop(sid, None)
        self._cursor.pop(sid, None)

    def _retire(self, st: dict) -> None:
        """Fold a crashed shard's monotonic counters into the retired
        accumulators so fleet totals stay conserved across the rebuild."""
        for k in self._retired:
            self._retired[k] += st[k]
        sc = st["scheduler"]
        for k in self._retired_sched:
            self._retired_sched[k] += sc[k]
        for k, v in st["transfers"].items():
            self._retired_transfers[k] += v

    def shard_of(self, stream_id: str) -> int:
        """Current shard of a stream, or -1 while fleet-spilled."""
        shard = self._owner.get(stream_id)
        if shard is not None and stream_id in self.shards[shard]._sessions:
            return shard
        if stream_id in self._spilled:
            return -1
        raise KeyError(f"stream {stream_id!r} is not attached")

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(s.n_active for s in self.shards)

    @property
    def n_pending(self) -> int:
        return sum(s.n_pending for s in self.shards)

    @property
    def n_spilled(self) -> int:
        return len(self._spilled)

    @property
    def max_streams(self) -> int:
        """Total resident capacity: shards * slots-per-shard."""
        return sum(s.config.max_slots for s in self.shards)

    #: Workload / scheduler counter keys summed across shards by
    #: :meth:`stats` in one pass (monotonic keys also fold in the
    #: retired accumulators of crashed shards).
    _WORKLOAD_KEYS = ("active", "pending", "completed", "stream_steps",
                      "ring_spills", "replay_suppressed")
    _SCHED_KEYS = ("active", "pending", "peak_active", "admissions",
                   "recycles", "spills", "completed", "cancelled",
                   "evictions", "ticks")

    def stats(self) -> dict[str, Any]:
        """Fleet-wide roll-up: every scheduler/workload counter summed
        across shards (``scheduler`` mirrors the single engine's composed
        counter block), per-shard breakdown preserved under
        ``per_shard``, fleet-level counters alongside.

        Complexity contract: **O(shards)**, never O(streams) — one
        ``shard.stats()`` call per shard and a single accumulation pass
        over the per-shard dicts (locked in by a regression test that
        poisons stream-keyed containers).  With ``obs.debug`` set, the
        roll-up is checked against the counter-conservation invariant
        (:func:`repro_torch.obs.invariants.assert_conservation`) before being
        returned."""
        per_shard = [s.stats() for s in self.shards]
        slots = self.max_streams

        tot = dict.fromkeys(self._WORKLOAD_KEYS, 0)
        sched_tot = dict.fromkeys(self._SCHED_KEYS, 0)
        for p in per_shard:                # the single O(shards) pass
            for k in self._WORKLOAD_KEYS:
                tot[k] += p[k]
            psc = p["scheduler"]
            for k in self._SCHED_KEYS:
                sched_tot[k] += psc[k]

        out = {
            "shards": len(self.shards),
            "routable": list(self._routable),
            "mxu": self.config.stream.mxu,
            "devices": [str(d) for d in self._devices],
            "device_resident": self._device_resident,
            "transfers": self._transfer_totals(),
            "max_streams": slots,
            "active": tot["active"],
            "pending": tot["pending"],
            "spilled": len(self._spilled),
            # monotonic workload counters include crashed shards' retired
            # totals, so conservation (fleet total == sum(per_shard) +
            # retired) holds under crash/recover lifecycles
            "completed": tot["completed"] + self._retired["completed"],
            "stream_steps": (tot["stream_steps"]
                             + self._retired["stream_steps"]),
            "ring_spills": tot["ring_spills"] + self._retired["ring_spills"],
            "replay_suppressed": (tot["replay_suppressed"]
                                  + self._retired["replay_suppressed"]),
            "ticks": self._ticks,
            "global_spills": self._global_spills,
            "migrations": self._migrations,
            "failover_enabled": self.config.snapshot_every is not None,
            "failovers": self._failovers,
            "replayed_samples": self._replayed_samples,
            "snapshots": {
                "taken": self._snapshots_taken,
                "dropped": self._snapshots_dropped,
                "duplicated": self._snapshots_duplicated,
                "protected_streams": len(self._snapshots),
                "journal_streams": len(self._journal),
            },
            "retired": {**self._retired,
                        "scheduler": dict(self._retired_sched)},
            **self._numerics_stats(),
            "scheduler": {
                "max_slots": slots,
                "active": sched_tot["active"],
                "pending": sched_tot["pending"],
                "occupancy": (sched_tot["active"] / slots) if slots else 0.0,
                "peak_active": sched_tot["peak_active"],
                **{k: sched_tot[k] + self._retired_sched[k]
                   for k in ("admissions", "recycles", "spills", "completed",
                             "cancelled", "evictions", "ticks")},
            },
            "per_shard": per_shard,
        }
        if self.obs.debug:
            assert_conservation(out)
        return out

    def _numerics_stats(self) -> dict[str, Any]:
        """The fleet's numeric-health stats block (empty when monitoring
        is off).  ``sites`` totals = live shard children + retired crashed
        shards, so conservation holds across crash/rebuild lifecycles
        (``obs.invariants.check_numerics_conservation``)."""
        mon = self.obs.numerics
        if mon is None:
            return {}
        snap = mon.snapshot(per_shard=True)
        totals = merge_site_counts(dict(snap["sites"]),
                                   self._retired_numerics)
        snap["sites"] = {k: totals[k] for k in sorted(totals)}
        snap["retired_sites"] = {
            k: self._retired_numerics[k]
            for k in sorted(self._retired_numerics)}
        return {"numerics": snap}

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _check_samples(self, stream_id: str, samples) -> np.ndarray:
        return coerce_samples(samples, self.shards[0].kernel.input_dim,
                              stream_id)

    def _shard_has_room(self, i: int) -> bool:
        if not self._routable[i]:
            return False
        shard, cap = self.shards[i], self.config.max_pending_per_shard
        if shard.n_active < shard.config.max_slots:
            return True
        return cap is None or shard.n_pending < cap

    def _pick_shard(self, stream_id: str) -> int | None:
        """Home shard if admissible, else the least-loaded admissible
        shard (deterministic tie-break by rendezvous rank), else None
        (fleet spillover)."""
        home = routing.route(stream_id, self.shard_keys, self._routable)
        if self._shard_has_room(home):
            return home
        order = routing.rank_shards(stream_id, self.shard_keys)
        candidates = [i for i in order if self._shard_has_room(i)]
        if not candidates:
            return None
        load = lambda i: (self.shards[i].n_active + self.shards[i].n_pending)
        return min(candidates, key=lambda i: (load(i), order.index(i)))

    def _flush_spill(self) -> None:
        """FIFO-drain the fleet spillover queue into shards with room.
        Head-of-line blocking is intentional: admission stays FIFO-fair
        fleet-wide (a later spill must not leapfrog an earlier one just
        because some shard freed a slot)."""
        while self._spilled:
            sid = next(iter(self._spilled))
            dst = self._pick_shard(sid)
            if dst is None:
                return
            entry = self._spilled.pop(sid)
            self.shards[dst].attach(
                sid, total_steps=entry.total,
                record_trajectory=entry.record_trajectory)
            for chunk in entry.chunks:
                self.shards[dst].feed(sid, chunk)
            self._owner[sid] = dst

    def _compact_owners(self) -> None:
        """Drop owner entries for streams that finished on their shard.
        A finishing stream releases shard-side only (the fleet is not in
        that loop), so without compaction an always-online fleet gains one
        dict entry per finished stream forever.  Entries whose shard still
        holds a recorded trajectory are kept so ``trajectory()`` works
        after completion, mirroring the single engine."""
        self._owner = {
            sid: shard for sid, shard in self._owner.items()
            if sid in self.shards[shard]._sessions
            or sid in self.shards[shard]._trajectories}

    def _reclaim(self, stream_id: str) -> None:
        """Drop a stale owner entry (stream finished on its shard), so the
        id becomes reusable — mirroring single-engine behaviour where a
        finished stream's id frees up."""
        shard = self._owner.get(stream_id)
        if shard is not None and stream_id not in self.shards[shard]._sessions:
            del self._owner[stream_id]

    def _stream_steps(self) -> int:
        # retired steps keep this monotonic across a crash-rebuild, which
        # drain()'s progress detection relies on
        return (sum(s._stream_steps for s in self.shards)
                + self._retired["stream_steps"])

    def _any_buffered(self) -> bool:
        if any(s._any_buffered() for s in self.shards):
            return True
        return any(e.chunks for e in self._spilled.values())

    def _transfer_totals(self) -> dict[str, int]:
        """Fleet-wide host<->device byte roll-up: every shard kernel's
        ledger (unfused / standalone paths) plus every group kernel's
        (fused dispatches).  The zero-copy regression gate reads the h
        sub-accounts' per-tick delta from here."""
        return sum_transfers(
            [s.kernel.transfers.snapshot() for s in self.shards]
            + [k.transfers.snapshot() for k in self._group_kernels.values()]
            + [self._retired_transfers])


def classify_windows_fleet(fleet: FleetEngine, windows: np.ndarray,
                           ids: Iterable[str] | None = None) -> np.ndarray:
    """Fleet twin of :func:`repro_torch.serve.streaming.classify_windows`
    — that helper also works directly on a FleetEngine (same surface);
    this alias exists so call sites read as fleet-scale on purpose."""
    return classify_windows(fleet, windows, ids)
