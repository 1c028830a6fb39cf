"""Fault-injection hook points for the fleet's crash-failover machinery.

Failover that is only exercised by real crashes is untestable; the fleet
therefore exposes deterministic *injection seams* and this module defines
the injector protocol that drives them.  A :class:`FaultInjector` passed
to :class:`~repro_torch.serve.fleet.engine.FleetEngine` can

* **kill shards at chosen tick phases** — the engine calls
  :meth:`FaultInjector.crashes` at each of the :data:`PHASES` of every
  tick and crash-fails (drop + rebuild + recover, see
  ``FleetEngine.crash_shard``) whichever shards it names.  The phases
  bracket the tick's interesting interleavings: before any work
  (``pre_tick``), between the fused kernel dispatch's two halves
  (``mid_dispatch`` — admission and sample-gather have run via
  ``tick_begin``/``_advance_begin`` but no bookkeeping has), and after
  events were handed to the consumer (``post_emit``).
* **drop / duplicate / corrupt in-flight snapshots** — every wire-encoded
  :class:`~repro_torch.serve.streaming.StreamState` checkpoint passes through
  :meth:`FaultInjector.filter_snapshot` on its way to the snapshot store,
  modelling a lossy checkpoint transport.

A copy of the reference's ``repro.serve.fleet.faults``; the port's
failover tests (``tests/test_torch_failover.py``) build their schedules on
:class:`ScheduledFaults` and :func:`crash_matrix`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

#: Tick phases at which the engine polls for injected crashes, in the
#: order they occur inside :meth:`FleetEngine.step`.
PHASES = ("pre_tick", "mid_dispatch", "post_emit")


class FaultInjector:
    """Base injector: no faults.  Subclass and override the seams."""

    def crashes(self, fleet, phase: str, tick: int) -> Iterable[int]:
        """Shard indices to crash-fail at this (tick, phase).  Called once
        per phase per fleet tick; returning the same index twice is safe
        (a rebuilt shard is simply rebuilt again)."""
        return ()

    def filter_snapshot(self, shard: int, stream_id: str,
                        blob: bytes) -> tuple[bytes, ...]:
        """Transform one in-flight snapshot blob.  Return ``()`` to drop
        it (the stream keeps its previous checkpoint and a deeper replay
        journal), ``(blob,)`` to deliver it, or ``(blob, blob)`` to
        duplicate it (idempotent store: last write wins)."""
        return (blob,)


@dataclasses.dataclass
class ScheduledFaults(FaultInjector):
    """Deterministic fault schedule: crash shard ``s`` at tick ``t``
    phase ``p`` for every ``(t, p, s)`` in ``schedule``; persistently
    drop / duplicate / corrupt every snapshot of the named streams.
    Corruption flips one bit of the blob's last byte — enough for the
    wire format's crc32 to reject it at recovery time."""
    schedule: Sequence[tuple[int, str, int]] = ()
    drop_snapshots: frozenset | set = frozenset()
    dup_snapshots: frozenset | set = frozenset()
    corrupt_snapshots: frozenset | set = frozenset()

    def __post_init__(self):
        for _, phase, _ in self.schedule:
            if phase not in PHASES:
                raise ValueError(
                    f"unknown tick phase {phase!r}; expected one of {PHASES}")

    def crashes(self, fleet, phase: str, tick: int) -> Iterable[int]:
        return [s for t, p, s in self.schedule if t == tick and p == phase]

    def filter_snapshot(self, shard: int, stream_id: str,
                        blob: bytes) -> tuple[bytes, ...]:
        if stream_id in self.drop_snapshots:
            return ()
        if stream_id in self.corrupt_snapshots:
            return (blob[:-1] + bytes([blob[-1] ^ 1]),)
        if stream_id in self.dup_snapshots:
            return (blob, blob)
        return (blob,)


def crash_matrix(shards: int, *, start_tick: int = 10,
                 spacing: int = 7) -> ScheduledFaults:
    """The full phase x shard crash matrix as one deterministic schedule:
    every shard crashed once at every tick phase, spread ``spacing`` ticks
    apart so each recovery completes before the next fault lands.

    This is the canonical worst-case failover workload: identical runs
    under the same matrix must produce byte-identical event logs and
    deterministic crash dumps."""
    schedule = []
    t = start_tick
    for phase in PHASES:
        for s in range(shards):
            schedule.append((t, phase, s))
            t += spacing
    return ScheduledFaults(schedule=tuple(schedule))
