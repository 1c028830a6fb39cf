"""Engine-agnostic slot scheduler: the continuous-batching core behind
the serving workloads, ported from the reference ``repro.serve.scheduler``
(numpy only, no device code).

N stateful sessions are multiplexed over S resident compute slots: a slot
table, a pending queue, FIFO admission, slot recycling, per-slot counters
and event plumbing.

Division of labour
------------------
:class:`SlotScheduler` owns *placement*: which request occupies which slot,
who is waiting, when a freed slot is recycled, and the telemetry counters
(admissions / recycles / spills / occupancy) the sharded-streaming work
needs.  It never touches workload state.

A workload implements the :class:`SlotProgram` protocol and owns *compute*:
per-slot model state (hidden vectors, KV caches, sample rings, output
buffers) laid out as arrays indexed by slot.  The contract is small:

* ``admit(slot, request_id, payload, reset)`` — place a request into a
  slot.  ``reset=True`` means the slot was previously owned (recycled) and
  the program must clear any residual state before use.
* ``step(resident)`` — advance every resident slot by one unit of work and
  return a :class:`TickReport` (events to surface, slots that finished,
  how many slots actually advanced).
* ``release(slot, request_id, reason)`` — the slot is being vacated
  (``reason`` is ``"finished"`` or ``"cancelled"``); clean per-slot state
  and optionally return a final event (e.g. a partial-window prediction on
  detach).

Consumers: ``serve/streaming.py`` (Q15 sensor streams; one work unit =
one 50 Hz sample through the batched FastGRNN step kernel).  The
reference's LM engine and fleet front door ride the same scheduler; the
fleet drives the tick's two halves separately (``tick_begin`` /
``tick_finish``) and uses ``evict`` for live stream migration.

Admission policy
----------------
``admit_policy="any_free"`` (default) is true continuous batching: the
FIFO head is admitted the moment any slot frees.  ``"all_free"`` only
admits when *no* slot is resident — the window-boundary baseline the old
LM engine implemented, kept as a measurable reference point.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Protocol, Sequence

import numpy as np

from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class TickReport:
    """What a :class:`SlotProgram` did in one ``step`` call."""
    events: list = dataclasses.field(default_factory=list)
    finished: Sequence[int] = ()   # slots whose request completed this tick
    advanced: int = 0              # work units performed (telemetry)


class SlotProgram(Protocol):
    """Workload half of the scheduler/program split (see module docstring)."""

    def admit(self, slot: int, request_id: str, payload: Any,
              reset: bool) -> None: ...

    def step(self, resident: np.ndarray) -> TickReport: ...

    def release(self, slot: int, request_id: str, reason: str): ...


class HostProgram:
    """SlotProgram adapter binding the protocol hooks to privately-named
    methods on a host engine (``_admit_slot`` / ``_advance`` /
    ``_release_slot``), so an engine with its own public ``step()`` API
    can implement the protocol without a name collision.  Shared by both
    serving engines."""

    def __init__(self, host):
        self._host = host

    def admit(self, slot, request_id, payload, reset):
        self._host._admit_slot(slot, request_id, payload, reset)

    def step(self, resident) -> TickReport:
        return self._host._advance(resident)

    def release(self, slot, request_id, reason):
        return self._host._release_slot(slot, request_id, reason)


class SlotScheduler:
    """Slot table + pending queue + admission/recycling for a SlotProgram."""

    ADMIT_POLICIES = ("any_free", "all_free")

    def __init__(self, max_slots: int, program: SlotProgram, *,
                 admit_policy: str = "any_free", tracer=None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if admit_policy not in self.ADMIT_POLICIES:
            raise ValueError(f"admit_policy must be one of {self.ADMIT_POLICIES}")
        self.max_slots = max_slots
        self.program = program
        self.admit_policy = admit_policy
        # tick-phase tracing seam (repro_torch.obs): admission work is spanned
        # as "sched.admit" only when something is actually admissible, so
        # the idle-queue fast path never takes a timestamp
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.shard = -1     # fleet shard index tag for spans (set by owner)
        self.resident = np.zeros(max_slots, bool)
        self._slot_request: list[str | None] = [None] * max_slots
        self._free: list[int] = list(range(max_slots - 1, -1, -1))
        self._dirty = np.zeros(max_slots, bool)   # freed slots hold stale state
        self._pending: collections.deque[str] = collections.deque()
        self._payloads: dict[str, Any] = {}       # request -> payload (pending)
        self._slot_of: dict[str, int] = {}        # request -> slot (resident)
        # --- counters (the observability hook for sharded streaming) ----
        self._admissions = 0      # total placements into a slot
        self._recycles = 0        # placements that reused a previously-owned slot
        self._spills = 0          # submissions that had to wait in the queue
        self._completed = 0       # finished releases
        self._cancelled = 0       # cancelled releases (resident or pending)
        self._evictions = 0       # migration releases (live stream moved away)
        self._ticks = 0           # productive ticks (advanced > 0)
        self._peak_active = 0

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(self, request_id: str, payload: Any = None) -> str:
        """Queue a request.  Returns ``"active"`` if it was placed into a
        slot immediately, ``"pending"`` if it joined the FIFO queue.
        Under ``admit_policy="all_free"`` admission happens only at tick
        start, so a wave fills all at once instead of the first request
        racing into an empty slot table alone."""
        if request_id in self._slot_of or request_id in self._payloads:
            raise ValueError(f"request {request_id!r} already submitted")
        self._payloads[request_id] = payload
        self._pending.append(request_id)
        if self.admit_policy == "any_free":
            self._try_admit()
        if request_id in self._slot_of:
            return "active"
        self._spills += 1
        return "pending"

    def cancel(self, request_id: str):
        """Withdraw a request.  Resident: the program's ``release`` hook runs
        with reason ``"cancelled"`` and its return value (e.g. a final
        partial event) is passed through.  Pending: silently dequeued."""
        if request_id in self._slot_of:
            ev = self._release(self._slot_of[request_id], reason="cancelled")
            self._cancelled += 1
            return ev
        if request_id in self._payloads:
            self._pending.remove(request_id)
            del self._payloads[request_id]
            self._cancelled += 1
            return None
        raise KeyError(f"request {request_id!r} is not scheduled")

    def evict(self, request_id: str) -> None:
        """Withdraw a request for live migration.  Unlike :meth:`cancel`,
        the release hook runs with reason ``"migrated"`` — no completion
        semantics, no final event — and the departure is counted in
        ``evictions``, not ``cancelled``.  The caller (the fleet front
        door) is responsible for having snapshotted the per-slot state it
        wants to carry to the destination shard *before* evicting."""
        if request_id in self._slot_of:
            self._release(self._slot_of[request_id], reason="migrated")
            self._evictions += 1
            return
        if request_id in self._payloads:
            self._pending.remove(request_id)
            del self._payloads[request_id]
            self._evictions += 1
            return
        raise KeyError(f"request {request_id!r} is not scheduled")

    # ------------------------------------------------------------------
    # Ticking
    # ------------------------------------------------------------------
    def tick(self) -> list:
        """One scheduling round: admit from the pending queue into free
        slots, step the program over the resident set, release finished
        slots (recycled next tick).  Returns the program's events."""
        resident = self.tick_begin()
        if resident is None:
            return []
        return self.tick_finish(self.program.step(resident))

    def tick_begin(self) -> np.ndarray | None:
        """First half of :meth:`tick`: run admission and return a copy of
        the resident mask the program should step, or ``None`` when no slot
        is resident.  Split out so a fleet front door can run admission on
        every shard, batch all shards' program steps into one fused kernel
        dispatch, and only then complete each shard with
        :meth:`tick_finish` — without this scheduler knowing about shards."""
        self._try_admit()
        if not self._slot_of:        # O(1): no resident request anywhere
            return None
        return self.resident.copy()

    def tick_finish(self, report: TickReport) -> list:
        """Second half of :meth:`tick`: account the program's
        :class:`TickReport` (productive-tick counter, finished-slot
        releases) and return its events."""
        if report.advanced:
            self._ticks += 1
        if len(report.finished):
            t0 = self.tracer.t()
            for slot in report.finished:
                self._release(int(slot), reason="finished")
                self._completed += 1
            self.tracer.rec("sched.release", t0, self.shard)
        return report.events

    def has_work(self) -> bool:
        return bool(self.resident.any()) or bool(self._pending)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return self.max_slots - len(self._free)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def slot_of(self, request_id: str) -> int:
        """Resident slot of a request, or -1 while pending."""
        return self._slot_of.get(request_id, -1)

    def request_at(self, slot: int) -> str | None:
        return self._slot_request[slot]

    def stats(self) -> dict[str, Any]:
        return {
            "max_slots": self.max_slots,
            "active": self.n_active,
            "pending": self.n_pending,
            "occupancy": self.n_active / self.max_slots,
            "peak_active": self._peak_active,
            "admissions": self._admissions,
            "recycles": self._recycles,
            "spills": self._spills,
            "completed": self._completed,
            "cancelled": self._cancelled,
            "evictions": self._evictions,
            "ticks": self._ticks,
            "admit_policy": self.admit_policy,
        }

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _try_admit(self) -> None:
        if not (self._free and self._pending):
            return
        if self.admit_policy == "all_free" and self.resident.any():
            return
        t0 = self.tracer.t()
        while self._free and self._pending:
            rid = self._pending.popleft()
            self._place(rid, self._free.pop())
        self.tracer.rec("sched.admit", t0, self.shard)

    def _place(self, request_id: str, slot: int) -> None:
        payload = self._payloads.pop(request_id)
        reset = bool(self._dirty[slot])
        self._slot_request[slot] = request_id
        self._slot_of[request_id] = slot
        self.resident[slot] = True
        self._admissions += 1
        if reset:
            self._recycles += 1
        self._peak_active = max(self._peak_active, self.n_active)
        self.program.admit(slot, request_id, payload, reset)
        self._dirty[slot] = False

    def _release(self, slot: int, *, reason: str):
        request_id = self._slot_request[slot]
        ev = self.program.release(slot, request_id, reason)
        self._slot_request[slot] = None
        del self._slot_of[request_id]
        self.resident[slot] = False
        self._dirty[slot] = True
        self._free.append(slot)
        return ev
