"""The span phase-name registry: one home for every tick-phase label.

Span phases used to be free-form string literals scattered across the
serving stack; a typo ("fleet.dispach") would silently intern a new
phase, splitting its latency history and breaking downstream dashboards
keyed on the documented names.  Every phase recorded through the
:class:`repro_torch.obs.trace.Tracer` API (``rec`` / ``span``) must be listed
here; the ``det-span-registry`` check in the reference package's ``repro.analysis.detlint``
statically verifies every literal at every call site, and
``tests/test_obs.py`` asserts the registry covers the serving tree.

Grouped by the subsystem that records them (see
``docs/observability.md`` for the span model):
"""
from __future__ import annotations

#: Single-engine tick phases (serve/streaming.py).
ENGINE_PHASES = (
    "engine.tick", "engine.gather", "engine.kernel", "engine.device_wait",
    "engine.emit", "engine.finish",
)

#: Fleet front-door tick phases (serve/fleet/engine.py).
FLEET_PHASES = (
    "fleet.tick", "fleet.begin", "fleet.dispatch", "fleet.dispatch_issue",
    "fleet.device_wait", "fleet.snapshot", "fleet.flush_spill",
    "fleet.deliver", "fleet.finish",
)

#: Continuous-batching LM engine phases (serve/engine.py).
LM_PHASES = ("lm.tick", "lm.prefill", "lm.decode")

#: Slot-scheduler phases (serve/scheduler.py).
SCHED_PHASES = ("sched.admit", "sched.release")

#: Deploy parity-protocol sections (deploy/verify.py timings_s surface).
VERIFY_PHASES = (
    "verify.total", "verify.qvm", "verify.engine", "verify.qruntime_subset",
    "verify.fp32", "verify.cc_build", "verify.c_float", "verify.c_int",
    "verify.numerics",
)

#: The port's own phases: the LM engine's model call and its capture of
#: the decode tick as a CUDA graph (serve/engine.py), the per-layer spans
#: it records while ``Tracer.detail`` is on (models/transformer.py), and
#: the training step's three parts (models/registry.py).
PORT_PHASES = (
    "lm.forward", "lm.graph_capture", "model.mamba", "model.ssd",
    "model.attn", "train.forward", "train.backward", "train.update",
)

#: Every registered span phase.
PHASES: frozenset[str] = frozenset(
    ENGINE_PHASES + FLEET_PHASES + LM_PHASES + SCHED_PHASES + VERIFY_PHASES
    + PORT_PHASES)


def registered(phase: str) -> bool:
    return phase in PHASES


def assert_registered(phase: str) -> None:
    """Loud form for harnesses: raise on an unregistered phase name."""
    if phase not in PHASES:
        raise ValueError(
            f"span phase {phase!r} is not in repro_torch.obs.phases.PHASES — "
            f"register it (and its docs) before recording it")
