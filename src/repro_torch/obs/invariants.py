"""Reusable serving-stack invariants.

The counter-conservation law the failover tests enforce — every
monotonic fleet total equals the sum over live shards plus the retired
accumulator of crashed shards; nothing is lost or double-counted by a
crash/rebuild — used to live as an assert helper inside
``tests/faultharness.py``.  It is a *production* invariant, not a test
detail: a debug-mode fleet (``Observability(debug=True)``) checks it on
every ``FleetEngine.stats()`` call, and the test harness delegates here,
so the two cannot drift.
"""
from __future__ import annotations

#: Workload counters conserved across shard crash/rebuild.
CONSERVED_WORKLOAD = ("completed", "stream_steps", "ring_spills",
                      "replay_suppressed")
#: Scheduler counters conserved across shard crash/rebuild.
CONSERVED_SCHED = ("admissions", "recycles", "spills", "completed",
                   "cancelled", "evictions", "ticks")
#: Gauges that must stay live-only (never folded into retired).
LIVE_GAUGES = ("active", "pending")


def check_conservation(stats: dict) -> list[str]:
    """Check the counter-conservation invariant over one
    ``FleetEngine.stats()`` dict.  Returns a list of violation
    descriptions; empty = conserved."""
    errors: list[str] = []
    per = stats["per_shard"]
    retired = stats["retired"]
    for key in CONSERVED_WORKLOAD:
        live = sum(p[key] for p in per)
        if stats[key] != live + retired[key]:
            errors.append(f"{key}: fleet total {stats[key]} != live {live} "
                          f"+ retired {retired[key]}")
    rsched = retired["scheduler"]
    for key in CONSERVED_SCHED:
        live = sum(p["scheduler"][key] for p in per)
        if stats["scheduler"][key] != live + rsched[key]:
            errors.append(f"scheduler.{key}: fleet total "
                          f"{stats['scheduler'][key]} != live {live} "
                          f"+ retired {rsched[key]}")
    for key in LIVE_GAUGES:
        live = sum(p[key] for p in per)
        if stats[key] != live:
            errors.append(f"{key}: gauge {stats[key]} != live sum {live} "
                          f"(gauges must not include retired shards)")
    errors += check_numerics_conservation(stats)
    return errors


def check_numerics_conservation(stats: dict) -> list[str]:
    """Numeric-health counter conservation: every per-site saturation
    total in ``stats()["numerics"]["sites"]`` equals the sum over the
    live shards' monitor children plus ``retired_sites`` (counts folded
    in by ``crash_shard`` before it reset the dead shard's child).
    No-op (empty list) when the fleet runs unmonitored."""
    errors: list[str] = []
    num = stats.get("numerics")
    if num is None:
        return errors
    retired = num.get("retired_sites", {})
    live: dict[str, int] = {}
    for p in stats["per_shard"]:
        psnap = p.get("numerics")
        if not psnap:
            continue
        for k in sorted(psnap["sites"]):
            live[k] = live.get(k, 0) + psnap["sites"][k]
    for k in sorted(set(num["sites"]) | set(live) | set(retired)):
        total = num["sites"].get(k, 0)
        if total != live.get(k, 0) + retired.get(k, 0):
            errors.append(
                f"numerics.{k}: fleet total {total} != live "
                f"{live.get(k, 0)} + retired {retired.get(k, 0)}")
    return errors


def assert_conservation(stats: dict) -> None:
    """Raise ``AssertionError`` with every violation if the conservation
    invariant does not hold (the test-harness / debug-mode entry point)."""
    errors = check_conservation(stats)
    assert not errors, "counter conservation violated:\n  " + \
        "\n  ".join(errors)
