"""Sharded fleet serving: route 100k+ concurrent Q15 sensor streams across
per-shard slot schedulers behind one FleetEngine front door, with
wire-format stream checkpoints and bit-exact crash failover.  The port of
the reference's ``repro.serve.fleet`` (see ``docs/fleet.md`` for routing,
migration, drain and failover semantics); on the card each device group's
fused tick is one launch of the step kernel."""
from .engine import FleetConfig, FleetEngine, classify_windows_fleet
from .faults import PHASES, FaultInjector, ScheduledFaults, crash_matrix
from .placement import shard_devices
from .routing import hrw_weight, rank_shards, route
from .wire import (WIRE_MAJOR, WIRE_MINOR, WireCorruptError, WireError,
                   WireTruncatedError, WireVersionError,
                   decode_stream_state, encode_stream_state)

__all__ = [
    "FleetConfig", "FleetEngine", "classify_windows_fleet",
    "shard_devices", "hrw_weight", "rank_shards", "route",
    "PHASES", "FaultInjector", "ScheduledFaults", "crash_matrix",
    "WIRE_MAJOR", "WIRE_MINOR", "WireError", "WireVersionError",
    "WireTruncatedError", "WireCorruptError",
    "encode_stream_state", "decode_stream_state",
]
