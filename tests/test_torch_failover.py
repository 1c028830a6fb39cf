"""Port parity, crash failover: the port's fleet (CPU) rebuilt from
wire-format snapshots plus journal replay gives the same per-stream event
log, byte for byte, as the reference's exact fleet under the same fault
schedule and as an uninterrupted single engine — at every tick phase x
1/2/4/8 shards.  Also the device-resident tick's seams (fused-h adoption,
the lazy ``_h_pending`` view), driven on CPU tensors.  Mirrors
``tests/test_failover.py``."""
import numpy as np
import pytest

import faultharness as jharness
from repro.core import quantization as jq
from repro.serve.fleet import ScheduledFaults as JScheduledFaults
from repro.serve.streaming import StreamingConfig as JConfig
from repro.serve.streaming import StreamingEngine as JEngine
from repro_torch.core import quantization as q
from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
from repro_torch.serve.fleet import (PHASES, FleetConfig, FleetEngine,
                                     ScheduledFaults, WireCorruptError,
                                     crash_matrix)
from repro_torch.serve.streaming import StreamingConfig
from torchharness import (assert_counters_conserved, fold_log, np_params,
                          port_crash_schedule)


@pytest.fixture(scope="module")
def qps():
    p = np_params(0)
    return q.quantize_params(p, q.QuantConfig()), \
        jq.quantize_params(p, jq.QuantConfig())


@pytest.fixture(scope="module")
def streams():
    # 24 finite streams x 300 steps: two full windows plus a partial, so a
    # crash lands mid-flight between emissions, completions and recycling
    return jharness.make_streams(24, 300, 3, seed=1)


@pytest.fixture(scope="module")
def ref_log(qps, streams):
    return jharness.reference_log(qps[1], streams)


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_crash_matrix_bit_exact_against_reference(qps, streams, ref_log,
                                                  phase, shards):
    """Shard 0 dies at tick 140 at ``phase``: the port's log equals the
    reference fleet's under the same schedule and the uninterrupted run's,
    and the port's counters conserve."""
    log, stats = port_crash_schedule(
        qps[0], streams, shards=shards, slots_per_shard=8,
        injector=ScheduledFaults(schedule=[(140, phase, 0)]))
    jlog, jstats = jharness.run_crash_schedule(
        qps[1], streams, shards=shards, slots_per_shard=8,
        injector=JScheduledFaults(schedule=[(140, phase, 0)]),
        snapshot_every=64)
    assert log == jlog
    jharness.assert_logs_identical(log, ref_log)
    assert_counters_conserved(stats)
    assert stats["failovers"] == jstats["failovers"] == 1
    for k in ("replayed_samples", "replay_suppressed", "snapshots"):
        assert stats[k] == jstats[k], k


def test_full_crash_matrix_every_shard_every_phase(qps, streams, ref_log):
    """Every shard crashed once at every phase (``crash_matrix``), columnar
    events: still the uninterrupted log, with the reference's counters."""
    log, stats = port_crash_schedule(
        qps[0], streams, shards=4, slots_per_shard=8, batch_events=True,
        injector=crash_matrix(4, start_tick=20, spacing=9))
    jharness.assert_logs_identical(log, ref_log)
    assert stats["failovers"] == 12
    assert_counters_conserved(stats)


def test_journal_only_and_duplicated_snapshots(qps, streams, ref_log):
    log, stats = port_crash_schedule(
        qps[0], streams, shards=2, slots_per_shard=8,
        injector=ScheduledFaults(schedule=[(150, "pre_tick", 0)],
                                 drop_snapshots=frozenset(streams)))
    jharness.assert_logs_identical(log, ref_log)
    assert stats["snapshots"]["protected_streams"] == 0
    assert stats["snapshots"]["dropped"] > 0
    log, stats = port_crash_schedule(
        qps[0], streams, shards=2, slots_per_shard=8,
        injector=ScheduledFaults(schedule=[(140, "pre_tick", 0)],
                                 dup_snapshots=frozenset(streams)))
    jharness.assert_logs_identical(log, ref_log)
    assert stats["snapshots"]["duplicated"] > 0


def test_corrupt_snapshot_fails_loudly(qps):
    fleet = FleetEngine(qps[0], FleetConfig(
        shards=2, stream=StreamingConfig(max_slots=8, device="cpu"),
        snapshot_every=4),
        faults=ScheduledFaults(corrupt_snapshots=frozenset(["st000"])))
    fleet.attach("st000", jharness.make_streams(1, 64, 3)["st000"])
    for _ in range(8):
        fleet.step()
    with pytest.raises(WireCorruptError):
        fleet.crash_shard(fleet.shard_of("st000"))


def test_crash_then_migrate_then_crash(qps, streams, ref_log):
    fleet = FleetEngine(qps[0], FleetConfig(
        shards=4, stream=StreamingConfig(max_slots=8, device="cpu"),
        snapshot_every=32))
    log = {}
    for sid, w in streams.items():
        fleet.attach(sid, w, total_steps=len(w))
    for _ in range(140):
        fold_log(fleet.step(), log)
    fleet.crash_shard(0, phase="manual")
    for _ in range(5):
        fold_log(fleet.step(), log)
    moved = next(sid for sid, o in fleet._owner.items()
                 if o == 0 and sid in fleet.shards[0]._sessions)
    assert fleet.migrate(moved) in ("active", "pending")
    fleet.crash_shard(fleet.shard_of(moved), phase="manual")
    fold_log(fleet.drain(), log)
    jharness.assert_logs_identical(log, ref_log)
    assert fleet.stats()["failovers"] == 2
    assert_counters_conserved(fleet.stats())


# ---------------------------------------------------------------------------
# The device-resident tick's seams, on CPU tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def resident_cpu(monkeypatch):
    """Make every CPU ``Q15StreamStep`` report device-state support, so the
    engines take the card's path (resident state table, ``step_resident``,
    lazy per-shard views, fused-h adoption) on CPU tensors; count the
    fused-h rebuilds (``concat_device``)."""
    monkeypatch.setattr(Q15StreamStep, "supports_device_state",
                        property(lambda self: True))
    calls = []
    concat = Q15StreamStep.concat_device
    monkeypatch.setattr(Q15StreamStep, "concat_device",
                        lambda self, parts: calls.append(1) or concat(self, parts))
    return calls


@pytest.mark.parametrize("shards", [2, 4])
def test_adoption_and_lazy_views_keep_the_trajectory(qps, resident_cpu,
                                                     shards):
    """Fused device-resident ticks through a migration and three crashes
    (one per phase): the event log and a migrated stream's tapped
    trajectory equal the reference single engine's, the fused output is
    adopted on most ticks (the shards' lazy views stay valid), and lazy
    views are really installed."""
    streams = jharness.make_streams(16, 60, 3, seed=3)
    fleet = FleetEngine(qps[0], FleetConfig(
        shards=shards, stream=StreamingConfig(
            max_slots=16 // shards, window=8, device="cpu"),
        snapshot_every=5),
        faults=ScheduledFaults(schedule=[(7, "mid_dispatch", 1),
                                         (13, "pre_tick", shards - 1),
                                         (20, "post_emit", 0)]))
    assert fleet._device_resident
    log = {}
    for sid, w in streams.items():
        fleet.attach(sid, w, total_steps=len(w),
                     record_trajectory=sid == "st003")
    lazy = 0
    for _ in range(25):
        fold_log(fleet.step(), log)
        lazy += sum(sh._h is None and sh._h_pending is not None
                    for sh in fleet.shards)
    fleet.migrate("st003")
    fold_log(fleet.drain(), log)
    ref = JEngine(qps[1], JConfig(max_slots=16, window=8))
    for sid, w in streams.items():
        ref.attach(sid, w, total_steps=len(w),
                   record_trajectory=sid == "st003")
    jharness.assert_logs_identical(log, jharness.collect_log(ref.drain()))
    np.testing.assert_array_equal(fleet.trajectory("st003").view(np.int32),
                                  ref.trajectory("st003").view(np.int32))
    st = fleet.stats()
    assert st["failovers"] == 3 and st["device_resident"]
    assert lazy > 0
    assert len(resident_cpu) < st["ticks"] // 2
