"""Port parity, the sharded fleet (``repro_torch.serve.fleet``) on the CPU
against the reference's exact fleet (``repro.serve.fleet``, the exact
backend): identical routes, byte-identical per-stream event logs at
1/2/4/8 shards through forced migration, spillover and decommission, the
same composed counters, and a placement that raises instead of falling
back to the CPU when the card is asked for.  Mirrors ``tests/test_fleet.py``."""
import random

import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.serve.fleet import FleetConfig as JFleetConfig
from repro.serve.fleet import FleetEngine as JFleet
from repro.serve.fleet import rank_shards as j_rank_shards
from repro.serve.fleet import hrw_weight as j_hrw_weight
from repro.serve.fleet import route as j_route
from repro.serve.streaming import StreamingConfig as JConfig
from repro_torch.core import quantization as q
from repro_torch.data import hapt
from repro_torch.serve.fleet import (FleetConfig, FleetEngine,
                                     classify_windows_fleet, hrw_weight,
                                     rank_shards, route, shard_devices)
from repro_torch.serve.fleet.placement import device_groups
from repro_torch.serve.streaming import StreamingConfig
from torchharness import fold_log, np_params


@pytest.fixture(scope="module")
def qps():
    p = np_params(0)
    return q.quantize_params(p, q.QuantConfig()), \
        jq.quantize_params(p, jq.QuantConfig())


@pytest.fixture(scope="module")
def windows():
    return hapt.generate_synthetic("test", 0, n=64).windows


def fleets(qps, shards, slots, **kw):
    """The port's CPU fleet and the reference's exact fleet, same shape."""
    batch = kw.pop("batch_events", False)
    port = FleetEngine(qps[0], FleetConfig(
        shards=shards, stream=StreamingConfig(
            max_slots=slots, device="cpu", batch_events=batch), **kw))
    ref = JFleet(qps[1], JFleetConfig(
        shards=shards, stream=JConfig(max_slots=slots, batch_events=batch),
        **kw))
    return port, ref


# ---------------------------------------------------------------------------
# Rendezvous routing
# ---------------------------------------------------------------------------

def test_routes_identical_to_reference():
    keys = [f"shard-{i}" for i in range(8)]
    sids = [f"stream-{i}" for i in range(512)] + ["sensor-7", "", "é-ü"]
    for s in sids:
        assert hrw_weight(s, "shard-3") == j_hrw_weight(s, "shard-3")
        assert route(s, keys) == j_route(s, keys)
        assert rank_shards(s, keys) == j_rank_shards(s, keys)
    rng = random.Random(0)
    for _ in range(20):
        eligible = [rng.random() < 0.6 for _ in keys]
        if not any(eligible):
            continue
        for s in sids[:64]:
            assert route(s, keys, eligible) == j_route(s, keys, eligible)
    homes = [route(s, keys) for s in sids[:512]]
    assert (np.bincount(homes, minlength=8) > 0).all()


def test_hrw_stable_under_shard_removal():
    keys = [f"shard-{i}" for i in range(8)]
    eligible = [i != 3 for i in range(8)]
    for s in (f"stream-{i}" for i in range(400)):
        before = route(s, keys)
        after = route(s, keys, eligible)
        assert after == (before if before != 3 else rank_shards(s, keys)[1])
    with pytest.raises(ValueError):
        route("s", ["a", "b"], [False, False])


# ---------------------------------------------------------------------------
# Event logs byte-identical to the reference fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_event_log_identical_to_reference_with_migration(qps, windows,
                                                         shards):
    """32 streams over ``shards`` x 16 slots; with more than one shard a
    third of them are force-migrated mid-window and one hops twice.  Columnar
    events at 4 shards, per-stream events elsewhere."""
    logs, stats = [], []
    for fleet in fleets(qps, shards, 16, batch_events=shards == 4):
        log = {}
        for i in range(32):
            fleet.attach(f"s{i}", windows[i], total_steps=128,
                         record_trajectory=i == 0)
        for _ in range(37):
            fold_log(fleet.step(), log)
        if shards > 1:
            for i in range(0, 32, 3):
                fleet.migrate(f"s{i}", (fleet.shard_of(f"s{i}") + 1) % shards)
            for _ in range(20):
                fold_log(fleet.step(), log)
            fleet.migrate("s0")
        fold_log(fleet.drain(), log)
        logs.append(log)
        stats.append(fleet.stats())
    assert len(logs[0]) == 32 and logs[0] == logs[1]
    for k in ("ticks", "stream_steps", "completed", "migrations",
              "global_spills", "scheduler"):
        assert stats[0][k] == stats[1][k], k


def test_spillover_identical_to_reference(qps, windows):
    port, ref = fleets(qps, 2, 2, max_pending_per_shard=1)
    statuses = [[f.attach(f"s{i}", windows[i], total_steps=128)
                 for i in range(12)] for f in (port, ref)]
    assert statuses[0] == statuses[1] and "spilled" in statuses[0]
    assert fold_log(port.drain()) == fold_log(ref.drain())
    assert port.stats()["global_spills"] == ref.stats()["global_spills"]
    assert port.stats()["spilled"] == 0


@pytest.mark.parametrize("batch_events", [False, True],
                         ids=["events", "columnar"])
def test_decommission_identical_to_reference(qps, windows, batch_events):
    moved, logs = [], []
    for fleet in fleets(qps, 4, 16, batch_events=batch_events):
        for i in range(32):
            fleet.attach(f"s{i}", windows[i], total_steps=128)
        log = {}
        for _ in range(11):
            fold_log(fleet.step(), log)
        moved.append(fleet.decommission(1))
        assert fleet.attach("new", windows[40], total_steps=128) in (
            "active", "pending")
        assert fleet.shard_of("new") != 1
        fold_log(fleet.drain(), log)
        fleet.recommission(1)
        assert fleet.stats()["routable"] == [True] * 4
        logs.append(log)
    assert moved[0] == moved[1] and moved[0]
    assert logs[0] == logs[1]


def test_counters_compose_like_reference_under_random_lifecycle(qps,
                                                                windows):
    """The same random admit / feed / migrate / detach / step script on both
    fleets: identical composed counters and identical event logs."""
    results = []
    for fleet in fleets(qps, 3, 4, max_pending_per_shard=1):
        rng = random.Random(1234)
        live, next_id, log = [], 0, {}
        for _ in range(160):
            op = rng.random()
            if op < 0.35:
                sid = f"r{next_id}"
                next_id += 1
                k = rng.randrange(0, 64)
                fleet.attach(sid, windows[rng.randrange(len(windows))][:k]
                             if k else None,
                             total_steps=rng.choice([None, 32, 128]))
                live.append(sid)
            elif op < 0.5 and live:
                try:
                    fold_log([fleet.detach(live.pop(rng.randrange(len(live))))],
                             log)
                except KeyError:
                    pass
            elif op < 0.6 and live:
                try:
                    fleet.migrate(rng.choice(live), rng.randrange(3))
                except (KeyError, ValueError):
                    pass
            elif op < 0.75 and live:
                fleet.feed(rng.choice(live),
                           windows[rng.randrange(len(windows))][:8])
            else:
                fold_log(fleet.step(), log)
        st = fleet.stats()
        per = [p["scheduler"] for p in st["per_shard"]]
        for key in ("admissions", "recycles", "spills", "completed",
                    "cancelled", "evictions", "ticks", "active", "pending"):
            assert st["scheduler"][key] == sum(p[key] for p in per), key
        results.append((log, st["scheduler"], st["migrations"],
                        st["global_spills"], st["stream_steps"]))
    assert results[0] == results[1]


def test_classify_windows_fleet_matches_reference(qps, windows):
    port, ref = fleets(qps, 4, 8)
    from repro.serve.fleet import classify_windows_fleet as j_classify
    np.testing.assert_array_equal(classify_windows_fleet(port, windows[:24]),
                                  j_classify(ref, windows[:24]))


def test_fleet_verbs_refuse_like_reference(qps, windows):
    port, _ = fleets(qps, 3, 4)
    port.attach("s", windows[0], total_steps=128)
    with pytest.raises(ValueError):
        port.attach("s", windows[1])
    src = port.shard_of("s")
    dead = next(i for i in range(3) if i != src)
    port.decommission(dead)
    with pytest.raises(ValueError, match="decommissioned"):
        port.migrate("s", dead)
    port.recommission(dead)
    assert port.migrate("s", dead) in ("active", "pending")
    with pytest.raises(ValueError, match="failover is disabled"):
        port.crash_shard(0)
    one, _ = fleets(qps, 1, 4)
    one.attach("s", windows[0], total_steps=128)
    with pytest.raises(ValueError, match="no routable destination"):
        one.migrate("s")
    with pytest.raises(ValueError):
        one.decommission(0)


def test_monitored_fleet_matches_reference_monitor_and_conserves(qps,
                                                                 windows):
    """The obs seams through fused ticks: per-shard numeric-health counts
    (the host recompute of each shard's rows), crash folding into the
    retired accumulator, and a debug bundle's conservation check on every
    ``stats()`` — the same snapshot as the reference's monitored fleet."""
    from repro.obs import Observability as JObservability
    from repro.obs.numerics import NumericsMonitor as JMonitor
    from repro.serve.fleet import ScheduledFaults as JScheduledFaults
    from repro_torch.obs import Observability
    from repro_torch.obs.numerics import NumericsMonitor
    from repro_torch.serve.fleet import ScheduledFaults
    limits = {"x": 2.0, "pre": 1.0, "h": 0.5, "logits": 1.0}
    obs = Observability.full(numerics=True, debug=True)
    obs.numerics = NumericsMonitor(dict(limits))
    jobs = JObservability.full(numerics=True, debug=True)
    jobs.numerics = JMonitor(dict(limits))
    port = FleetEngine(qps[0], FleetConfig(
        shards=3, snapshot_every=16,
        stream=StreamingConfig(max_slots=8, device="cpu")), obs=obs,
        faults=ScheduledFaults(schedule=[(40, "mid_dispatch", 1)]))
    ref = JFleet(qps[1], JFleetConfig(
        shards=3, snapshot_every=16, stream=JConfig(max_slots=8)), obs=jobs,
        faults=JScheduledFaults(schedule=[(40, "mid_dispatch", 1)]))
    preds = [classify_windows_fleet(f, windows[:20] * 2000.0)
             for f in (port, ref)]
    np.testing.assert_array_equal(preds[0], preds[1])
    st, jst = port.stats(), ref.stats()
    assert st["numerics"] == jst["numerics"]
    assert st["numerics"]["sites"]["act.z.idx"] > 0
    assert st["failovers"] == 1 and st["numerics"]["retired_sites"]


# ---------------------------------------------------------------------------
# Placement: the device named in config.stream.device, no fallback
# ---------------------------------------------------------------------------

def test_placement_on_the_cpu_is_one_group():
    devs = shard_devices(4, "cpu")
    assert devs == [torch.device("cpu")] * 4
    assert device_groups(devs) == [(torch.device("cpu"), [0, 1, 2, 3])]
    assert shard_devices(2, torch.device("cpu")) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        shard_devices(2, "meta")


def test_placement_raises_for_the_card_without_one(qps):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card is usable")
    for device in ("cuda", "cuda:0", "cuda:1"):
        with pytest.raises(RuntimeError, match="cuda"):
            shard_devices(4, device)
    with pytest.raises(RuntimeError, match="cuda"):
        FleetEngine(qps[0], FleetConfig(shards=2))    # device defaults to cuda
