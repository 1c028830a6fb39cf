"""Property-based parity (hypothesis) for the port's fleet: the four tests
of ``tests/test_fleet_properties.py`` — HRW routing stability under shard
removal and addition, the wire round-trip fuzz, and randomized
crash/recover/migrate lifecycles — each drawn once and run through the
port and the reference on the same inputs.  Derandomized, so every run
draws the same examples."""
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import faultharness as jharness
from repro.core import quantization as jq
from repro.serve.fleet import ScheduledFaults as JScheduledFaults
from repro.serve.fleet import route as j_route
from repro.serve.fleet.wire import encode_stream_state as j_encode
from repro.serve.streaming import StreamState as JState
from repro_torch.core import quantization as q
from repro_torch.serve.fleet import (PHASES, FleetConfig, FleetEngine,
                                     ScheduledFaults, route)
from repro_torch.serve.fleet.wire import (decode_stream_state,
                                          encode_stream_state)
from repro_torch.serve.streaming import StreamState, StreamingConfig
from torchharness import assert_counters_conserved, fold_log, np_params

_settings = settings(max_examples=25, deadline=None, derandomize=True)
_ids = st.sets(st.text(st.characters(min_codepoint=33, max_codepoint=126),
                       min_size=1, max_size=12), min_size=1, max_size=50)


@pytest.fixture(scope="module")
def qps():
    p = np_params(0)
    return (q.quantize_params(p, q.QuantConfig()),
            jq.quantize_params(p, jq.QuantConfig()))


# ---------------------------------------------------------------------------
# HRW routing
# ---------------------------------------------------------------------------

@_settings
@given(ids=_ids, n=st.integers(2, 9), removed=st.data())
def test_hrw_removing_a_shard_remaps_only_its_streams(ids, n, removed):
    keys = [f"shard-{i}" for i in range(n)]
    gone = removed.draw(st.integers(0, n - 1), label="removed shard")
    home = {sid: route(sid, keys) for sid in ids}
    eligible = [i != gone for i in range(n)]
    for sid in ids:
        assert home[sid] == j_route(sid, keys)
        new = route(sid, keys, eligible)
        assert new == j_route(sid, keys, eligible)
        if home[sid] == gone:
            assert new != gone
        else:
            assert new == home[sid], (
                f"stream {sid!r} moved {home[sid]} -> {new} although its "
                f"home shard was not the one removed ({gone})")


@_settings
@given(ids=_ids, n=st.integers(1, 8))
def test_hrw_adding_a_shard_only_pulls_streams_to_it(ids, n):
    keys = [f"shard-{i}" for i in range(n)]
    home = {sid: route(sid, keys) for sid in ids}
    grown = keys + [f"shard-{n}"]
    for sid in ids:
        new = route(sid, grown)
        assert new == j_route(sid, grown)
        assert new == home[sid] or new == n, (
            f"stream {sid!r} moved {home[sid]} -> {new}, not to the "
            f"added shard {n}")


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@_settings
@given(seed=st.integers(0, 2**31 - 1),
       sid=st.text(max_size=24),
       k=st.integers(0, 9), t=st.integers(0, 5),
       steps=st.integers(0, 10**9), wstep=st.integers(0, 127),
       total=st.none() | st.integers(0, 10**9),
       record=st.booleans())
def test_wire_round_trip_fuzz(seed, sid, k, t, steps, wstep, total, record):
    rng = np.random.default_rng(seed)
    fields = dict(
        stream_id=sid,
        h=rng.standard_normal(16).astype(np.float32),
        steps=steps, wstep=wstep, total=total,
        samples=rng.standard_normal((k, 3)).astype(np.float32),
        record_trajectory=record,
        trajectory=[rng.standard_normal(16).astype(np.float32)
                    for _ in range(t)])
    state = StreamState(**fields)
    blob = encode_stream_state(state)
    assert blob == j_encode(JState(**fields))
    decoded = decode_stream_state(blob)
    assert encode_stream_state(decoded) == blob
    assert (decoded.stream_id, decoded.steps, decoded.wstep,
            decoded.total, decoded.record_trajectory) == \
           (sid, steps, wstep, total, record)
    np.testing.assert_array_equal(decoded.h.view(np.int32),
                                  state.h.view(np.int32))
    np.testing.assert_array_equal(decoded.samples.view(np.int32),
                                  state.samples.view(np.int32))


# ---------------------------------------------------------------------------
# randomized crash/recover/migrate lifecycles
# ---------------------------------------------------------------------------

_REF_CACHE: dict = {}   # the uninterrupted reference log (built once)


def _lifecycle(pkg, qp, streams, shards, snapshot_every, crashes, mig_at):
    """One fleet of ``pkg`` ("port" or "ref") through the schedule; the
    folded event log and the fleet's stats."""
    if pkg == "port":
        fleet = FleetEngine(qp, FleetConfig(
            shards=shards, stream=StreamingConfig(max_slots=6, device="cpu"),
            snapshot_every=snapshot_every),
            faults=ScheduledFaults(schedule=crashes))
    else:
        from repro.serve.fleet import FleetConfig as JFleetConfig
        from repro.serve.fleet import FleetEngine as JFleet
        from repro.serve.streaming import StreamingConfig as JConfig
        fleet = JFleet(qp, JFleetConfig(
            shards=shards, stream=JConfig(max_slots=6),
            snapshot_every=snapshot_every),
            faults=JScheduledFaults(schedule=crashes))
    log: dict = {}
    for sid, w in streams.items():
        fleet.attach(sid, w, total_steps=len(w))
    for tick in range(1, 340):
        for sid in mig_at.get(tick, ()):
            shard = fleet._owner.get(sid)
            if shard is not None and sid in fleet.shards[shard]._sessions:
                try:
                    fleet.migrate(sid)
                except ValueError:
                    pass   # no routable destination — legal no-op
        fold_log(fleet.step(), log)
    fold_log(fleet.drain(), log)
    return log, fleet.stats()


@_settings
@given(data=st.data())
def test_random_crash_recover_migrate_lifecycle_is_bit_exact(qps, data):
    """Any schedule of shard crashes (at any tick phase), live migrations
    and checkpoint cadences: the port's per-stream event histories are
    byte-identical to the reference fleet's under the same schedule and to
    the uninterrupted single-engine run, with counters conserved."""
    shards = data.draw(st.integers(2, 4), label="shards")
    snapshot_every = data.draw(st.sampled_from([1, 16, 48]),
                               label="snapshot_every")
    crashes = data.draw(st.lists(
        st.tuples(st.integers(1, 320), st.sampled_from(PHASES),
                  st.integers(0, shards - 1)),
        min_size=1, max_size=3), label="crashes")
    migrates = data.draw(st.lists(
        st.tuples(st.integers(1, 320), st.integers(0, 15)),
        max_size=3), label="migrates")

    streams = jharness.make_streams(16, 280, 3, seed=7)
    want = _REF_CACHE.get("log")
    if want is None:
        want = _REF_CACHE["log"] = jharness.reference_log(qps[1], streams)
    sids = sorted(streams)
    mig_at: dict = {}
    for tick, k in migrates:
        mig_at.setdefault(tick, []).append(sids[k])
    log, stats = _lifecycle("port", qps[0], streams, shards, snapshot_every,
                            crashes, mig_at)
    jlog, jstats = _lifecycle("ref", qps[1], streams, shards, snapshot_every,
                              crashes, mig_at)
    assert log == jlog
    jharness.assert_logs_identical(log, want)
    assert_counters_conserved(stats)
    assert stats["failovers"] == jstats["failovers"] == len(crashes)
