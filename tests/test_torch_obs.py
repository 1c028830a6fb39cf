"""Port parity, observability: ``repro_torch.obs`` (ported with the serving
path) against the contracts of ``tests/test_obs.py``, one for one, and
against the reference ``repro.obs`` on the same inputs wherever the
reference's output is deterministic (tracer flight records, histogram
counts, registry snapshots, Prometheus text, crash-matrix flight dumps).

* **NullTracer is free** — no allocation per hot-path call.
* **Histogram bucket edges** — exact at edges (``side="left"``).
* **Deterministic snapshots** — byte-identical across identical runs,
  under the full phase x shard ``crash_matrix`` too.
* **Conservation invariant** — the shared implementation powers the
  harness assertion and trips in debug-mode ``FleetEngine.stats()``.
* **O(shards) stats** — ``FleetEngine.stats()`` never walks per-stream
  containers.

Engines run on the CPU (``device="cpu"``).
"""
import json
import tracemalloc

import numpy as np
import pytest
import torch

import faultharness as jharness
import repro.obs as J
from repro.core import quantization as jq
from repro.serve.fleet import crash_matrix as j_crash_matrix
from repro_torch.core import quantization as q
from repro_torch.obs import (BUCKET_EDGES_US, NULL_OBS, NULL_TRACER,
                             FlightRecorder, Histogram, MetricsRegistry,
                             Observability, Tracer, check_conservation,
                             merge_histogram_counts, validate_snapshot)
from repro_torch.serve.fleet import FleetConfig, FleetEngine, crash_matrix
from repro_torch.serve.streaming import StreamingConfig, StreamingEngine
from torchharness import fold_log, np_params, port_crash_schedule

make_streams = jharness.make_streams


@pytest.fixture(scope="module")
def qp():
    return q.quantize_params(np_params(0), q.QuantConfig())


@pytest.fixture(scope="module")
def jqp():
    return jq.quantize_params(np_params(0), jq.QuantConfig())


@pytest.fixture(scope="module")
def input_dim(qp):
    return StreamingEngine(qp, StreamingConfig(
        max_slots=1, device="cpu")).kernel.input_dim


def cfg(**kw):
    return StreamingConfig(device="cpu", **kw)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

def test_tracer_records_spans_and_phase_stats():
    trs = []
    for mod in (None, J):
        tr = (mod.Tracer if mod else Tracer)(capacity=16)
        tr.set_tick(3)
        for _ in range(5):
            t0 = tr.t()
            tr.rec("phase.a", t0, shard=1)
        t0 = tr.t()
        tr.rec("phase.b", t0)
        trs.append(tr)
    tr = trs[0]
    st = tr.phase_stats()
    assert set(st) == {"phase.a", "phase.b"}
    assert st["phase.a"]["count"] == 5
    assert st["phase.b"]["count"] == 1
    for s in st.values():
        assert s["p50_us"] >= 0 and s["p99_us"] >= s["p50_us"] >= 0
    fl = tr.flight()
    assert len(fl) == 6
    assert fl[0]["phase"] == "phase.a" and fl[0]["shard"] == 1
    assert all(rec["tick"] == 3 for rec in fl)
    assert [rec["seq"] for rec in fl] == list(range(6))
    assert tr.flight(deterministic=True) == \
        trs[1].flight(deterministic=True)


def test_tracer_ring_wraps_without_growth():
    tr = Tracer(capacity=8)
    for i in range(50):
        tr.rec("p", tr.t())
    assert len(tr.flight()) == 8
    assert [r["seq"] for r in tr.flight()] == list(range(42, 50))
    assert tr.phase_stats()["p"]["count"] == 50


def test_tracer_deterministic_flight_strips_wallclock():
    tr = Tracer(capacity=8)
    tr.rec("p", tr.t(), shard=2)
    det = tr.flight(deterministic=True)[0]
    assert set(det) == {"seq", "tick", "phase", "shard"}
    full = tr.flight()[0]
    assert "t0_us" in full and "dur_us" in full


def test_tracer_span_context_manager():
    tr = Tracer()
    with tr.span("ctx.phase", shard=4) as sp:
        pass
    assert sp.dur_ns > 0
    assert tr.flight()[-1]["phase"] == "ctx.phase"
    assert tr.flight()[-1]["shard"] == 4
    assert tr.totals_s()["ctx.phase"] > 0


def test_null_tracer_is_allocation_free():
    """The disabled path must not allocate per call."""
    tr = NULL_TRACER
    for _ in range(10):
        tr.rec("x", tr.t(), 0)
        tr.set_tick(1)
        with tr.span("x"):
            pass

    def burst(n):
        for _ in range(n):
            t0 = tr.t()
            tr.rec("engine.tick", t0, 3)
            tr.set_tick(7)

    def leaked_by(n):
        before, _ = tracemalloc.get_traced_memory()
        burst(n)
        after, _ = tracemalloc.get_traced_memory()
        return after - before

    tracemalloc.start()
    try:
        burst(100)
        small, big = leaked_by(1000), leaked_by(10000)
    finally:
        tracemalloc.stop()
    assert big <= small + 64, (
        f"NullTracer allocates per call: {small}B/1k vs {big}B/10k calls")


# ---------------------------------------------------------------------------
# Metrics: histogram edges, registry, snapshots, exporters
# ---------------------------------------------------------------------------

def test_histogram_bucket_edges_exact():
    np.testing.assert_array_equal(BUCKET_EDGES_US, J.BUCKET_EDGES_US)
    h = Histogram("t")
    for k, edge in enumerate(BUCKET_EDGES_US):
        h2 = Histogram("e")
        h2.observe_us(edge)
        assert h2.counts[k] == 1, f"edge {edge} fell in bucket {np.argmax(h2.counts)}"
    h.observe_us(BUCKET_EDGES_US[0] + 0.5)
    assert h.counts[1] == 1
    h.observe_us(BUCKET_EDGES_US[-1] * 10)
    assert h.counts[-1] == 1
    h.observe_us(0.0)
    assert h.counts[0] == 1


def test_histogram_vectorized_matches_scalar():
    rng = np.random.default_rng(0)
    vals = rng.uniform(0, 4e6, 500)
    a, b, c = Histogram("a"), Histogram("b"), J.Histogram("c")
    for v in vals:
        a.observe_us(float(v))
    b.observe_many_us(vals)
    c.observe_many_us(vals)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(b.counts, c.counts)
    assert a.count == b.count == 500
    assert abs(a.sum_us - b.sum_us) < 1e-6 * a.sum_us
    assert b.sum_us == c.sum_us


def test_histogram_quantiles_bucket_resolution():
    h = Histogram("q")
    h.observe_many_us(np.full(99, 3.0))
    h.observe_us(5e6)
    assert h.quantile_us(0.5) == 4.0
    assert h.quantile_us(0.99) == 4.0
    assert h.quantile_us(1.0) == float(BUCKET_EDGES_US[-1] * 2)


def test_registry_get_or_create_and_kind_clash():
    reg = MetricsRegistry()
    c = reg.counter("a.count")
    assert reg.counter("a.count") is c
    with pytest.raises(TypeError):
        reg.gauge("a.count")
    c.inc()
    c.inc(5)
    reg.gauge("a.g").set(2.5)
    reg.histogram("a.h").observe_us(100)
    assert "a.count" in reg and reg.names() == ["a.count", "a.g", "a.h"]


def test_snapshot_schema_validates_and_roundtrips():
    regs = []
    for mod in (None, J):
        reg = (mod.MetricsRegistry if mod else MetricsRegistry)()
        reg.counter("c").inc(3)
        reg.gauge("g").set(1.25)
        reg.histogram("h").observe_many_us(np.array([1.0, 100.0, 1e7]))
        regs.append(reg)
    snap = regs[0].snapshot()
    assert validate_snapshot(snap) == []
    assert validate_snapshot(json.loads(json.dumps(snap))) == []
    assert snap["counters"]["c"] == 3
    assert snap["histograms"]["h"]["count"] == 3
    bad = json.loads(json.dumps(snap))
    bad["histograms"]["h"]["counts"][0] += 1
    assert any("counts sum" in e for e in validate_snapshot(bad))
    assert any("missing top-level" in e
               for e in validate_snapshot({"benchmark": "metrics_snapshot"}))
    assert regs[0].dumps(deterministic=True) == \
        regs[1].dumps(deterministic=True)


def test_deterministic_snapshot_bytes_stable_across_runs():
    def run(mod=None):
        reg = (mod.MetricsRegistry if mod else MetricsRegistry)()
        reg.counter("steps").inc(128)
        reg.histogram("warm", wallclock=False).observe_many_us(
            np.arange(1, 65, dtype=np.float64))
        reg.histogram("tick_us", wallclock=True).observe_us(
            float(np.random.default_rng().uniform(1, 1e5)))
        reg.counter("missed", wallclock=True).inc(
            int(np.random.default_rng().integers(1, 100)))
        return reg.dumps(deterministic=True)
    a, b = run(), run()
    assert a == b == run(J)
    snap = json.loads(a)
    assert "tick_us" not in snap["histograms"]
    assert "missed" not in snap["counters"]
    assert "warm" in snap["histograms"]


def test_prometheus_exposition_format():
    texts = []
    for mod in (None, J):
        reg = (mod.MetricsRegistry if mod else MetricsRegistry)()
        reg.counter("fleet.ticks", "total ticks").inc(7)
        reg.gauge("fleet.occupancy").set(0.5)
        h = reg.histogram("fleet.tick_us")
        h.observe_us(3.0)
        h.observe_us(1e9)
        texts.append(reg.prometheus())
    text = texts[0]
    assert text == texts[1]
    assert "# TYPE fleet_ticks counter\nfleet_ticks 7" in text
    assert "fleet_occupancy 0.5" in text
    assert 'fleet_tick_us_bucket{le="4"} 1' in text
    assert 'fleet_tick_us_bucket{le="+Inf"} 2' in text
    assert "fleet_tick_us_count 2" in text
    cums = [int(l.rsplit(" ", 1)[1]) for l in text.splitlines()
            if l.startswith("fleet_tick_us_bucket")]
    assert cums == sorted(cums)


def test_prometheus_exposition_conformance():
    """Names match ``[a-zA-Z_:][a-zA-Z0-9_:]*``, HELP escapes backslash
    and newline, families come in sorted source-name order; the text is
    the reference's byte for byte."""
    import re
    from repro.obs.metrics import _prom_name as j_prom_name
    from repro_torch.obs.metrics import _prom_name

    def fill(reg):
        reg.counter("50hz.deadline-miss", "misses @ 50Hz").inc(1)
        reg.gauge("numerics.drift.h", 'help with \\ backslash\nand newline')
        reg.counter("fleet.shard0.ticks", "plain").inc(2)
        reg.gauge("weird~name!", "").set(1.0)
        return reg.prometheus()

    text = fill(MetricsRegistry())
    name_re = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            name = line.split(" ", 3)[2]
        else:
            name = line.split("{", 1)[0].split(" ", 1)[0]
        assert name_re.match(name), f"bad metric name {name!r} in {line!r}"
    assert "_50hz_deadline_miss 1" in text
    help_line = next(l for l in text.splitlines()
                     if l.startswith("# HELP numerics_drift_h"))
    assert help_line == \
        "# HELP numerics_drift_h help with \\\\ backslash\\nand newline"
    names = ("50hz.deadline-miss", "numerics.drift.h", "fleet.shard0.ticks",
             "weird~name!")
    fams = [l.split(" ", 3)[2] for l in text.splitlines()
            if l.startswith("# TYPE ")]
    assert fams == [_prom_name(n) for n in sorted(names)]
    assert [_prom_name(n) for n in names] == [j_prom_name(n) for n in names]
    assert fill(MetricsRegistry()) == text == fill(J.MetricsRegistry())


def test_merge_histogram_counts():
    a, b = Histogram("a"), Histogram("b")
    a.observe_many_us(np.array([1.0, 5.0]))
    b.observe_many_us(np.array([5.0, 1e9]))
    merged = merge_histogram_counts([a.counts, b.counts])
    assert sum(merged) == 4
    assert list(merged) == list(J.merge_histogram_counts([a.counts,
                                                          b.counts]))
    with pytest.raises(ValueError):
        merge_histogram_counts([[1, 2, 3]])


# ---------------------------------------------------------------------------
# Conservation invariant (shared test/production implementation)
# ---------------------------------------------------------------------------

def _toy_stats():
    shard = {"active": 1, "pending": 0, "completed": 2, "stream_steps": 10,
             "ring_spills": 0, "replay_suppressed": 0,
             "scheduler": {"admissions": 3, "recycles": 1, "spills": 0,
                           "completed": 2, "cancelled": 0, "evictions": 0,
                           "ticks": 5}}
    retired = {"completed": 1, "stream_steps": 4, "ring_spills": 0,
               "replay_suppressed": 0,
               "scheduler": {"admissions": 1, "recycles": 0, "spills": 0,
                             "completed": 1, "cancelled": 0, "evictions": 0,
                             "ticks": 2}}
    return {"active": 1, "pending": 0, "completed": 3, "stream_steps": 14,
            "ring_spills": 0, "replay_suppressed": 0,
            "scheduler": {"admissions": 4, "recycles": 1, "spills": 0,
                          "completed": 3, "cancelled": 0, "evictions": 0,
                          "ticks": 7},
            "per_shard": [shard], "retired": retired}


def test_check_conservation_passes_and_catches_drift():
    assert check_conservation(_toy_stats()) == []
    broken = _toy_stats()
    broken["completed"] += 1
    errs = check_conservation(broken)
    assert len(errs) == 1 and "completed" in errs[0]
    assert errs == J.check_conservation(broken)
    broken2 = _toy_stats()
    broken2["scheduler"]["ticks"] -= 1
    assert any("scheduler.ticks" in e for e in check_conservation(broken2))
    broken3 = _toy_stats()
    broken3["active"] += 1
    assert any("gauge" in e for e in check_conservation(broken3))


def test_debug_mode_stats_asserts_conservation(qp, input_dim, monkeypatch):
    """``debug=True`` routes every ``stats()`` roll-up through the shared
    conservation checker; ``debug=False`` never pays for it."""
    import repro_torch.serve.fleet.engine as fleet_mod
    checked = []
    monkeypatch.setattr(
        fleet_mod, "assert_conservation",
        lambda stats: checked.append(stats["completed"]))
    streams = make_streams(4, 40, input_dim)

    def run(debug):
        fleet = FleetEngine(qp, FleetConfig(
            shards=2, stream=cfg(max_slots=4)),
            obs=Observability(debug=debug))
        for sid, w in streams.items():
            fleet.attach(sid, w, total_steps=len(w))
        fleet.drain()
        return fleet.stats()

    st = run(debug=True)
    assert checked == [st["completed"] == 4 and 4]
    run(debug=False)
    assert len(checked) == 1
    assert check_conservation(st) == []


# ---------------------------------------------------------------------------
# Engine integration: spans, metrics, deadline + warm-up accounting
# ---------------------------------------------------------------------------

def test_fleet_traced_run_bit_identical_to_untraced(qp, input_dim):
    streams = make_streams(12, 150, input_dim, seed=3)

    def run(obs):
        fleet = FleetEngine(qp, FleetConfig(
            shards=2, stream=cfg(max_slots=8)), obs=obs)
        for sid, w in streams.items():
            fleet.attach(sid, w, total_steps=len(w))
        return fold_log(fleet.drain())

    assert run(NULL_OBS) == run(Observability.full(debug=True))


def test_fleet_tick_phases_traced(qp, input_dim):
    obs = Observability.full()
    fleet = FleetEngine(qp, FleetConfig(
        shards=2, stream=cfg(max_slots=8)), obs=obs)
    for sid, w in make_streams(8, 140, input_dim).items():
        fleet.attach(sid, w, total_steps=len(w))
    fleet.drain()
    st = obs.tracer.phase_stats()
    for phase in ("fleet.tick", "fleet.begin", "fleet.dispatch",
                  "fleet.finish", "fleet.deliver", "engine.gather",
                  "engine.emit", "engine.finish", "sched.admit",
                  "sched.release"):
        assert phase in st, f"missing phase {phase}: have {sorted(st)}"
    assert st["fleet.tick"]["total_us"] >= st["fleet.dispatch"]["total_us"]
    shards = {r["shard"] for r in obs.tracer.flight()
              if r["phase"] == "engine.gather"}
    assert shards <= {0, 1} and shards


def test_single_engine_kernel_span_and_tick(qp, input_dim):
    obs = Observability.full()
    eng = StreamingEngine(qp, cfg(max_slots=4), obs=obs)
    for sid, w in make_streams(4, 140, input_dim).items():
        eng.attach(sid, w, total_steps=len(w))
    eng.drain()
    st = obs.tracer.phase_stats()
    for phase in ("engine.tick", "engine.kernel", "engine.gather",
                  "engine.finish", "sched.admit"):
        assert phase in st, f"missing phase {phase}: have {sorted(st)}"
    assert "engine.tick_us" in obs.metrics.snapshot()["histograms"]


def test_fleet_metrics_counters_and_warmup(qp, input_dim):
    obs = Observability.full()
    fleet = FleetEngine(qp, FleetConfig(
        shards=2, stream=cfg(max_slots=8, warmup_samples=64)), obs=obs)
    n, steps = 8, 140
    for sid, w in make_streams(n, steps, input_dim).items():
        fleet.attach(sid, w, total_steps=steps)
    fleet.drain()
    snap = obs.metrics.snapshot()
    assert validate_snapshot(snap) == []
    assert snap["counters"]["fleet.ticks"] == fleet.stats()["ticks"]
    wh = snap["histograms"]["stream.warmup_samples"]
    assert wh["count"] == n and wh["sum_us"] == n * 128
    assert snap["counters"]["stream.warm_emissions"] == n * 2
    assert snap["counters"]["stream.cold_emissions"] == 0
    assert snap["gauges"]["fleet.active"] == 0
    assert snap["gauges"]["fleet.occupancy"] == 0


def test_deadline_miss_accounting(qp, input_dim):
    obs = Observability.full(deadline_ms=0.0)
    fleet = FleetEngine(qp, FleetConfig(
        shards=2, stream=cfg(max_slots=4)), obs=obs)
    for sid, w in make_streams(4, 50, input_dim).items():
        fleet.attach(sid, w, total_steps=50)
    fleet.drain()
    snap = obs.metrics.snapshot()
    st = fleet.stats()
    assert snap["counters"]["fleet.deadline_miss_ticks"] == st["ticks"]
    assert snap["counters"]["fleet.deadline_miss_stream_ticks"] == \
        st["stream_steps"]
    per_shard = sum(snap["counters"][f"fleet.shard{i}."
                                     "deadline_miss_stream_ticks"]
                    for i in range(2))
    assert per_shard == st["stream_steps"]
    obs2 = Observability.full()
    fleet2 = FleetEngine(qp, FleetConfig(
        shards=2, stream=cfg(max_slots=4)), obs=obs2)
    for sid, w in make_streams(4, 50, input_dim).items():
        fleet2.attach(sid, w, total_steps=50)
    fleet2.drain()
    assert obs2.metrics.snapshot()["counters"][
        "fleet.deadline_miss_ticks"] == 0


def test_warmup_histogram_survives_migration(qp, input_dim):
    obs = Observability.full()
    fleet = FleetEngine(qp, FleetConfig(
        shards=2, stream=cfg(max_slots=4, warmup_samples=64)), obs=obs)
    streams = make_streams(2, 150, input_dim)
    for sid, w in streams.items():
        fleet.attach(sid, w, total_steps=150)
    for _ in range(40):
        fleet.step()
    sid0 = next(iter(streams))
    fleet.migrate(sid0, (fleet.shard_of(sid0) + 1) % 2)
    fleet.drain()
    wh = obs.metrics.snapshot()["histograms"]["stream.warmup_samples"]
    assert wh["count"] == 2
    assert wh["sum_us"] == 2 * 128


# ---------------------------------------------------------------------------
# Flight recorder + crash matrix byte-stability
# ---------------------------------------------------------------------------

def test_flight_recorder_truncates_event_tail():
    dumps = []
    for mod in (None, J):
        tr = (mod.Tracer if mod else Tracer)(capacity=8)
        rec = (mod.FlightRecorder if mod else FlightRecorder)(
            tr, events_per_shard=4)
        rec.note_events(0, tick=1, summaries=[(f"s{i}", "window", i)
                                              for i in range(10)])
        rec.note_events(0, tick=2, summaries=[("x", "final", 99)], total=500)
        dumps.append(rec.record_crash({"shard": 0, "phase": "pre_tick"},
                                      tick=3))
    ev = dumps[0]["recent_events"]["0"]
    assert ev["total_events"] == 510
    assert len(ev["tail"]) == 4
    assert ev["tail"][-1] == {"tick": 2, "stream": "x", "kind": "final",
                              "step": 99}
    assert dumps[0]["recent_events"] == dumps[1]["recent_events"]


def test_flight_recorder_dump_on_crash(qp, input_dim):
    obs = Observability.full()
    fleet = FleetEngine(qp, FleetConfig(
        shards=2, snapshot_every=16, stream=cfg(max_slots=8)), obs=obs)
    for sid, w in make_streams(8, 200, input_dim).items():
        fleet.attach(sid, w, total_steps=200)
    for _ in range(140):
        fleet.step()
    fleet.crash_shard(1)
    assert obs.recorder.n_crashes == 1
    d = obs.recorder.last()
    assert d["artifact"] == "flight_record" and d["shard"] == 1
    assert d["recovery"]["streams_recovered"] > 0
    assert d["counters"]["failovers"] == 1
    phases_seen = {r["phase"] for r in d["trace"]}
    assert {"fleet.tick", "fleet.begin", "fleet.dispatch",
            "fleet.finish"} <= phases_seen
    assert all(r["tick"] <= d["tick"] for r in d["trace"])
    assert [r["seq"] for r in d["trace"]] == sorted(
        r["seq"] for r in d["trace"])
    assert any(ev["total_events"] > 0 for ev in d["recent_events"].values())
    fleet.drain()


@pytest.mark.parametrize("shards", [2, 4])
def test_crash_matrix_flight_dumps_byte_stable(qp, jqp, input_dim, shards):
    """Identical runs under the full phase x shard crash matrix give
    byte-identical deterministic flight dumps, and the event log and the
    flight dump of the reference's fleet under the same schedule."""
    streams = make_streams(12, 300, input_dim, seed=5)

    def run():
        obs = Observability.full()
        log, stats = port_crash_schedule(
            qp, streams, shards=shards, slots_per_shard=8,
            injector=crash_matrix(shards), obs=obs)
        return obs, log, stats

    obs_a, log_a, stats_a = run()
    obs_b, log_b, stats_b = run()
    assert obs_a.recorder.n_crashes == 3 * shards
    dump_a = obs_a.recorder.dumps(deterministic=True)
    assert dump_a == obs_b.recorder.dumps(deterministic=True)
    assert log_a == log_b
    jobs = J.Observability.full()
    jlog, _ = jharness.run_crash_schedule(
        jqp, streams, shards=shards, slots_per_shard=8,
        injector=j_crash_matrix(shards), obs=jobs)
    assert log_a == jlog
    assert dump_a == jobs.recorder.dumps(deterministic=True)
    full = json.loads(obs_a.recorder.dumps())
    assert any("dur_us" in r for c in full["crashes"] for r in c["trace"])


# ---------------------------------------------------------------------------
# O(shards) stats regression
# ---------------------------------------------------------------------------

class _PoisonDict(dict):
    """Raises if anybody iterates it — the O(streams) tripwire."""

    def __iter__(self):
        raise AssertionError("stats() iterated a per-stream container")

    def keys(self):
        raise AssertionError("stats() iterated a per-stream container")

    def values(self):
        raise AssertionError("stats() iterated a per-stream container")

    def items(self):
        raise AssertionError("stats() iterated a per-stream container")


def test_fleet_stats_is_o_shards_not_o_streams(qp, input_dim):
    fleet = FleetEngine(qp, FleetConfig(shards=4, stream=cfg(max_slots=8)))
    for sid, w in make_streams(16, 60, input_dim).items():
        fleet.attach(sid, w, total_steps=60)
    for _ in range(10):
        fleet.step()
    saved = (fleet._owner, fleet._cursor, fleet._snapshots, fleet._journal,
             [sh._sessions for sh in fleet.shards])
    fleet._owner = _PoisonDict(fleet._owner)
    fleet._cursor = _PoisonDict(fleet._cursor)
    fleet._snapshots = _PoisonDict(fleet._snapshots)
    fleet._journal = _PoisonDict(fleet._journal)
    for sh in fleet.shards:
        sh._sessions = _PoisonDict(sh._sessions)
    calls = {"n": 0}
    orig = type(fleet.shards[0]).stats

    def counting_stats(self):
        calls["n"] += 1
        return orig(self)

    try:
        type(fleet.shards[0]).stats = counting_stats
        st = fleet.stats()
    finally:
        type(fleet.shards[0]).stats = orig
        fleet._owner, fleet._cursor, fleet._snapshots, fleet._journal, \
            sessions = saved
        for sh, sess in zip(fleet.shards, sessions):
            sh._sessions = sess
    assert calls["n"] == 4
    assert st["active"] == 16
    fleet.drain()


# ---------------------------------------------------------------------------
# LM engine spans
# ---------------------------------------------------------------------------

def test_lm_engine_obs_spans():
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, ServeConfig
    lm = C.reduced(C.get("deepseek-7b"), compute_dtype="float32",
                   param_dtype="float32")
    params = T.init(lm, torch.Generator().manual_seed(0))
    obs = Observability.full()
    eng = Engine(lm, params, ServeConfig(max_len=32, max_slots=2), obs=obs,
                 device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, lm.vocab_size, 4).astype(np.int32), 4)
    eng.run()
    st = obs.tracer.phase_stats()
    assert st["lm.prefill"]["count"] == 3
    assert st["lm.decode"]["count"] >= 3
    assert "lm.tick" in st and "sched.admit" in st
    snap = obs.metrics.snapshot()
    assert snap["counters"]["lm.tokens_generated"] == \
        eng.stats()["tokens_generated"] - 3


# ---------------------------------------------------------------------------
# span phase-name registry (repro_torch.obs.phases)
# ---------------------------------------------------------------------------

def test_every_serving_span_phase_is_registered():
    """Every phase literal recorded through the tracer API in the port's
    serving and deploy trees is registered in
    ``repro_torch.obs.phases.PHASES``, and the registry is the
    reference's."""
    import ast
    import os
    from repro_torch.obs.phases import PHASES

    src_root = os.path.join(os.path.dirname(__file__), "..", "src",
                            "repro_torch")
    used = {}
    for sub in ("serve", "deploy"):
        for dirpath, _, files in os.walk(os.path.join(src_root, sub)):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    tree = ast.parse(f.read(), filename=path)
                for node in ast.walk(tree):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr in ("rec", "span")
                            and node.args
                            and isinstance(node.args[0], ast.Constant)
                            and isinstance(node.args[0].value, str)):
                        used.setdefault(node.args[0].value, []).append(
                            f"{path}:{node.lineno}")
    unregistered = {p: w for p, w in used.items() if p not in PHASES}
    assert not unregistered, unregistered
    assert {"fleet.tick", "engine.kernel", "lm.prefill",
            "verify.qvm"} <= set(used)
    assert PHASES == J.PHASES


def test_phase_registry_api():
    from repro_torch.obs import PHASES, assert_registered, registered
    from repro_torch.obs import phases as P
    assert registered("fleet.dispatch") and not registered("fleet.dispach")
    assert_registered("engine.tick")
    with pytest.raises(ValueError):
        assert_registered("engine.tick_typo")
    groups = (P.ENGINE_PHASES + P.FLEET_PHASES + P.LM_PHASES
              + P.SCHED_PHASES + P.VERIFY_PHASES)
    assert len(groups) == len(set(groups)) == len(PHASES)
