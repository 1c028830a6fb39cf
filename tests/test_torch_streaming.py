"""Port parity, the serving path: ``repro_torch``'s ``StreamingEngine`` on
``device="cpu"`` against the reference engine's ``backend="exact"`` and
the scalar ``QRuntime`` — event lists, trajectories and snapshots byte for
byte — plus the slot scheduler run side by side with the reference's."""
import numpy as np
import pytest

from repro.core import quantization as jq
from repro.obs import Observability as JObservability
from repro.obs.numerics import NumericsMonitor as JMonitor
from repro.serve.scheduler import SlotScheduler as JScheduler
from repro.serve.scheduler import TickReport as JTickReport
from repro.serve.streaming import StreamingConfig as JConfig
from repro.serve.streaming import StreamingEngine as JEngine
from repro_torch.compress import ModelArtifact
from repro_torch.core import quantization as q
from repro_torch.core.qruntime import QRuntime, _matvec, calibrate
from repro_torch.data import hapt
from repro_torch.obs import Observability
from repro_torch.obs.numerics import NumericsMonitor
from repro_torch.serve.scheduler import SlotScheduler, TickReport
from repro_torch.serve.streaming import (StreamEventBatch, StreamingConfig,
                                         StreamingEngine, classify_windows)


def np_params(seed, low_rank=True, H=16, d=3, C=6):
    """Float params at the paper's shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    m = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    p = ({"W1": m(H, 2), "W2": m(d, 2), "U1": m(H, 8), "U2": m(H, 8)}
         if low_rank else {"W": m(H, d), "U": m(H, H)})
    p.update(b_z=np.ones(H, np.float32), b_h=np.zeros(H, np.float32),
             zeta=np.float32(1.0), nu=np.float32(-4.0), head_w=m(H, C),
             head_b=np.zeros(C, np.float32))
    return p


@pytest.fixture(scope="module")
def qp():
    return q.quantize_params(np_params(0), q.QuantConfig())


@pytest.fixture(scope="module")
def windows():
    return hapt.generate_synthetic("test", 0, n=320).windows


def cpu(max_slots, **kw):
    return StreamingConfig(max_slots=max_slots, device="cpu", **kw)


def as_bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def event_rows(events):
    """Comparable (id, kind, step, window_step, prediction, warm, logits
    bytes) rows from per-stream or columnar events of either package."""
    out = []
    for e in events:
        for ev in (e.events() if hasattr(e, "stream_ids") else [e]):
            out.append((ev.stream_id, ev.kind, int(ev.step),
                        int(ev.window_step), int(ev.prediction),
                        bool(ev.warm),
                        np.asarray(ev.logits, np.float32).tobytes()))
    return out


def scripted_run(eng, windows, n=288):
    """The shared lifecycle script: more streams than slots (pending FIFO +
    recycling), multi-window open streams, a mid-window detach, a stream
    fed in chunks with idle ticks, and trajectory taps."""
    events = []
    for i in range(n):
        if i % 37 == 0:     # open multi-window stream, tapped
            eng.attach(f"m{i}", np.concatenate([windows[i], windows[i + 1]]),
                       record_trajectory=True)
        elif i % 23 == 0:   # will be detached mid-window
            eng.attach(f"d{i}", windows[i][:90])
        else:
            eng.attach(f"s{i}", windows[i], total_steps=128,
                       record_trajectory=(i % 11 == 0))
    eng.attach("chunked", windows[300][:40], total_steps=128,
               record_trajectory=True)
    for _ in range(70):
        events += eng.step()
    events.append(eng.detach("d23"))
    eng.feed("chunked", windows[300][40:])
    events += eng.drain()
    for i in range(0, n, 37):
        events.append(eng.detach(f"m{i}"))
    taps = {sid: eng.trajectory(sid).tobytes()
            for sid in ["chunked"] + [f"m{i}" for i in range(0, n, 37)]
            + [f"s{i}" for i in range(11, n, 11) if i % 37 and i % 23]}
    return [e for e in events if e is not None], taps


@pytest.mark.parametrize("mode", ["deployed", "calibrated", "naive"])
@pytest.mark.parametrize("low_rank", [True, False])
def test_engine_script_byte_equal_to_reference_exact(low_rank, mode, windows):
    p = np_params(1, low_rank)
    qp, jqp = q.quantize_params(p, q.QuantConfig()), \
        jq.quantize_params(p, jq.QuantConfig())
    kw = {}
    if mode == "calibrated":
        kw["act_scales"] = calibrate(QRuntime(qp), windows[:4])
    elif mode == "naive":
        kw["naive_acts"] = True
    batch = mode == "deployed"
    eng = StreamingEngine(qp, cpu(64, batch_events=batch), **kw)
    ref = JEngine(jqp, JConfig(max_slots=64, batch_events=batch), **kw)
    got_ev, got_taps = scripted_run(eng, windows)
    ref_ev, ref_taps = scripted_run(ref, windows)
    # byte-equal events (kind, step, window_step, prediction, warm, logits)
    # and trajectories: both engines run the same float32 op sequence
    assert event_rows(got_ev) == event_rows(ref_ev)
    assert got_taps == ref_taps
    st, rst = eng.stats(), ref.stats()
    for k in ("ticks", "stream_steps", "completed", "peak_active",
              "ring_capacity", "ring_spills", "scheduler"):
        assert st[k] == rst[k], k
    assert st["device"] == "cpu"


def test_256_concurrent_streams_bit_identical_to_scalar(qp, windows):
    w = windows[:256]
    eng = StreamingEngine(qp, cpu(256))
    for i in range(256):
        eng.attach(f"s{i}", w[i], total_steps=128)
    assert eng.n_active == 256
    by_id = {e.stream_id: e for e in eng.drain()}
    rt = QRuntime(qp)
    ref = np.stack([rt.run_window(x) for x in w])
    got = np.stack([by_id[f"s{i}"].logits for i in range(256)])
    np.testing.assert_array_equal(as_bits(got), as_bits(ref))   # bitwise
    assert eng.stats()["stream_steps"] == 256 * 128


def test_full_rank_classify_matches_scalar(windows):
    qp = q.quantize_params(np_params(2, low_rank=False), q.QuantConfig())
    eng = StreamingEngine(qp, cpu(40))
    np.testing.assert_array_equal(classify_windows(eng, windows[:40]),
                                  QRuntime(qp).predict_batch(windows[:40]))


def test_slot_recycling_pending_queue(qp, windows):
    w = windows[:96]
    eng = StreamingEngine(qp, cpu(32))
    statuses = [eng.attach(f"s{i}", w[i], total_steps=128) for i in range(96)]
    assert statuses.count("active") == 32 and statuses.count("pending") == 64
    preds = {e.stream_id: e.prediction for e in eng.drain()}
    np.testing.assert_array_equal(np.array([preds[f"s{i}"] for i in range(96)]),
                                  QRuntime(qp).predict_batch(w))
    st = eng.stats()
    assert st["peak_active"] == 32 and st["completed"] == 96
    assert st["ticks"] == 3 * 128


def test_attach_respects_pending_fifo(qp, windows):
    eng = StreamingEngine(qp, cpu(1))
    eng.attach("a", windows[0], total_steps=128)
    assert eng.attach("b", windows[1], total_steps=128) == "pending"
    for _ in range(128):
        eng.step()
    assert eng.attach("c", windows[2], total_steps=128) == "pending"
    eng.step()
    assert eng._sessions["b"].slot >= 0 and eng._sessions["c"].slot == -1


def test_attach_beyond_slots_is_pending_until_free(qp, windows):
    eng = StreamingEngine(qp, cpu(2))
    assert [eng.attach(s, windows[i], total_steps=128)
            for i, s in enumerate("abc")] == ["active", "active", "pending"]
    assert (eng.n_active, eng.n_pending) == (2, 1)
    eng.drain()
    assert (eng.n_active, eng.n_pending) == (0, 0)


def test_detach_midwindow_emits_partial_final(qp, windows):
    eng = StreamingEngine(qp, cpu(4))
    eng.attach("s", windows[0][:50])
    eng.drain()
    ev = eng.detach("s")
    assert ev.kind == "final" and ev.step == 50 and ev.window_step == 50
    assert not ev.warm
    rt = QRuntime(qp)
    h = np.zeros(16, np.float32)
    for t in range(50):
        h = rt.step(h, windows[0][t])
    ref = _matvec(rt._w["head_w"].T, h) + rt._head_b
    np.testing.assert_array_equal(as_bits(ev.logits), as_bits(ref))  # bitwise


def test_idle_slots_hold_state_bit_for_bit(qp, windows):
    eng = StreamingEngine(qp, cpu(4))
    eng.attach("s", windows[0][:30], total_steps=128)
    eng.attach("busy", windows[1], total_steps=128)
    for _ in range(70):
        eng.step()
    eng.feed("s", windows[0][30:])
    ev = [e for e in eng.drain() if e.stream_id == "s"][0]
    np.testing.assert_array_equal(as_bits(ev.logits),
                                  as_bits(QRuntime(qp).run_window(windows[0])))


def test_warmup_flags_and_multi_window_tumbling(qp, windows):
    eng = StreamingEngine(qp, cpu(3, warmup_samples=74))
    eng.attach("cold", windows[0][:40], total_steps=40)
    eng.attach("warm", windows[1], total_steps=128)
    eng.attach("open")
    for k in range(3):
        eng.feed("open", windows[k])
    events = eng.drain()
    by = {}
    for e in events:
        by.setdefault(e.stream_id, []).append(e)
    assert (by["cold"][0].kind, by["cold"][0].step, by["cold"][0].warm) == \
        ("final", 40, False)
    assert (by["warm"][0].kind, by["warm"][0].warm) == ("window", True)
    assert [e.step for e in by["open"]] == [128, 256, 384]
    rt = QRuntime(qp)
    for k, e in enumerate(by["open"]):
        np.testing.assert_array_equal(as_bits(e.logits),
                                      as_bits(rt.run_window(windows[k])))


def test_lifecycle_errors(qp, windows):
    eng = StreamingEngine(qp, cpu(1))
    eng.attach("a", windows[0], total_steps=128)
    with pytest.raises(ValueError):
        eng.attach("a")
    assert eng.attach("b", windows[1], total_steps=128) == "pending"
    with pytest.raises(ValueError):
        eng.attach("b")
    assert eng.detach("b") is None
    eng.drain()
    with pytest.raises(KeyError):
        eng.feed("a", windows[0][:3])
    with pytest.raises(KeyError):
        eng.detach("a")
    with pytest.raises(ValueError):
        eng.attach("c", np.zeros((3, 4), np.float32))


def test_ring_growth_under_spill_pressure(qp, windows):
    eng = StreamingEngine(qp, cpu(2, ring_capacity=8, max_ring_capacity=32))
    eng.attach("s")
    eng.feed("s", np.concatenate([windows[k] for k in range(3)]))
    st = eng.stats()
    assert st["ring_capacity"] == 32 and st["ring_spills"] >= 1
    events = eng.drain()
    rt = QRuntime(qp)
    assert [e.kind for e in events] == ["window"] * 3
    for k, e in enumerate(events):
        np.testing.assert_array_equal(as_bits(e.logits),
                                      as_bits(rt.run_window(windows[k])))


def test_drain_with_empty_pending_queue_and_counters(qp, windows):
    eng = StreamingEngine(qp, cpu(2))
    assert eng.drain() == []
    eng.attach("idle")
    assert eng.drain() == [] and eng.n_active == 1
    eng.detach("idle")
    for i in range(4):
        eng.attach(f"s{i}", windows[i], total_steps=128)
    eng.drain()
    sched = eng.stats()["scheduler"]
    assert (sched["admissions"], sched["recycles"], sched["spills"],
            sched["completed"], sched["occupancy"]) == (5, 3, 2, 4, 0.0)


@pytest.mark.parametrize("naive", [False, True])
def test_activation_storage_modes_match_scalar(qp, windows, naive):
    kw = {"naive_acts": True} if naive else \
        {"act_scales": calibrate(QRuntime(qp), windows[:5])}
    eng = StreamingEngine(qp, cpu(8), **kw)
    np.testing.assert_array_equal(classify_windows(eng, windows[:8]),
                                  QRuntime(qp, **kw).predict_batch(windows[:8]))


def test_float_params_and_artifact_entry(windows):
    p = np_params(4)
    eng = StreamingEngine(p, cpu(4))
    ref = QRuntime(q.quantize_params(p, q.QuantConfig()))
    np.testing.assert_array_equal(classify_windows(eng, windows[:4]),
                                  ref.predict_batch(windows[:4]))
    art = ModelArtifact.from_params(p).replace(
        qp=q.quantize_params(p, q.QuantConfig()),
        storage_scales=calibrate(ref, windows[:3]))
    art = ModelArtifact.from_bytes(art.to_bytes())
    for quantized in (False, True):
        eng = StreamingEngine.from_artifact(art, cpu(4), quantized_acts=quantized)
        rt = QRuntime.from_artifact(art, quantized_acts=quantized)
        np.testing.assert_array_equal(classify_windows(eng, windows[4:8]),
                                      rt.predict_batch(windows[4:8]))


def test_batch_events_expand_to_per_stream_events(qp, windows):
    a = StreamingEngine(qp, cpu(8, batch_events=True))
    b = StreamingEngine(qp, cpu(8))
    for eng in (a, b):
        for i in range(8):
            eng.attach(f"s{i}", windows[i][:100 + i], total_steps=100 + i)
    ea, eb = a.drain(), b.drain()
    assert all(isinstance(e, StreamEventBatch) for e in ea)
    assert event_rows(ea) == event_rows(eb)


# ---- migration snapshots ----------------------------------------------------

def _export_continue(make, windows, jstate=None):
    a, b = make(), make()
    a.attach("s", windows[0], record_trajectory=True)
    a.attach("p", windows[1][:20])
    for _ in range(50):
        a.step()
    a.feed("s", windows[1])
    state = a.export_stream("s")
    assert b.import_stream(state) == "active"
    events = b.drain() + [b.detach("s")]
    return state, event_rows([e for e in events if e is not None]), \
        b.trajectory("s").tobytes()


def test_export_import_round_trip_bit_exact(qp, windows):
    p = np_params(0)
    jqp = jq.quantize_params(p, jq.QuantConfig())
    state, rows, traj = _export_continue(
        lambda: StreamingEngine(qp, cpu(2)), windows)
    jstate, jrows, jtraj = _export_continue(
        lambda: JEngine(jqp, JConfig(max_slots=2)), windows)
    assert (state.steps, state.wstep, state.total) == \
        (jstate.steps, jstate.wstep, jstate.total)
    assert state.h.tobytes() == jstate.h.tobytes()
    assert state.samples.tobytes() == jstate.samples.tobytes()
    assert rows == jrows and traj == jtraj
    # an uninterrupted run gives the same continuation
    eng = StreamingEngine(qp, cpu(2))
    eng.attach("s", windows[0], record_trajectory=True)
    eng.attach("p", windows[1][:20])
    for _ in range(50):
        eng.step()
    eng.feed("s", windows[1])
    events = eng.drain() + [eng.detach("s")]
    tail = [r for r in event_rows([e for e in events if e is not None])
            if r[0] == "s"]
    assert rows == tail and eng.trajectory("s").tobytes() == traj


def test_snapshot_of_pending_migrated_stream_keeps_state(qp, windows):
    a = StreamingEngine(qp, cpu(1))
    a.attach("s", windows[0][:64])
    for _ in range(64):
        a.step()
    state = a.export_stream("s")
    b = StreamingEngine(qp, cpu(1))
    b.attach("blocker", windows[1], total_steps=128)
    assert b.import_stream(state) == "pending"
    snap = b.snapshot_stream("s")
    assert snap.h.tobytes() == state.h.tobytes() and snap.steps == 64


# ---- observability seams ------------------------------------------------------

def test_monitored_traced_run_byte_identical_and_matches_reference(windows):
    p = np_params(3)
    qp, jqp = q.quantize_params(p, q.QuantConfig()), \
        jq.quantize_params(p, jq.QuantConfig())
    limits = {"x": 2.0, "pre": 1.0, "h": 0.5, "logits": 1.0}
    obs = Observability.full(numerics=True)
    obs.numerics = NumericsMonitor(dict(limits))
    jobs = JObservability.full(numerics=True)
    jobs.numerics = JMonitor(dict(limits))
    mon = StreamingEngine(qp, cpu(32), obs=obs)
    plain = StreamingEngine(qp, cpu(32))
    ref = JEngine(jqp, JConfig(max_slots=32), obs=jobs)
    runs = [classify_windows(e, windows[:48] * 2000.0) for e in (mon, plain, ref)]
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])
    assert obs.numerics.snapshot() == jobs.numerics.snapshot()
    assert obs.numerics.site_counts()["act.z.idx"] > 0
    assert obs.tracer.enabled and obs.metrics.snapshot()


# ---- the slot scheduler, side by side with the reference ----------------------

class Countdown:
    """Toy program: each request runs ``payload`` ticks; records hooks."""

    def __init__(self, n, report):
        self.remaining = np.zeros(n, np.int64)
        self.log = []
        self.report = report

    def admit(self, slot, rid, payload, reset):
        self.remaining[slot] = payload
        self.log.append(("admit", slot, rid, reset))

    def step(self, resident):
        rows = np.nonzero(resident & (self.remaining > 0))[0]
        self.remaining[rows] -= 1
        done = [int(s) for s in np.nonzero(resident)[0]
                if self.remaining[s] == 0]
        return self.report(events=[len(rows)], finished=done,
                           advanced=int(rows.size))

    def release(self, slot, rid, reason):
        self.log.append(("release", slot, rid, reason))
        return ("partial", rid) if reason == "cancelled" else None


def _schedule(cls, report, policy, n_slots):
    prog = Countdown(n_slots, report)
    s = cls(n_slots, prog, admit_policy=policy)
    out = [s.submit(f"r{i}", 1 + (i * 7) % 5) for i in range(9)]
    out.append(s.cancel("r7"))
    out += [s.tick() for _ in range(3)]
    out.append(s.cancel("r3") if s.slot_of("r3") >= 0 else None)
    s.evict("r8") if "r8" in s._payloads or s.slot_of("r8") >= 0 else None
    while s.has_work():
        out.append(s.tick())
    out.append(s.tick())
    return out, prog.log, s.stats()


@pytest.mark.parametrize("policy,n_slots", [("any_free", 1), ("any_free", 3),
                                            ("all_free", 2)])
def test_scheduler_trace_equals_reference(policy, n_slots):
    assert _schedule(SlotScheduler, TickReport, policy, n_slots) == \
        _schedule(JScheduler, JTickReport, policy, n_slots)


def test_scheduler_rejects_bad_construction_and_duplicates():
    with pytest.raises(ValueError):
        SlotScheduler(0, Countdown(1, TickReport))
    with pytest.raises(ValueError):
        SlotScheduler(1, Countdown(1, TickReport), admit_policy="nope")
    s = SlotScheduler(2, Countdown(2, TickReport))
    s.submit("a", 1)
    with pytest.raises(ValueError):
        s.submit("a", 1)
    with pytest.raises(KeyError):
        s.cancel("zz")
