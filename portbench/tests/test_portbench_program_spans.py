"""The readers of the program's own spans (``harness/program_spans.py``)
on hand-built records, their silence on a program without the fields,
and, on the tiny serving cell's traced CPU run, the serving driver's
replay against what the program now records itself: the request of
each ``lm.prefill`` and the rows of each ``lm.decode``."""
import time

import pytest

from portbench import run as R
from portbench.drivers import serve_closed_loop as D
from portbench.harness import program_spans as P


def span(seq, phase, t0_us, dur_us, parent=-1, req=None, n=0):
    return {"seq": seq, "tick": 0, "phase": phase, "shard": -1,
            "t0_us": t0_us, "dur_us": dur_us, "parent": parent, "req": req,
            "n": n}


def serve_rec():
    """Two decode ticks and a prefill.  The clock puts the counter's
    1,000 ns at Unix 5,000,000 ns, so a span's Unix start is 5,000,000 +
    t0_us * 1000 ns, and the traced window, counter ns [3,000, 101,000],
    is [2, 100] us past Unix 5,000,000."""
    spans = [
        span(0, "model.mamba", 0, 20, parent=2),
        span(1, "model.mamba", 20, 30, parent=2),
        span(2, "lm.forward", 0, 50, parent=3),
        span(3, "lm.decode", 0, 60, n=8),
        span(4, "model.mamba", 60, 10, parent=5),
        span(5, "lm.forward", 60, 10, parent=6),
        span(6, "lm.decode", 60, 30, n=7),
        span(7, "lm.forward", 90, 8, parent=8),
        span(8, "lm.prefill", 90, 10, req="w0", n=4096),
    ]
    unix = 5_000_000
    dev = [("k", unix - 5_000, unix + 2_000),
           ("k", unix + 10_000, unix + 30_000),
           ("k", unix + 55_000, unix + 65_000)]
    return {"kind": "serve",
            "trace": {"device_events": dev, "wall_s": 1e-4},
            "program": {"spans": spans, "clock": (1_000, unix),
                        "traced_ns": (1_000 + 2_000, 101_000)}}


def test_forward_medians_by_enclosing_span():
    rec = serve_rec()
    assert P.forward_ms_p50(rec, "lm.decode") == pytest.approx(0.03)
    assert P.forward_ms_p50(rec, "lm.prefill") == pytest.approx(0.008)


def test_idle_in_layers_splits_idle_time_at_span_edges():
    # the window opens at 2 us, where a device interval ends, so the
    # idle time is [2, 10] + [30, 55] + [65, 100] = 68 us; the layers'
    # spans [0, 50] and [60, 70] cover 8 + 20 + 5 = 33 us of it
    assert P.idle_in_layers_share(serve_rec()) == pytest.approx(
        100.0 * 33 / 68)


@pytest.mark.parametrize("drop", ["program", "spans", "parent", "clock",
                                  "traced_ns", "device_events"])
def test_readers_are_silent_without_the_program_fields(drop):
    rec = serve_rec()
    if drop == "program":
        del rec["program"]
    elif drop == "parent":
        for s in rec["program"]["spans"]:
            del s["parent"]
    elif drop == "device_events":
        rec["trace"]["device_events"] = []
    else:
        del rec["program"][drop]
    share = P.idle_in_layers_share(rec)
    assert share is None
    medians = (P.forward_ms_p50(rec, "lm.decode"),
               P.forward_ms_p50(rec, "lm.prefill"))
    if drop in ("program", "spans", "parent"):
        assert medians == (None, None)
    else:
        assert None not in medians


def test_no_layer_spans_reads_none():
    rec = serve_rec()
    rec["program"]["spans"] = [s for s in rec["program"]["spans"]
                               if not s["phase"].startswith("model.")]
    assert P.idle_in_layers_share(rec) is None
    assert P.forward_ms_p50(rec, "lm.decode") is not None


def test_replay_agrees_with_the_programs_ids_and_rows(tiny_root,
                                                      monkeypatch):
    """The serving driver's ``_replay`` pairs the n-th ``lm.prefill``
    with the n-th submission and models each decode's rows; the program
    records both, and they agree."""
    import repro_torch.obs as obs
    tracers, submitted = [], []

    class Kept(obs.Tracer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tracers.append(self)

    submit = D._Loop.submit

    def kept_submit(self, r, phase, ready_ns):
        submitted.append((f"{phase}{r.index}", r))
        submit(self, r, phase, ready_ns)

    monkeypatch.setattr(obs, "Tracer", Kept)
    monkeypatch.setattr(D._Loop, "submit", kept_submit)
    res = R.run_cell(tiny_root, "tiny-ssm.tiny-serve", 2**31 + 991, 1.5,
                     True, "cpu", t_start=time.perf_counter())
    assert res["correct"] is True
    spans = tracers[0].flight()
    prefills, decodes = D._replay(
        spans, [{"req": r} for _, r in submitted], 0)
    pre = [s for s in spans if s["phase"] == "lm.prefill"]
    dec = [s for s in spans if s["phase"] == "lm.decode"]
    assert [s["req"] for s in pre] == [rid for rid, _ in
                                       submitted[:len(pre)]]
    assert [s["n"] for s in pre] == [p[2] for p in prefills]
    assert [s["n"] for s in dec] == [len(d[2]) for d in decodes]
    assert len(dec) > 10
