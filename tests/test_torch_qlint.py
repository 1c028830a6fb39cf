"""Port parity, the static analyzer and the numeric-health loop:
``repro_torch.analysis`` (intervals, qlint, crosscheck, report) and the
qvm / emitted-C saturation counters, against the reference on the same
carried-across images.

Mirrors the qlint and interval cases of ``tests/test_analysis.py`` and the
qvm / C / crosscheck cases of ``tests/test_numerics.py``, and holds
``analyze_image`` on the reference Q15 and Q7 images to the reference's
report and to the committed ``ANALYSIS_report.json``.  The reference's
params are built under ``threefry_partitionable(False)`` (ROADMAP C0).
"""
import json
import os

import numpy as np
import pytest

from repro.analysis.qlint import analyze_image as j_analyze_image
from repro.deploy import goldens as JG
from repro.deploy.image import DeployImage as JImage
from repro.deploy.image import build_image as j_build_image
from repro.deploy.qvm import QVM as JQVM
from repro.obs.numerics import NumericsMonitor as JMonitor
from repro_torch import weights
from repro_torch.analysis import (Assumptions, Interval, Machine,
                                  analyze_image, build_report, crosscheck,
                                  dumps, reference_targets, target_by_name)
from repro_torch.data import hapt
from repro_torch.deploy import emit_c
from repro_torch.deploy.goldens import build_reference_artifact
from repro_torch.deploy.image import build_image
from repro_torch.deploy.qvm import QVM
from repro_torch.obs.numerics import NumericsMonitor, site_order
from torchharness import reference_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Gain that drives h_next saturation on the reference model.
STRESS = 8


@pytest.fixture(scope="module")
def ref_params():
    return reference_init()


@pytest.fixture(scope="module")
def art(ref_params):
    return build_reference_artifact(
        params=weights.params_from_numpy(ref_params), device="cpu")


@pytest.fixture(scope="module")
def img(art):
    return build_image(art)


@pytest.fixture(scope="module")
def images(ref_params):
    """{label: (port image, reference image)} for Q15 and Q7."""
    out = {}
    for bits, label in ((15, "q15"), (7, "q7")):
        port = build_image(build_reference_artifact(
            params=weights.params_from_numpy(ref_params), bits=bits,
            device="cpu"))
        ref = j_build_image(JG.build_reference_artifact(params=ref_params,
                                                        bits=bits))
        out[label] = (port, ref)
    return out


@pytest.fixture(scope="module")
def ref_targets(images):
    return [analyze_image(images[label][0], name=f"reference-{label}-s0")
            for label in ("q15", "q7")]


@pytest.fixture(scope="module")
def committed():
    with open(os.path.join(REPO, "ANALYSIS_report.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def windows():
    return hapt.load("test", n=32).windows


@pytest.fixture
def cc():
    if not emit_c.find_cc():
        pytest.skip("no host C compiler")


# ---------------------------------------------------------------------------
# qlint against the reference's analyzer and its committed report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["q15", "q7"])
def test_analyze_image_equals_reference(images, committed, label):
    """The port's report on each reference image equals the reference
    analyzer's on the same image and the committed report's target."""
    port, ref = images[label]
    assert port.to_bytes() == ref.to_bytes()
    name = f"reference-{label}-s0"
    rec = analyze_image(port, name=name)
    assert rec == j_analyze_image(ref, name=name)
    assert rec == target_by_name(committed, name)


def test_report_canonical_and_qlint_block_committed(ref_targets, committed):
    """``build_report`` + ``dumps`` is byte-deterministic; its qlint block
    is the committed report's, with the linter marked skipped."""
    r1 = dumps(build_report(ref_targets, None))
    r2 = dumps(build_report([dict(t) for t in ref_targets], None))
    assert r1 == r2 and r1.endswith("\n")
    rep = json.loads(r1)
    assert rep["qlint"] == committed["qlint"]
    assert rep["detlint"] == {"skipped": True}
    assert rep["summary"] == {"findings": 0, "suppressed": 0, "ok": True}
    assert rep["schema_version"] == committed["schema_version"]


def test_reference_targets_of_the_port_init():
    """``reference_targets`` proves the port's own seed-0 images (a
    ``torch.Generator`` draw) overflow-free too."""
    targets = reference_targets(device="cpu")
    assert [t["name"] for t in targets] == ["reference-q15-s0",
                                            "reference-q7-s0"]
    for t in targets:
        assert t["proved_overflow_free"], t["findings"]
        assert t["state_closed"]


# ---------------------------------------------------------------------------
# interval domain: exact by enumeration (tests/test_analysis.py)
# ---------------------------------------------------------------------------

def test_interval_ops_exact_by_enumeration():
    a, b = Interval(-5, 3), Interval(-2, 7)
    xs = range(a.lo, a.hi + 1)
    ys = range(b.lo, b.hi + 1)
    for op, ref in (("add", lambda x, y: x + y),
                    ("sub", lambda x, y: x - y),
                    ("mul", lambda x, y: x * y)):
        got = getattr(a, op)(b)
        vals = [ref(x, y) for x in xs for y in ys]
        assert (got.lo, got.hi) == (min(vals), max(vals)), op
    for n in (0, 1, 2, 5):
        got = a.shr(n)
        vals = [int(np.int64(x) >> n) for x in xs]
        assert (got.lo, got.hi) == (min(vals), max(vals)), n
    got = a.neg()
    assert (got.lo, got.hi) == (-3, 5)
    got = a.clip(-2, 1)
    assert (got.lo, got.hi) == (-2, 1)


def test_interval_width_boundaries():
    assert Interval.const(I16 := 32767).bits_needed() == 16
    assert Interval.const(-32768).bits_needed() == 16
    assert Interval.const(I16 + 1).bits_needed() == 17
    assert Interval.of_width(16).fits(16)
    assert not Interval(-32769, 0).fits(16)
    assert Interval(0, 0).bits_needed() == 1
    assert Interval(-(2 ** 62), 2 ** 62).fits(64)
    assert not Interval(-(2 ** 63) - 1, 0).fits(64)


def test_matvec_bound_is_exact():
    w = np.array([[1, -2], [3, 4]], np.int64)
    v = Interval(-1, 5)
    got = Machine().matvec("t", w, v)
    best_hi = best_lo = None
    for v0 in (v.lo, v.hi):
        for v1 in (v.lo, v.hi):
            for row in w:
                val = int(row[0]) * v0 + int(row[1]) * v1
                best_hi = val if best_hi is None else max(best_hi, val)
                best_lo = val if best_lo is None else min(best_lo, val)
    assert (got.lo, got.hi) == (best_lo, best_hi)


def test_reference_q15_and_q7_proved_overflow_free(ref_targets):
    assert {t["name"] for t in ref_targets} == \
        {"reference-q15-s0", "reference-q7-s0"}
    for t in ref_targets:
        assert t["proved_overflow_free"], t["findings"]
        assert t["state_closed"]
        assert t["n_sites"] > 30
        assert t["saturation"]["reachable"] == ["gate.hf_clip", "h_next"]
        for s in t["sites"]:
            assert s["margin_bits"] >= 0, s


def test_acc_width_downgrade_detected(img):
    rec = analyze_image(img, Assumptions(widths={"acc": 32}))
    assert not rec["proved_overflow_free"]
    assert any(f["check"] == "q-acc-width" for f in rec["findings"])
    assert rec == j_analyze_image(JImage.from_bytes(img.to_bytes()),
                                  Assumptions(widths={"acc": 32}))


# ---------------------------------------------------------------------------
# qvm monitor: byte-identity + witnesses (tests/test_numerics.py)
# ---------------------------------------------------------------------------

def test_site_vocabulary_matches_qlint_classification(committed):
    lr = set(site_order(True))
    for t in committed["qlint"]["targets"]:
        sat = t["saturation"]
        assert set(sat["reachable"]) | set(sat["dead"]) <= lr
    assert "w.out" in site_order(False) and "w1.out" not in site_order(False)


def _monitored(img, windows, gain=1):
    """Monitored runs of the port's and the reference's qvm on the same
    image bytes and windows: (port monitor, reference monitor, logits)."""
    mon, jmon = NumericsMonitor(), JMonitor()
    x = np.asarray(windows, np.float32) * gain
    vm = QVM(img, monitor=mon)
    logits = vm.run_windows(vm.quantize_input(x))
    jvm = JQVM(JImage.from_bytes(img.to_bytes()), monitor=jmon)
    np.testing.assert_array_equal(jvm.run_windows(jvm.quantize_input(x)),
                                  logits)
    assert json.dumps(mon.snapshot(), sort_keys=True) == \
        json.dumps(jmon.snapshot(), sort_keys=True)
    return mon, jmon, logits


def test_monitored_qvm_byte_identical_and_clean_on_goldens(img, windows):
    vm = QVM(img)
    xq = vm.quantize_input(windows)
    logits, traces = vm.run_windows(xq, return_trajectory=True)
    mon = NumericsMonitor()
    mvm = QVM(img, monitor=mon)
    mxq = mvm.quantize_input(windows)
    np.testing.assert_array_equal(xq, mxq)
    mlogits, mtraces = mvm.run_windows(mxq, return_trajectory=True)
    np.testing.assert_array_equal(logits, mlogits)
    np.testing.assert_array_equal(traces, mtraces)
    snap = mon.snapshot()
    assert all(v == 0 for v in snap["sites"].values())
    assert snap["tensors"]["h"]["n"] > 0
    assert snap["tensors"]["x"]["n_over"] == 0
    _monitored(img, windows)                  # the reference's snapshot


def test_stress_gain_witnesses_h_next_saturation(img, windows):
    mon, _, _ = _monitored(img, windows, gain=STRESS)
    sites = mon.snapshot()["sites"]
    assert sites["h_next"] > 0
    assert sites["gate.hf_clip"] == 0
    dead = [s for s in sites if s not in ("h_next", "gate.hf_clip")]
    assert all(sites[s] == 0 for s in dead)


# ---------------------------------------------------------------------------
# C twin: exact counter parity
# ---------------------------------------------------------------------------

def test_c_counter_parity_with_qvm(img, windows, tmp_path, cc):
    vm = QVM(img)
    order = site_order(bool(img.low_rank))
    binary = emit_c.compile_host(img, str(tmp_path), engine="int",
                                 numeric_counters=True)
    cm = emit_c.CHostModel(binary, img.H, img.C, engine="int")
    for gain in (1, STRESS):
        xq = vm.quantize_input(np.asarray(windows, np.float32) * gain)
        mon = NumericsMonitor()
        q_logits = QVM(img, monitor=mon).run_windows(xq)
        q_counts = np.array([mon.snapshot()["sites"][s] for s in order],
                            np.uint64)
        c_preds, c_counts = cm.counters(xq)
        np.testing.assert_array_equal(
            c_preds, np.argmax(q_logits, axis=1).astype(np.int32))
        np.testing.assert_array_equal(c_counts, q_counts)
    assert c_counts[order.index("h_next")] > 0


def test_plain_c_build_refuses_counter_mode(img, windows, tmp_path, cc):
    vm = QVM(img)
    binary = emit_c.compile_host(img, str(tmp_path), engine="int")
    cm = emit_c.CHostModel(binary, img.H, img.C, engine="int")
    with pytest.raises(RuntimeError, match="FG_NUMERIC_COUNTERS"):
        cm.counters(vm.quantize_input(windows[:2]))


# ---------------------------------------------------------------------------
# Crosscheck gate + drift
# ---------------------------------------------------------------------------

def test_crosscheck_reference_images(img, windows, committed):
    target = target_by_name(committed, "reference-q15-s0")
    fresh = analyze_image(img, name="reference-q15-s0")
    assert fresh["saturation"] == target["saturation"]
    vm = QVM(img)
    for bits_target in (target, target_by_name(committed, "reference-q7-s0")):
        mon = NumericsMonitor()
        QVM(img, monitor=mon).run_windows(vm.quantize_input(windows))
        v = crosscheck(bits_target, mon.snapshot())
        assert v["ok"] and v["witnessed"] == []
        assert "h_next" in v["unwitnessed_reachable"]
    mon = NumericsMonitor()
    QVM(img, monitor=mon).run_windows(vm.quantize_input(
        np.asarray(windows, np.float32) * STRESS))
    v = crosscheck(target, mon.snapshot(), expect_nonzero=("h_next",))
    assert v["ok"] and v["witnessed"] == ["h_next"]


def test_crosscheck_flags_violations(committed):
    from repro.analysis import crosscheck as j_crosscheck
    target = target_by_name(committed, "reference-q15-s0")
    zeros = {s: 0 for s in site_order(True)}
    cases = (({"sites": {**zeros, "w1.out": 3}}, (), "dead"),
             ({"sites": {**zeros, "head.logits": 1}}, (), "never"),
             ({"sites": zeros}, ("h_next",), "witness"))
    for snap, expect, word in cases:
        v = crosscheck(target, snap, expect_nonzero=expect)
        assert not v["ok"] and word in v["violations"][0]
        assert v == j_crosscheck(target, snap, expect_nonzero=expect)
    with pytest.raises(KeyError):
        target_by_name({"qlint": {"targets": []}}, "nope")


def test_drift_score_monotone_under_gain(img, windows):
    scores = []
    for gain in (1, 2, 8):
        mon, jmon, _ = _monitored(img, windows[:8], gain=gain)
        assert mon.drift() == jmon.drift()
        scores.append(mon.drift())
    assert scores == sorted(scores) and scores[-1] > scores[0]


def test_verify_parity_report_carries_numerics(art, windows):
    from repro_torch.deploy.verify import quantized_paths_agree, run_parity
    report = run_parity(art, windows=windows[:8], n_scalar=2, n_trace=2,
                        use_fp32=False, device="cpu")
    if emit_c.find_cc():
        assert report["bitwise"]["c_int_qvm_counters"]
        assert report["bitwise"]["numerics_crosscheck"]
        assert report["numerics"]["crosscheck"]["ok"]
    assert quantized_paths_agree(report)
