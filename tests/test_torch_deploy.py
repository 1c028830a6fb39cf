"""Port parity, the deploy path: ``repro_torch.deploy`` against the
reference ``repro.deploy`` on the same carried-across params.

Mirrors ``tests/test_deploy.py`` one for one (image round trip and
determinism, budgets, the qvm's integer-only hot loop and saturation,
requant precision, emitted C against both twins, the golden fixture, the
trajectory taps; the full Sec. VI-B protocol is in
``tests/test_torch_deploy_protocol.py``) and adds the cross-package
checks: the image bytes, the emitted C sources, the qvm's outputs and
plan and the whole ``run_parity`` report equal to the reference's.  The
reference's params are built under ``threefry_partitionable(False)``
(ROADMAP C0), so the mirrors of its three C0-failing tests pass here.
"""
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro.deploy import emit_c as jemit
from repro.deploy import goldens as JG
from repro.deploy import verify as JV
from repro.deploy.image import DeployImage as JImage
from repro.deploy.image import build_image as j_build_image
from repro.deploy.qvm import QVM as JQVM
from repro.deploy.qvm import plan_from_image as j_plan_from_image
from repro_torch import weights
from repro_torch.core import fastgrnn as fg
from repro_torch.core.qruntime import QRuntime
from repro_torch.data import hapt
from repro_torch.deploy import (QVM, DeployImage, audit_platforms,
                                build_reference_model, size_report)
from repro_torch.deploy import emit_c, verify
from repro_torch.deploy import goldens as G
from repro_torch.deploy.image import build_image, export_model
from repro_torch.deploy.qvm import (FINE_CLIP, I16_MAX, I16_MIN,
                                    plan_from_image, quantize_multiplier)
from torchharness import reference_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens", "qvm_reference_s0.npz")
GOLDEN_SHA = "0c105e9b"


@pytest.fixture(scope="module")
def ref_params():
    """The reference's seed-0 low-rank init (threefry, C0) as NumPy."""
    return reference_init()


@pytest.fixture(scope="module")
def arts(ref_params):
    """(port, reference) artifacts of the same carried-across params."""
    port = G.build_reference_artifact(
        params=weights.params_from_numpy(ref_params), device="cpu")
    return port, JG.build_reference_artifact(params=ref_params)


@pytest.fixture(scope="module")
def model(arts):
    art = arts[0]
    return art.qp, dict(art.act_scales), build_image(art)


@pytest.fixture(scope="module")
def q7_images(ref_params):
    """(port, reference) Q7 images of the same params."""
    port = G.build_reference_artifact(
        params=weights.params_from_numpy(ref_params), bits=7, device="cpu")
    ref = JG.build_reference_artifact(params=ref_params, bits=7)
    return build_image(port), j_build_image(ref)


@pytest.fixture(scope="module")
def windows():
    return hapt.load("test", n=96).windows


@pytest.fixture
def cc():
    if emit_c.find_cc() is None:
        pytest.skip("no C compiler")


# ---------------------------------------------------------------------------
# Image: round-trip, determinism, budgets
# ---------------------------------------------------------------------------

def test_image_roundtrip(model):
    _, _, img = model
    blob = img.to_bytes()
    img2 = DeployImage.from_bytes(blob)
    assert img2.to_bytes() == blob
    assert img2.tensor_order() == img.tensor_order()
    for n in img.tensor_order():
        np.testing.assert_array_equal(img2.q[n], img.q[n])
    assert img2.act_scales == img.act_scales
    np.testing.assert_array_equal(img2.sig_lut, img.sig_lut)
    np.testing.assert_array_equal(img2.sig_lut_f32, img.sig_lut_f32)


def test_double_export_byte_identical(model, ref_params):
    """Two independent port exports of the same checkpoint give the same
    image and the same emitted C, and both are the reference's."""
    _, _, img1 = model
    _, _, img2 = build_reference_model(
        params=weights.params_from_numpy(ref_params), device="cpu")
    _, _, jimg = JG.build_reference_model(params=ref_params)
    assert img1.to_bytes() == img2.to_bytes() == jimg.to_bytes()
    for engine in ("float", "int"):
        s1 = emit_c.generate_sources(img1, "host", engine)
        s2 = emit_c.generate_sources(img2, "host", engine)
        assert s1 == s2


def test_budget_audit_avr_and_msp430(model):
    _, _, img = model
    rep = size_report(img)
    assert rep["weight_bytes"] < 1024
    assert rep["lut_bytes"]["float_engine"] == 2048   # paper: "2 KB of Flash"
    assert rep["lut_bytes"]["int_engine"] == 1024
    for engine in ("float", "int"):
        audit = audit_platforms(img, ("avr", "msp430"), engine=engine)
        for key in ("avr", "msp430"):
            assert audit[key]["fits"], (engine, key, audit[key])
            assert audit[key]["flash_headroom"] > 0
            assert audit[key]["sram_headroom"] > 0
    assert img.sram_needed("float") <= 512
    assert img.sram_needed("int") <= 512


def test_image_rejects_plain_calibration(model):
    """Scales from the non-deploy calibrate() miss the input/intermediate
    entries the integer engine needs — export must fail loudly."""
    from repro_torch.compress import ModelArtifact
    from repro_torch.core.qruntime import calibrate
    qp, _, _ = model
    bad = calibrate(QRuntime(qp), hapt.load("train", n=2).windows)
    with pytest.raises(ValueError, match="deploy=True"):
        build_image(ModelArtifact(qp=qp, act_scales=dict(bad)))
    with pytest.raises(TypeError, match="ModelArtifact"):
        build_image(qp)


# ---------------------------------------------------------------------------
# qvm: integer-only hot loop, saturation property
# ---------------------------------------------------------------------------

def test_qvm_hot_loop_is_integer_only(model):
    _, _, img = model
    vm = QVM(img)
    for name, w in vm.plan.w.items():
        assert np.issubdtype(w.dtype, np.integer), name
    for arr in (vm.plan.bz_q, vm.plan.bh_q, vm.plan.headb_q,
                vm.plan.sig_lut, vm.plan.tanh_lut):
        assert np.issubdtype(arr.dtype, np.integer)
    xq = vm.quantize_input(hapt.load("test", n=2).windows)
    hq = vm.init_state(2)
    assert hq.dtype == np.int16
    h1 = vm.step(hq, xq[:, 0])
    assert h1.dtype == np.int16
    assert vm.logits(h1).dtype == np.int32


def test_qvm_saturation_never_wraps(model):
    """Extreme inputs saturate the int16 state, never wrap (the
    reference's seeded sweep)."""
    _, _, img = model
    vm = QVM(img)
    rng = np.random.default_rng(0)
    B, T = 64, 40
    d = vm.plan.d
    extremes = np.array([I16_MIN, I16_MAX, 0, 1, -1], np.int16)
    xq = rng.choice(extremes, size=(B, T, d)).astype(np.int16)
    xq[0] = I16_MAX
    xq[1] = I16_MIN
    xq[2, :, :] = rng.integers(I16_MIN, I16_MAX + 1, (T, d))
    _, traj = vm.run_windows(xq, return_trajectory=True)
    assert traj.dtype == np.int16
    assert traj.min() >= I16_MIN and traj.max() <= I16_MAX
    hq = np.full((B, vm.plan.H), I16_MAX, np.int16)
    for t in range(5):
        hq = vm.step(hq, xq[:, t])
        assert hq.dtype == np.int16
        assert hq.min() >= I16_MIN and hq.max() <= I16_MAX
    # the same sweep through the reference's qvm on the same bytes: bitwise
    _, jtraj = JQVM(JImage.from_bytes(img.to_bytes())).run_windows(
        xq, return_trajectory=True)
    np.testing.assert_array_equal(traj, jtraj)


def test_quantize_multiplier_precision_and_bounds():
    rng = np.random.default_rng(1)
    for _ in range(200):
        f = float(10.0 ** rng.uniform(-9, 4))
        rq = quantize_multiplier(f)
        assert 0 <= rq.m < (1 << 25)
        assert 1 <= rq.sh <= 62
        got = rq.m * 2.0 ** (rq.pre - rq.sh)
        assert abs(got - f) / f < 2 ** -24 or rq.m == 0
    rq = quantize_multiplier(1e-3, acc_bits=50)
    assert rq.pre == 13
    rq = quantize_multiplier(1e-3, acc_bits=41)
    acc = np.int64(1 << 40)
    assert abs(int(rq.apply(acc)) - 1e-3 * 2 ** 40) <= 2 ** 18
    big = quantize_multiplier(1.0, acc_bits=50).apply(np.int64(1 << 49))
    assert int(big) == (1 << 31) - 1
    assert int(quantize_multiplier(1.0, acc_bits=50)
               .apply(np.int64(-(1 << 49)))) == -(1 << 31)


def test_fine_clip_headroom():
    assert FINE_CLIP == (1 << 29) - 1
    assert 2 * (FINE_CLIP + 1) + (1 << 24) < 2 ** 31


# ---------------------------------------------------------------------------
# Parity: qvm vs oracle (subset); emitted C vs both twins
# ---------------------------------------------------------------------------

def test_qvm_argmax_matches_oracle_on_confident_windows(model, windows):
    """On windows with a real float margin the integer path agrees with
    the oracle exactly (random init carries near-tie windows)."""
    qp, _, img = model
    vm = QVM(img)
    xq = vm.quantize_input(windows)
    xdeq = vm.dequantize_input(xq)
    preds = np.argmax(vm.run_windows(xq), axis=1)
    rt = QRuntime(qp)
    ref_lg = np.stack([rt.run_window(w) for w in xdeq])
    ref = np.argmax(ref_lg, axis=1)
    srt = np.sort(ref_lg, axis=1)
    margin = srt[:, -1] - srt[:, -2]
    confident = margin > 5e-3
    assert confident.sum() > len(windows) // 3
    np.testing.assert_array_equal(preds[confident], ref[confident])
    assert float(np.mean(preds == ref)) >= 0.97


def test_emitted_float_c_bit_identical_to_oracle(model, windows, cc):
    """Paper contribution (i): the float-engine C compiled with
    cc -ffp-contract=off reproduces the port's oracle bit for bit."""
    qp, _, img = model
    vm = QVM(img)
    xq = vm.quantize_input(windows[:24])
    xdeq = vm.dequantize_input(xq)
    with tempfile.TemporaryDirectory() as td:
        binary = emit_c.compile_host(img, td, engine="float")
        cm = emit_c.CHostModel(binary, img.H, img.C, engine="float")
        traces, logits, preds = cm.trace(xq)
    rt = QRuntime(qp)
    ref = [rt.run_window(w, return_trajectory=True) for w in xdeq]
    ref_lg = np.stack([r[0] for r in ref]).astype(np.float32)
    ref_tr = np.stack([r[1] for r in ref]).astype(np.float32)
    np.testing.assert_array_equal(logits.view(np.int32), ref_lg.view(np.int32))
    np.testing.assert_array_equal(traces.view(np.int32), ref_tr.view(np.int32))
    np.testing.assert_array_equal(preds, np.argmax(ref_lg, axis=1))


def test_emitted_int_c_bit_identical_to_qvm(model, windows, cc):
    _, _, img = model
    vm = QVM(img)
    xq = vm.quantize_input(windows[:24])
    lg, traces = vm.run_windows(xq, return_trajectory=True)
    with tempfile.TemporaryDirectory() as td:
        binary = emit_c.compile_host(img, td, engine="int")
        cm = emit_c.CHostModel(binary, img.H, img.C, engine="int")
        ctr, clg, cpred = cm.trace(xq)
    np.testing.assert_array_equal(ctr, traces)
    np.testing.assert_array_equal(clg, lg)
    np.testing.assert_array_equal(cpred, np.argmax(lg, axis=1))


def test_int_c_parity_survives_requant_saturation(model, cc):
    """A pathologically small calibrated h scale with full-scale inputs
    drives the gate requant past int32: the C saturates exactly like the
    emulator."""
    from repro_torch.compress import ModelArtifact
    qp, act_scales, _ = model
    tiny = dict(act_scales)
    tiny["h"] = float(np.float32(0.001 * 1.1 / 32767))
    img = build_image(ModelArtifact(qp=qp, act_scales=tiny))
    vm = QVM(img)
    xq = np.full((4, 16, img.d), I16_MAX, np.int16)
    xq[1] = I16_MIN
    xq[2, ::2] = I16_MIN
    lg, traces = vm.run_windows(xq, return_trajectory=True)
    assert np.abs(traces).max() == -I16_MIN or np.abs(traces).max() <= I16_MAX
    with tempfile.TemporaryDirectory() as td:
        binary = emit_c.compile_host(img, td, engine="int")
        cm = emit_c.CHostModel(binary, img.H, img.C, engine="int")
        ctr, clg, _ = cm.trace(xq)
    np.testing.assert_array_equal(ctr, traces)
    np.testing.assert_array_equal(clg, lg)


def test_streaming_ring_spill_bounded_memory(model, windows):
    """One stream fed far past max_ring_capacity spills to a per-slot
    queue and still replays bit-exactly (the port's engine on the CPU)."""
    from repro_torch.serve.streaming import StreamingConfig, StreamingEngine
    qp, _, _ = model
    cfg = StreamingConfig(max_slots=4, ring_capacity=32, max_ring_capacity=64,
                          device="cpu")
    eng = StreamingEngine(qp, cfg)
    long_stream = np.concatenate([windows[0], windows[1]])
    eng.attach("s", long_stream, total_steps=len(long_stream))
    assert eng._cap <= 64 and 0 in eng._spill
    events = eng.drain()
    assert [e.kind for e in events] == ["window", "window"]
    rt = QRuntime(qp)
    np.testing.assert_array_equal(
        events[0].logits.view(np.int32),
        rt.run_window(windows[0]).view(np.int32))
    np.testing.assert_array_equal(
        events[1].logits.view(np.int32),
        rt.run_window(windows[1]).view(np.int32))
    assert not eng._spill


def test_avr_and_msp430_sources_emit(model):
    """Non-host targets carry no driver and gate flash reads per target."""
    _, _, img = model
    for target in ("avr", "msp430"):
        for engine in ("float", "int"):
            src = emit_c.generate_sources(img, target, engine)
            assert set(src) == {"fastgrnn_model.h", "fastgrnn_cell.c"}
            assert f"FASTGRNN_TARGET_{target.upper()}" in src["fastgrnn_model.h"]
            assert "#include <math.h>" not in src["fastgrnn_cell.c"]
    avr = emit_c.generate_sources(img, "avr", "float")["fastgrnn_model.h"]
    assert "PROGMEM" in avr and "pgm_read" in avr


# ---------------------------------------------------------------------------
# Goldens: the reference's committed fixture, read and never written
# ---------------------------------------------------------------------------

def test_golden_fixture_replays_bit_identical():
    """The port's image from the fixture's bytes and its qvm reproduce
    the fixture's traces, logits and predictions."""
    g = G.load_goldens(GOLDEN_PATH)
    img = DeployImage.from_bytes(bytes(np.asarray(g["image_bytes"],
                                                  np.uint8)))
    vm = QVM(img)
    lg, traces = vm.run_windows(g["xq"][:g["traces"].shape[0]],
                                return_trajectory=True)
    np.testing.assert_array_equal(traces, g["traces"])
    np.testing.assert_array_equal(lg, g["trace_logits"])
    all_lg = vm.run_windows(g["xq"])
    np.testing.assert_array_equal(all_lg, g["logits"])
    np.testing.assert_array_equal(np.argmax(all_lg, axis=1), g["preds"])


def test_golden_fixture_matches_current_export(model):
    """The port's build_image of the carried-across reference artifact is
    the fixture's 4,076-byte image (sha256 0c105e9b...)."""
    _, _, img = model
    g = G.load_goldens(GOLDEN_PATH)
    blob = img.to_bytes()
    assert bytes(np.asarray(g["image_bytes"], np.uint8)) == blob
    assert len(blob) == 4076
    assert hashlib.sha256(blob).hexdigest().startswith(GOLDEN_SHA)
    assert g["image_sha256"] == hashlib.sha256(blob).hexdigest()


def test_default_fixture_equals_committed_goldens(model):
    """``goldens.generate_goldens`` on the carried-across image and the
    fixture's windows gives every array of the committed fixture,
    bitwise."""
    g = G.load_goldens(GOLDEN_PATH)
    mine = G.generate_goldens(model[2],
                              hapt.load("test", n=G.N_WINDOWS).windows)
    assert set(mine) == set(g)
    for k in g:
        if k == "image_sha256":
            assert mine[k] == g[k]
        else:
            np.testing.assert_array_equal(mine[k], g[k], err_msg=k)


def test_goldens_cli_never_writes_reference_fixtures(tmp_path):
    """Deliberate divergence (ROADMAP Queue C): the port's goldens CLI
    refuses an ``--out`` inside ``tests/goldens`` and by default writes
    under the gitignored ``src/repro_torch/_build``."""
    before = {f: os.path.getmtime(os.path.join(REPO, "tests", "goldens", f))
              for f in os.listdir(os.path.join(REPO, "tests", "goldens"))}
    for out in (os.path.join(REPO, "tests", "goldens"),
                os.path.join(REPO, "tests", "goldens", "sub"),
                os.path.join(REPO, "tests", ".", "goldens")):
        with pytest.raises(SystemExit):
            G.main(["--out", out, "--device", "cpu"])
    after = {f: os.path.getmtime(os.path.join(REPO, "tests", "goldens", f))
             for f in os.listdir(os.path.join(REPO, "tests", "goldens"))}
    assert before == after
    assert G.DEFAULT_OUT.startswith(os.path.join(REPO, "src", "repro_torch",
                                                 "_build"))
    G.main(["--out", str(tmp_path), "--device", "cpu", "--seed", "1"])
    G.main(["--out", str(tmp_path), "--device", "cpu", "--seed", "1",
            "--check"])
    assert os.listdir(tmp_path) == ["qvm_reference_s1.npz"]


def test_default_init_is_a_torch_generator_draw():
    """Deliberate divergence (ROADMAP Queue C): without ``params`` the
    reference artifact's init is ``init_params`` from a CPU
    ``torch.Generator`` seeded ``seed``, not the reference's threefry."""
    art = G.build_reference_artifact(seed=3, device="cpu")
    want = fg.init_params(fg.FastGRNNConfig(rank_w=2, rank_u=8),
                          torch.Generator().manual_seed(3))
    for k, v in want.items():
        np.testing.assert_array_equal(art.params[k], v.numpy())


# ---------------------------------------------------------------------------
# Streaming trajectory taps (parity plumbing)
# ---------------------------------------------------------------------------

def test_streaming_trajectory_tap_bit_identical(model, windows):
    from repro_torch.serve.streaming import StreamingConfig, StreamingEngine
    qp, _, _ = model
    eng = StreamingEngine(qp, StreamingConfig(max_slots=4, device="cpu"))
    eng.attach("s", windows[0], total_steps=128, record_trajectory=True)
    eng.drain()
    traj = eng.trajectory("s")
    _, ref = QRuntime(qp).run_window(windows[0], return_trajectory=True)
    np.testing.assert_array_equal(traj.view(np.int32), ref.view(np.int32))
    with pytest.raises(KeyError):
        eng.trajectory("untapped")


# ---------------------------------------------------------------------------
# Cross-package: emitted C, qvm, plan, the whole parity report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [15, 7])
def test_emitted_sources_byte_identical_to_reference(arts, q7_images, bits):
    """Every target x engine's sources equal the reference's, Q15 and Q7."""
    if bits == 15:
        img, jimg = build_image(arts[0]), j_build_image(arts[1])
    else:
        img, jimg = q7_images
    assert img.to_bytes() == jimg.to_bytes()
    for target in ("avr", "msp430", "host"):
        for engine in ("float", "int"):
            assert emit_c.generate_sources(img, target, engine) == \
                jemit.generate_sources(jimg, target, engine), (target, engine)


def test_counter_build_identical_to_reference(model, windows, cc):
    """The ``-DFG_NUMERIC_COUNTERS`` build: the files each package writes
    for it are byte-identical, and the two binaries give the same
    predictions and counters."""
    _, _, img = model
    jimg = JImage.from_bytes(img.to_bytes())
    xq = QVM(img).quantize_input(np.asarray(windows[:16], np.float32) * 8)
    with tempfile.TemporaryDirectory() as td:
        bins = [mod.compile_host(im, os.path.join(td, name), engine="int",
                                 numeric_counters=True)
                for mod, im, name in ((emit_c, img, "port"),
                                      (jemit, jimg, "ref"))]
        for f in ("fastgrnn_model.h", "fastgrnn_cell.c", "fastgrnn_main.c"):
            a = open(os.path.join(td, "port", f)).read()
            assert a == open(os.path.join(td, "ref", f)).read(), f
        outs = [emit_c.CHostModel(b, img.H, img.C, engine="int").counters(xq)
                for b in bins]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][1].sum() > 0                    # the stress is witnessed


def _plain(v):
    """A plan field with each package's ``Requant`` as its (m, sh, pre)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if hasattr(v, "sh"):
        return (v.m, v.sh, v.pre)
    return v


@pytest.mark.parametrize("bits", [15, 7])
def test_qvm_and_plan_bitwise_reference(arts, q7_images, windows, bits):
    """``plan_from_image`` gives the reference's plan, and
    ``QVM.run_windows`` its logits and trajectories, bit for bit."""
    if bits == 15:
        img, jimg = build_image(arts[0]), j_build_image(arts[1])
    else:
        img, jimg = q7_images
    p, jp = plan_from_image(img), j_plan_from_image(jimg)
    for f in p.__dataclass_fields__:
        a, b = _plain(getattr(p, f)), _plain(getattr(jp, f))
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f
            pairs = [(a[k], b[k]) for k in a]
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f)
                assert x.dtype == y.dtype, f
            else:
                assert x == y and type(x) is type(y), f
    vm, jvm = QVM(img), JQVM(jimg)
    xq = vm.quantize_input(windows)
    np.testing.assert_array_equal(xq, jvm.quantize_input(windows))
    np.testing.assert_array_equal(vm.dequantize_input(xq),
                                  jvm.dequantize_input(xq))
    lg, tr = vm.run_windows(xq, return_trajectory=True)
    jlg, jtr = jvm.run_windows(xq, return_trajectory=True)
    np.testing.assert_array_equal(lg, jlg)
    np.testing.assert_array_equal(tr, jtr)
    assert lg.dtype == jlg.dtype and tr.dtype == jtr.dtype
    np.testing.assert_array_equal(vm.predict_batch(windows),
                                  jvm.predict_batch(windows))
    assert vm.stats() == jvm.stats()


def test_run_parity_report_equals_reference(arts, windows, cc):
    """On one image and 96 windows, with C on, the port's report equals
    the reference's on every key but the timings."""
    report = verify.run_parity(arts[0], windows=windows, device="cpu")
    jreport = JV.run_parity(arts[1], windows=windows)
    assert {"c_float", "c_int", "fp32"} <= set(report["paths"])
    assert set(report) == set(jreport)
    for k in report:
        if k in ("timings_s", "total_s"):
            assert set(report[k] if k == "timings_s" else {}) == \
                set(jreport[k] if k == "timings_s" else {})
            continue
        assert report[k] == jreport[k], k
    assert all(report["bitwise"].values())
    assert verify.quantized_paths_agree(report) == \
        JV.quantized_paths_agree(jreport)


def test_export_model_writes_the_image(arts, tmp_path):
    path = str(tmp_path / "m.fgrn")
    img, blob = export_model(arts[0], path)
    assert open(path, "rb").read() == blob == img.to_bytes()
    assert DeployImage.from_bytes(blob).to_bytes() == blob


def test_run_parity_on_cuda_raises_without_a_card(arts, windows):
    """The card path has no CPU fallback: asked for ``cuda`` without a
    card, ``run_parity`` raises before running any path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card path is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        verify.run_parity(arts[0], windows=windows[:4])
    with pytest.raises(RuntimeError, match="cuda"):
        verify.run_parity(arts[0], windows=windows[:4], device="cuda")


def test_verify_cli_on_the_cpu():
    """``python -m repro_torch.deploy.verify --device cpu --windows 8``
    prints a report whose quantized paths agree."""
    import json
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.deploy.verify",
                          "--device", "cpu", "--windows", "8", "--strict"],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout)
    assert report["model"] == "random-init" and report["n_windows"] == 8
    assert report["quantized_paths_100pct"] is True
