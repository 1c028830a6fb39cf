"""Port parity, the compression passes: ``repro_torch.compress`` against the
reference ``repro.compress`` on the same numpy params.  Mirrors the
``deploy/``-free half of ``tests/test_compress.py`` (round trip, double
run, provenance, sparsify, low rank, loud ordering errors, the legacy
handoff, runtimes from the artifact, config loader, the CLI), holds the
``.fgar`` bytes to the reference's after every pass and every preset, and
the CLI's ``--emit-image`` ``.fgrn`` bytes to the reference CLI's."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.compress as J
import repro_torch.compress as P
from repro.core.qruntime import QRuntime as JRuntime
from repro.core.qruntime import calibrate_deploy as j_calibrate_deploy
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.quantization import quantize_params as j_quantize_params
from repro_torch.compress import (CalibrateActivations, IHTSparsify,
                                  LowRankFactor, ModelArtifact, PackLUT,
                                  Pipeline, QuantizePTQ,
                                  default_deploy_pipeline,
                                  pipeline_from_config, quantize_tree)
from repro_torch.core import fastgrnn as fg
from repro_torch.core import pipeline as pl
from repro_torch.core.qruntime import QRuntime, calibrate
from repro_torch.core.quantization import QuantConfig, quantize_params
from repro_torch.data import hapt
from torchharness import np_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(seed=0, low_rank=True):
    return np_params(seed, low_rank)


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def artifact():
    return default_deploy_pipeline(bits=15, device="cpu").run(
        ModelArtifact.from_params(_params()))


@pytest.fixture(scope="module")
def windows():
    return hapt.load("test", n=96).windows


# ---------------------------------------------------------------------------
# the same bytes as the reference, pass by pass and preset by preset
# ---------------------------------------------------------------------------

# pass chains over either package's module ``m``; ``d`` is the port's
# ``device="cpu"`` (empty for the reference, whose passes take none)
CHAINS = {
    "quantize_q15": lambda m, d: (m.QuantizePTQ(bits=15, **d),),
    "quantize_q7": lambda m, d: (m.QuantizePTQ(bits=7, **d),),
    "sparsify": lambda m, d: (m.IHTSparsify(sparsity=0.5, **d),),
    "sparsify_quantize": lambda m, d: (m.IHTSparsify(sparsity=0.25, **d),
                                       m.QuantizePTQ(bits=15, **d)),
    "calibrate_deploy": lambda m, d: (m.QuantizePTQ(bits=15, **d),
                                      m.CalibrateActivations(scope="deploy")),
    "calibrate_storage": lambda m, d: (
        m.QuantizePTQ(bits=15, **d), m.CalibrateActivations(scope="storage")),
    "calibrate_array": lambda m, d: (
        m.QuantizePTQ(bits=7, **d),
        m.CalibrateActivations(windows=hapt.load("val", n=3).windows,
                               headroom=0.2)),
    "pack_lut": lambda m, d: (m.PackLUT(),),
    "full": lambda m, d: (m.IHTSparsify(sparsity=0.5, **d),
                          m.QuantizePTQ(bits=15, **d),
                          m.CalibrateActivations(), m.PackLUT()),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("low_rank", [True, False])
def test_pass_bytes_equal_reference(chain, low_rank):
    p = _params(4, low_rank)
    got = ModelArtifact.from_params(p)
    want = J.ModelArtifact.from_params(p)
    for mine, ref in zip(CHAINS[chain](P, {"device": "cpu"}),
                         CHAINS[chain](J, {})):
        got, want = mine.apply(got), ref.apply(want)
        assert got.to_bytes() == want.to_bytes(), (chain, mine.name)


def test_low_rank_bytes_equal_reference_on_dense_checkpoint():
    p = _params(6, low_rank=False)
    pipe = (LowRankFactor(rank_w=2, rank_u=8), IHTSparsify(0.5, device="cpu"),
            QuantizePTQ(bits=15, device="cpu"), CalibrateActivations(),
            PackLUT())
    jpipe = (J.LowRankFactor(rank_w=2, rank_u=8), J.IHTSparsify(0.5),
             J.QuantizePTQ(bits=15), J.CalibrateActivations(), J.PackLUT())
    got, want = ModelArtifact.from_params(p), J.ModelArtifact.from_params(p)
    for mine, ref in zip(pipe, jpipe):
        got, want = mine.apply(got), ref.apply(want)
        assert got.to_bytes() == want.to_bytes(), mine.name


@pytest.mark.parametrize("preset", [dict(bits=15), dict(bits=7),
                                    dict(bits=15, sparsity=0.5)])
def test_presets_bytes_equal_reference(preset):
    p = _params(2)
    got = default_deploy_pipeline(device="cpu", **preset).run(
        ModelArtifact.from_params(p))
    want = J.default_deploy_pipeline(**preset).run(
        J.ModelArtifact.from_params(p))
    assert got.to_bytes() == want.to_bytes()
    assert got.sha256() == want.sha256()
    assert got.summary() == want.summary()
    # and either package reads the other's artifact back to the same bytes
    assert J.ModelArtifact.from_bytes(got.to_bytes()).to_bytes() == \
        got.to_bytes()


def test_device_is_not_provenance():
    """``device`` says where a pass computes, so it stays out of the
    config the artifact records (the reference's passes have none)."""
    assert "device" not in IHTSparsify(device="cpu").config()
    assert QuantizePTQ(device="cpu").config() == J.QuantizePTQ().config()
    assert IHTSparsify(device="cpu").config() == J.IHTSparsify().config()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_passes_raise_without_a_card():
    art = ModelArtifact.from_params(_params())
    with pytest.raises(RuntimeError, match="cuda"):
        QuantizePTQ().apply(art)
    with pytest.raises(RuntimeError, match="cuda"):
        IHTSparsify().apply(art)


# ---------------------------------------------------------------------------
# artifact lifecycle: round trip, determinism, provenance
# ---------------------------------------------------------------------------

def test_save_load_byte_identical_roundtrip(artifact, tmp_path):
    path = str(tmp_path / "model.fgar")
    blob = artifact.save(path)
    art2 = ModelArtifact.load(path)
    assert art2.to_bytes() == blob
    assert ModelArtifact.from_bytes(art2.to_bytes()).to_bytes() == blob
    assert art2.qp.bits == artifact.qp.bits
    for n in artifact.qp.q:
        np.testing.assert_array_equal(art2.qp.q[n].numpy(),
                                      artifact.qp.q[n].numpy())
        assert float(np.float32(art2.qp.scales[n])) == \
            float(np.float32(artifact.qp.scales[n]))
    assert art2.act_scales == artifact.act_scales
    assert art2.provenance == artifact.provenance
    for k in artifact.luts:
        np.testing.assert_array_equal(art2.luts[k], artifact.luts[k])


def test_pipeline_double_run_is_byte_identical():
    params = _params()
    pipe = default_deploy_pipeline(bits=15, device="cpu")
    a = pipe.run(ModelArtifact.from_params(params))
    b = pipe.run(ModelArtifact.from_params(params))
    assert a.to_bytes() == b.to_bytes()
    assert a.sha256() == b.sha256()


def test_provenance_records_every_pass(artifact):
    assert artifact.passes_applied() == [
        "source", "quantize_ptq", "calibrate_activations", "pack_lut"]
    recs = {r["pass"]: r for r in artifact.provenance}
    assert recs["source"]["metrics"]["param_count"] > 0
    qrec = recs["quantize_ptq"]
    assert qrec["metrics"]["q_format"] == "Q15"
    assert set(qrec["metrics"]["scales"]) == set(artifact.qp.scales)
    crec = recs["calibrate_activations"]
    assert crec["metrics"]["scope"] == "deploy"
    assert crec["metrics"]["scales"] == dict(sorted(artifact.act_scales.items()))
    assert crec["config"]["windows"] == "hapt:train:5"
    assert recs["pack_lut"]["metrics"]["lut_bytes"] == 2 * 256 * (4 + 2)


def test_sparsify_pass_records_masks_and_sparsity():
    art = Pipeline((IHTSparsify(sparsity=0.5, device="cpu"),
                    QuantizePTQ(bits=15, device="cpu"))).run(
        ModelArtifact.from_params(_params()))
    rec = [r for r in art.provenance if r["pass"] == "iht_sparsify"][0]
    assert rec["metrics"]["achieved_sparsity"] == pytest.approx(0.5, abs=0.02)
    for name in ("W1", "U1", "U2"):
        m = art.masks[name]
        assert m.dtype == bool
        assert not np.any(np.asarray(art.params[name])[~m])
        assert not np.any(art.qp.q[name].numpy()[~m])
    srep = art.size_report()
    assert srep["weight_sparsity"] > 0.3
    assert srep["weight_bytes_packed"] <= srep["weight_bytes_dense"]
    art2 = ModelArtifact.from_bytes(art.to_bytes())
    for name in ("W1", "U1"):
        assert art2.masks[name].dtype == bool
        np.testing.assert_array_equal(art2.masks[name], art.masks[name])


def test_low_rank_pass_factors_dense_checkpoint():
    art = LowRankFactor(rank_w=2, rank_u=8).apply(
        ModelArtifact.from_params(_params(low_rank=False)))
    assert set(art.params) >= {"W1", "W2", "U1", "U2"}
    assert "W" not in art.params and "U" not in art.params
    assert art.params["W1"].shape == (16, 2)
    assert art.params["U1"].shape == (16, 8)
    rec = art.provenance[-1]["metrics"]
    assert rec["rel_err_U"] < 1.0
    art2 = LowRankFactor().apply(ModelArtifact.from_params(_params()))
    assert art2.provenance[-1]["metrics"] == {"skipped": "already factored"}


def test_pass_ordering_errors_are_loud():
    art = ModelArtifact.from_params(_params())
    with pytest.raises(ValueError, match="QuantizePTQ"):
        CalibrateActivations().apply(art)
    with pytest.raises(ValueError, match="bits"):
        QuantizePTQ(bits=4, device="cpu").apply(art)
    with pytest.raises(ValueError, match="unknown pass"):
        pipeline_from_config([{"pass": "nope"}])
    with pytest.raises(ValueError, match="sparsity"):
        IHTSparsify(sparsity=1.0, device="cpu").apply(art)
    with pytest.raises(ValueError, match="scope"):
        CalibrateActivations(scope="nope").apply(
            QuantizePTQ(device="cpu").apply(art))
    with pytest.raises(ValueError, match="hapt"):
        CalibrateActivations(windows="hapt:test").apply(
            QuantizePTQ(device="cpu").apply(art))


# ---------------------------------------------------------------------------
# the legacy handoff and the runtimes consume the artifact
# ---------------------------------------------------------------------------

def test_artifact_path_matches_legacy_handoff_bitwise(artifact):
    """The passes reproduce the direct quantize_params + deploy-calibrate
    handoff, in the port and in the reference."""
    params = _params()
    qp = quantize_params(params, QuantConfig())
    calib = hapt.load("train", n=5).windows
    act = calibrate(QRuntime(qp), calib, deploy=True)
    jqp = j_quantize_params(params, JQuantConfig())
    jact = j_calibrate_deploy(JRuntime(jqp), calib)
    for n in qp.q:
        np.testing.assert_array_equal(qp.q[n].numpy(),
                                      artifact.qp.q[n].numpy())
        np.testing.assert_array_equal(np.asarray(jqp.q[n]),
                                      artifact.qp.q[n].numpy())
        assert float(np.float32(qp.scales[n])) == \
            float(np.float32(artifact.qp.scales[n]))
    assert {k: float(v) for k, v in act.items()} == artifact.act_scales
    assert {k: float(v) for k, v in jact.items()} == artifact.act_scales


def test_qruntime_from_artifact_bit_identical(artifact, windows):
    rt_art = QRuntime.from_artifact(artifact)
    rt_leg = QRuntime(artifact.qp)
    jrt = JRuntime.from_artifact(J.ModelArtifact.from_bytes(
        artifact.to_bytes()))
    for w in windows[:4]:
        a, ta = rt_art.run_window(w, return_trajectory=True)
        b, tb = rt_leg.run_window(w, return_trajectory=True)
        c, tc = jrt.run_window(w, return_trajectory=True)
        np.testing.assert_array_equal(bits(a), bits(b))
        np.testing.assert_array_equal(bits(ta), bits(tb))
        np.testing.assert_array_equal(bits(a), bits(c))
        np.testing.assert_array_equal(bits(ta), bits(tc))


def test_qruntime_from_artifact_storage_scales(windows):
    art = Pipeline((
        QuantizePTQ(bits=15, device="cpu"),
        CalibrateActivations(windows="hapt:train:5", scope="storage"),
    )).run(ModelArtifact.from_params(_params()))
    rt = QRuntime.from_artifact(art, quantized_acts=True)
    legacy = QRuntime(art.qp, act_scales=calibrate(
        QRuntime(art.qp), hapt.load("train", n=5).windows))
    np.testing.assert_array_equal(bits(rt.run_window(windows[0])),
                                  bits(legacy.run_window(windows[0])))
    art_deploy = default_deploy_pipeline(bits=15, device="cpu").run(
        ModelArtifact.from_params(_params()))
    with pytest.raises(ValueError, match="storage_scales"):
        QRuntime.from_artifact(art_deploy, quantized_acts=True)


def test_streaming_engine_from_artifact_bit_identical(artifact, windows):
    from repro_torch.serve.streaming import StreamingConfig, StreamingEngine
    eng = StreamingEngine.from_artifact(
        artifact, StreamingConfig(max_slots=8, device="cpu"))
    eng.attach("s", windows[0], total_steps=128, record_trajectory=True)
    events = eng.drain()
    rt = QRuntime.from_artifact(artifact)
    lg, traj = rt.run_window(windows[0], return_trajectory=True)
    np.testing.assert_array_equal(bits(events[-1].logits), bits(lg))
    np.testing.assert_array_equal(bits(eng.trajectory("s")), bits(traj))


def test_core_pipeline_deploy_matches_legacy(windows):
    """core.pipeline.deploy (on the pass API) is numerically identical to
    the direct handoff in all three activation modes, and to the
    reference's deploy."""
    from repro.core import pipeline as jpl
    params = _params()
    calib = hapt.load("train", n=5).windows
    qp = quantize_params(params, QuantConfig())
    legacy = {
        "fp32": QRuntime(qp),
        "naive": QRuntime(qp, naive_acts=True),
        "calibrated": QRuntime(qp, act_scales=calibrate(QRuntime(qp), calib)),
    }
    new = {
        "fp32": pl.deploy(params, calib, device="cpu"),
        "naive": pl.deploy(params, calib, naive_activations=True,
                           device="cpu"),
        "calibrated": pl.deploy(params, calib, quantize_activations=True,
                                device="cpu"),
    }
    ref = {
        "fp32": jpl.deploy(params, calib),
        "naive": jpl.deploy(params, calib, naive_activations=True),
        "calibrated": jpl.deploy(params, calib, quantize_activations=True),
    }
    for mode in legacy:
        got = new[mode].run_window(windows[0])
        np.testing.assert_array_equal(
            bits(got), bits(legacy[mode].run_window(windows[0])), err_msg=mode)
        np.testing.assert_array_equal(
            bits(got), bits(ref[mode].run_window(windows[0])), err_msg=mode)


def test_quantize_tree_accepts_q_format_names():
    w = {"w": torch.linspace(-2, 2, 8).reshape(2, 4)}
    for alias, width in ((7, torch.int8), (8, torch.int8), (15, torch.int16),
                         (16, torch.int16)):
        qt, _ = quantize_tree(w, alias)
        assert qt["w"].dtype == width


# ---------------------------------------------------------------------------
# config loader + CLI
# ---------------------------------------------------------------------------

def test_pipeline_from_config_roundtrip():
    cfg = {"name": "custom", "passes": [
        {"pass": "iht_sparsify", "sparsity": 0.25},
        {"pass": "quantize_ptq", "bits": 7},
        {"pass": "calibrate_activations", "windows": "hapt:train:2",
         "scope": "deploy"},
        {"pass": "pack_lut"},
    ]}
    pipe = pipeline_from_config(cfg, device="cpu")
    assert pipe.name == "custom"
    art = pipe.run(ModelArtifact.from_params(_params()))
    assert art.qp.bits == 8 and art.bits == 8
    assert art.passes_applied() == ["source", "iht_sparsify", "quantize_ptq",
                                    "calibrate_activations", "pack_lut"]
    want = J.pipeline_from_config(cfg).run(J.ModelArtifact.from_params(
        _params()))
    assert art.to_bytes() == want.to_bytes()
    assert pipe.describe() == J.pipeline_from_config(cfg).describe()


def _cli(args, tmp_path, module="repro_torch.compress"):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_cli_emits_deterministic_artifact_and_valid_report(tmp_path):
    """Two CLI runs with ``--device cpu`` give byte-identical artifacts,
    and the report validates under the benchmarks schema."""
    outs = []
    for i in (1, 2):
        a, r = str(tmp_path / f"a{i}.fgar"), str(tmp_path / f"r{i}.json")
        res = _cli(["--preset", "q15-deploy", "--device", "cpu",
                    "--out", a, "--report", r], tmp_path)
        assert res.returncode == 0, res.stderr
        outs.append((a, r))
    blobs = [open(a, "rb").read() for a, _ in outs]
    assert blobs[0] == blobs[1]
    report = json.load(open(outs[0][1]))
    assert report["benchmark"] == "compress_artifact"
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmarks.validate_bench import validate
    kind, errors = validate(outs[0][1])
    assert kind == "compress_artifact" and errors == [], errors
    art = ModelArtifact.load(outs[0][0])
    assert report["sha256"] == art.sha256()


def test_cli_with_params_matches_reference_cli(tmp_path):
    """From the same ``--params`` checkpoint the port's CLI writes the
    reference CLI's bytes."""
    ckpt = str(tmp_path / "ckpt.npz")
    np.savez(ckpt, **_params(8))
    blobs = []
    for module, extra in (("repro_torch.compress", ["--device", "cpu"]),
                          ("repro.compress", [])):
        out = str(tmp_path / f"{module}.fgar")
        res = _cli(["--preset", "q15-sparse-deploy", "--params", ckpt,
                    "--out", out, *extra], tmp_path, module)
        assert res.returncode == 0, res.stderr
        blobs.append(open(out, "rb").read())
    assert blobs[0] == blobs[1]


def test_cli_default_init_is_a_torch_generator_draw(tmp_path):
    """Deliberate divergence (ROADMAP Queue C): without ``--params`` the
    CLI's checkpoint is ``init_params`` from a CPU ``torch.Generator``
    seeded ``--seed``, not the reference's threefry draw."""
    from repro_torch.compress.__main__ import _load_params, main
    out = str(tmp_path / "a.fgar")
    assert main(["--preset", "q15-deploy", "--device", "cpu", "--seed", "3",
                 "--out", out]) == 0
    art = ModelArtifact.load(out)
    want = fg.init_params(fg.FastGRNNConfig(rank_w=2, rank_u=8),
                          torch.Generator().manual_seed(3))
    for k, v in want.items():
        np.testing.assert_array_equal(art.params[k], v.numpy())
    args = type("A", (), dict(params=None, rank_w=0, rank_u=0, seed=3))
    assert "W" in _load_params(args) and "U" in _load_params(args)


@pytest.mark.parametrize("preset", ["q15-deploy", "q7-deploy"])
def test_cli_emit_image_matches_reference_cli(tmp_path, preset):
    """From the same ``--params`` checkpoint the port CLI's
    ``--emit-image`` writes the reference CLI's ``.fgrn`` bytes."""
    ckpt = str(tmp_path / "ckpt.npz")
    np.savez(ckpt, **_params(5))
    blobs = []
    for module, extra in (("repro_torch.compress", ["--device", "cpu"]),
                          ("repro.compress", [])):
        out = str(tmp_path / f"{module}.fgrn")
        res = _cli(["--preset", preset, "--params", ckpt,
                    "--emit-image", out, *extra], tmp_path, module)
        assert res.returncode == 0, res.stderr
        blobs.append(open(out, "rb").read())
    assert blobs[0] == blobs[1]
    assert len(blobs[0]) == 4076
