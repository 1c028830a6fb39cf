"""Port parity, foundation: LUT tables, Q15 PTQ, the ``.fgar`` artifact and
the scalar C-equivalent runtime of ``repro_torch`` against the reference
JAX package, on the same numpy inputs (never ``jax.random``)."""
import numpy as np
import pytest
import torch

from repro.compress import (CalibrateActivations, ModelArtifact as JArtifact,
                            PackLUT, Pipeline, QuantizePTQ)
from repro.core import lut as jlut
from repro.core import qruntime as jqr
from repro.core import quantization as jq
from repro.data import hapt as jhapt
from repro_torch import weights
from repro_torch.compress import ModelArtifact
from repro_torch.core import lut, qruntime, quantization as q
from repro_torch.data import hapt


def np_params(seed, low_rank=True, H=16, d=3, C=6):
    """Float params at the paper's shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    m = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    p = ({"W1": m(H, 2), "W2": m(d, 2), "U1": m(H, 8), "U2": m(H, 8)}
         if low_rank else {"W": m(H, d), "U": m(H, H)})
    p.update(b_z=(1 + 0.3 * rng.standard_normal(H)).astype(np.float32),
             b_h=(0.3 * rng.standard_normal(H)).astype(np.float32),
             zeta=np.float32(1.0), nu=np.float32(-4.0), head_w=m(H, C),
             head_b=(0.1 * rng.standard_normal(C)).astype(np.float32))
    return p


def as_bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ---- LUT ------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["sigmoid", "tanh"])
def test_make_lut_bitwise(fn):
    # bitwise: both build the table in float64 numpy and cast to float32
    np.testing.assert_array_equal(as_bits(lut.make_lut(fn).numpy()),
                                  as_bits(jlut.make_lut(fn)))


# ---- quantization ---------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("low_rank", [True, False])
def test_quantize_params_bitwise(low_rank, bits):
    p = np_params(3, low_rank)
    p["W" if not low_rank else "W1"][0, 0] = 0.0   # an exact zero survives
    got = q.quantize_params(p, q.QuantConfig(bits=bits))
    ref = jq.quantize_params(p, jq.QuantConfig(bits=bits))
    assert sorted(got.q) == sorted(ref.q) and sorted(got.fp) == sorted(ref.fp)
    for k in ref.q:
        # bitwise: f32 amax/qmax, half-even round and clip on both sides
        assert got.q[k].numpy().dtype == np.asarray(ref.q[k]).dtype
        np.testing.assert_array_equal(got.q[k].numpy(), np.asarray(ref.q[k]))
        assert np.float32(got.scales[k]) == np.float32(ref.scales[k])
    for k in ref.fp:
        np.testing.assert_array_equal(as_bits(got.fp[k].numpy()),
                                      as_bits(ref.fp[k]))
    assert got.tensor_order() == ref.tensor_order()


def test_quantize_all_zero_tensor_uses_unit_scale():
    p = {"W": np.zeros((4, 3), np.float32)}
    got = q.quantize_params(p, q.QuantConfig())
    ref = jq.quantize_params(p, jq.QuantConfig())
    assert np.float32(got.scales["W"]) == np.float32(ref.scales["W"])
    assert not got.q["W"].any()



@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("low_rank", [True, False])
def test_dequantize_nbytes_nonzero_match_reference(low_rank, bits):
    p = np_params(7, low_rank)
    got = q.quantize_params(p, q.QuantConfig(bits=bits))
    ref = jq.quantize_params(p, jq.QuantConfig(bits=bits))
    deq, jdeq = got.dequantize(), ref.dequantize()
    assert sorted(deq) == sorted(jdeq)
    for k in jdeq:
        # bitwise: one float32 multiply float32(q) * scale on both sides
        assert deq[k].dtype == torch.float32
        np.testing.assert_array_equal(as_bits(deq[k].numpy()),
                                      as_bits(jdeq[k]))
    assert got.nbytes() == ref.nbytes()
    assert got.nonzero() == ref.nonzero()


def test_dequantize_matches_step_weights_on_an_artifact():
    """The window path's params come from ``art.qp.dequantize()``: bitwise
    the reference's and the batched step's dequantized weights."""
    from repro_torch.kernels.fastgrnn_cell.qstep import StepWeights
    ref = _jax_artifact(True)
    art = ModelArtifact.from_bytes(ref.to_bytes())
    deq, jdeq = art.require_qp().dequantize(), ref.qp.dequantize()
    sw = StepWeights.from_quantized(art.require_qp())
    for k in ref.qp.q:
        np.testing.assert_array_equal(as_bits(deq[k].numpy()),
                                      as_bits(jdeq[k]))
        np.testing.assert_array_equal(as_bits(deq[k].numpy()),
                                      as_bits(sw.w[k].numpy()))

# ---- the .fgar artifact ---------------------------------------------------

def _jax_artifact(low_rank):
    art = JArtifact.from_params(np_params(5, low_rank))
    return Pipeline((QuantizePTQ(bits=15),
                     CalibrateActivations(windows="hapt:train:5",
                                          scope="deploy"),
                     CalibrateActivations(windows="hapt:train:5",
                                          scope="storage"),
                     PackLUT())).run(art)


@pytest.mark.parametrize("low_rank", [True, False])
def test_fgar_reference_bytes_load_and_reserialize(low_rank, tmp_path):
    ref = _jax_artifact(low_rank)
    path = str(tmp_path / "ref.fgar")
    blob = ref.save(path)
    art = ModelArtifact.load(path)
    assert art.to_bytes() == blob            # identical bytes, this direction
    assert art.size_report() == ref.size_report()
    assert art.passes_applied() == ref.passes_applied()
    assert art.runtime_scales(True) == ref.runtime_scales(True)
    assert art.runtime_scales() is None
    qp = art.require_qp()
    assert qp.q["head_w"].dtype == torch.int16
    assert ("W1" in qp.q) == low_rank


def test_fgar_port_bytes_load_in_reference():
    p = np_params(6)
    art = ModelArtifact.from_params(p, {"source": "test"})
    art = art.replace(qp=q.quantize_params(p, q.QuantConfig()),
                      storage_scales={"pre": 1.5e-4, "h": 3e-5},
                      act_scales={"x": 1e-4},
                      luts={"sigmoid": lut.make_lut("sigmoid").numpy()})
    art = art.with_record({"pass": "quantize_ptq", "config": {"bits": 15},
                           "metrics": {}})
    blob = art.to_bytes()
    ref = JArtifact.from_bytes(blob)
    assert ref.to_bytes() == blob            # identical bytes, the reverse
    assert ModelArtifact.from_bytes(blob).to_bytes() == blob
    # and the port's PTQ agrees with the reference pass on the same params
    jart = QuantizePTQ(bits=15).apply(JArtifact.from_params(p, {"source": "test"}))
    for k, v in jart.qp.q.items():
        np.testing.assert_array_equal(art.qp.q[k].numpy(), np.asarray(v))


def test_fgar_rejects_bad_magic_and_trailing_bytes():
    blob = ModelArtifact.from_params(np_params(1)).to_bytes()
    with pytest.raises(ValueError):
        ModelArtifact.from_bytes(b"XXXX" + blob[4:])
    with pytest.raises(ValueError):
        ModelArtifact.from_bytes(blob + b"\0")
    with pytest.raises(ValueError):
        ModelArtifact.from_params(np_params(1)).require_qp()


# ---- scalar runtime + weights carried across --------------------------------

def _windows(n=6):
    return hapt.generate_synthetic("test", 0, n=n).windows


def test_hapt_copy_generates_reference_windows():
    a, b = hapt.generate_synthetic("val", 2, n=5), jhapt.generate_synthetic("val", 2, n=5)
    np.testing.assert_array_equal(a.windows, b.windows)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.subjects, b.subjects)


@pytest.mark.parametrize("mode", ["deployed", "calibrated", "naive"])
@pytest.mark.parametrize("low_rank", [True, False])
def test_weights_carried_across_qruntime_bitwise(low_rank, mode):
    jparams = np_params(7, low_rank)
    jqp = jq.quantize_params(jparams, jq.QuantConfig())
    # the reference's parameters cross as numpy arrays
    qp = weights.quantized_from_numpy(
        {k: np.asarray(v) for k, v in jqp.q.items()},
        {k: np.asarray(v) for k, v in jqp.scales.items()},
        {k: np.asarray(v) for k, v in jqp.fp.items()})
    qp_f = q.quantize_params(weights.params_from_numpy(jparams), q.QuantConfig())
    for k in qp.q:
        np.testing.assert_array_equal(qp.q[k].numpy(), qp_f.q[k].numpy())
    w = _windows()
    kw, jkw = {}, {}
    if mode == "calibrated":
        kw["act_scales"] = qruntime.calibrate(qruntime.QRuntime(qp), w[:3])
        jkw["act_scales"] = jqr.calibrate(jqr.QRuntime(jqp), w[:3])
        assert kw["act_scales"] == jkw["act_scales"]
    elif mode == "naive":
        kw["naive_acts"] = jkw["naive_acts"] = True
    rt, jrt = qruntime.QRuntime(qp, **kw), jqr.QRuntime(jqp, **jkw)
    for x in w:
        got, gtraj = rt.run_window(x, return_trajectory=True)
        ref, rtraj = jrt.run_window(x, return_trajectory=True)
        # bitwise: the same scalar float32 op sequence
        np.testing.assert_array_equal(as_bits(got), as_bits(ref))
        np.testing.assert_array_equal(as_bits(gtraj), as_bits(rtraj))
    np.testing.assert_array_equal(rt.predict_batch(w), jrt.predict_batch(w))


@pytest.mark.parametrize("low_rank", [True, False])
def test_calibration_and_recorders_match_reference(low_rank):
    jparams = np_params(8, low_rank)
    rt = qruntime.QRuntime(q.quantize_params(jparams, q.QuantConfig()))
    jrt = jqr.QRuntime(jq.quantize_params(jparams, jq.QuantConfig()))
    w = _windows(4)
    assert qruntime.calibrate(rt, w, deploy=True) == jqr.calibrate(jrt, w, deploy=True)
    assert qruntime.calibrate(rt, w, 0.25) == jqr.calibrate(jrt, w, 0.25)
    for deploy in (False, True):
        assert qruntime.record_activations(rt, w[0], deploy=deploy) == \
            jqr.record_activations(jrt, w[0], deploy=deploy)
    assert rt.predict(w[1]) == jrt.predict(w[1])


def test_qruntime_from_artifact_matches_reference():
    ref = _jax_artifact(True)
    art = ModelArtifact.from_bytes(ref.to_bytes())
    w = _windows(3)
    for quantized_acts in (False, True):
        got = qruntime.QRuntime.from_artifact(art, quantized_acts=quantized_acts)
        exp = jqr.QRuntime.from_artifact(ref, quantized_acts=quantized_acts)
        for x in w:
            np.testing.assert_array_equal(as_bits(got.run_window(x)),
                                          as_bits(exp.run_window(x)))


def test_random_params_layout():
    for low_rank in (True, False):
        p = weights.random_params(0, low_rank=low_rank)
        names = {"W1", "W2", "U1", "U2"} if low_rank else {"W", "U"}
        assert names | {"b_z", "b_h", "zeta", "nu", "head_w", "head_b"} == set(p)
        assert all(np.asarray(v).dtype == np.float32 for v in p.values())
    np.testing.assert_array_equal(weights.random_params(3)["U1"],
                                  weights.random_params(3)["U1"])
