"""Port parity, the dense-layout step: ``qstep.dense_weights`` /
``qstep.step_dense`` (the plain version of ``csrc/q15_step_dense.cu``)
against the reference's ``_q15_step_kernel_mxu`` run through its
``Q15StreamStep(backend="pallas", mxu=True)`` in interpret mode, on the
same numpy-drawn inputs.  The kernel itself runs only on the card
(``chip_smoke.py`` holds it bitwise against ``step_dense``)."""
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.fastgrnn_cell import qstep as jqstep
from repro.kernels.fastgrnn_cell.ops import Q15StreamStep as JStep
from repro_torch.core import quantization as q
from repro_torch.core.qruntime import QRuntime, calibrate
from repro_torch.data import hapt
from repro_torch.kernels.fastgrnn_cell import ops, qstep
from repro_torch.kernels.fastgrnn_cell.kernel import DenseStep
from repro_torch.serve.streaming import StreamingConfig, StreamingEngine
from torchharness import fold_log, np_params

H, D = 16, 3


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def models(low_rank, mode="deployed"):
    """(port qp, reference qp, storage kwargs) from one numpy param draw."""
    p = np_params(3, low_rank)
    qp = q.quantize_params(p, q.QuantConfig())
    kw = {}
    if mode == "calibrated":
        windows = hapt.generate_synthetic("test", 0, n=4).windows
        kw["act_scales"] = calibrate(QRuntime(qp), windows)
    return qp, jq.quantize_params(p, jq.QuantConfig()), kw


def inputs(S, seed=2):
    """The reference test's distribution (``tests/test_device_fleet.py``):
    h ~ 0.4 N(0, 1), x ~ N(0, 1); a third of the rows masked."""
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(S, H)) * 0.4).astype(np.float32)
    x = rng.normal(size=(S, D)).astype(np.float32)
    return h, x, np.arange(S) % 3 != 0


def port_dense(qp, kw, h, x, m):
    sw = qstep.StepWeights.from_quantized(qp, **kw)
    return qstep.step_dense(qstep.dense_arrays(sw, "cpu"), torch.from_numpy(h),
                            torch.from_numpy(x), torch.from_numpy(m))


@pytest.mark.parametrize("low_rank", [True, False], ids=["low", "full"])
def test_dense_weights_bitwise_reference(low_rank):
    qp, jqp, _ = models(low_rank)
    W, U = qstep.dense_weights(qstep.StepWeights.from_quantized(qp))
    jsw = jqstep.StepWeights.from_quantized(jqp)
    jW = jsw.w["W1"] @ jsw.w["W2"].T if low_rank else jsw.w["W"]
    jU = jsw.w["U1"] @ jsw.w["U2"].T if low_rank else jsw.w["U"]
    assert W.shape == (H, D) and U.shape == (H, H)
    np.testing.assert_array_equal(bits(W), bits(jW))
    np.testing.assert_array_equal(bits(U), bits(jU))


@pytest.mark.parametrize("low_rank", [True, False], ids=["low", "full"])
def test_step_dense_within_1e6_of_reference_dense_kernel(low_rank):
    """1e-6 is the reference's own bound for its dense layout against the
    exact step (``tests/test_device_fleet.py::test_mxu_layout_matches_exact``):
    XLA's dot sums the padded 128 lanes in its own order, the port sums the
    real lanes in ascending order."""
    qp, jqp, kw = models(low_rank)
    h, x, m = inputs(64)
    got = port_dense(qp, kw, h, x, m)
    ref = JStep(jqp, backend="pallas", mxu=True).step(h, x, m)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # masked rows keep h bit for bit in both
    np.testing.assert_array_equal(bits(got)[~m], bits(h)[~m])
    np.testing.assert_array_equal(bits(ref)[~m], bits(h)[~m])
    # and the dense layout is within the same bound of the Q15 step
    exact = JStep(jqp, backend="exact").step(h, x, m)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)


def test_dense_layout_stores_no_activation_in_either_package():
    """Calibrated storage: the Q15 step rounds every activation to Q15, the
    reference's dense kernel does not (``kernel.py::_q15_step_kernel_mxu``
    takes no storage scale), and the port computes what that kernel
    computes.  Recorded as a reference-side finding (ROADMAP C1)."""
    qp, jqp, kw = models(True, "calibrated")
    h, x, m = inputs(64)
    got = port_dense(qp, kw, h, x, m)
    deployed = port_dense(qp, {}, h, x, m)
    np.testing.assert_array_equal(bits(got), bits(deployed))
    ref = JStep(jqp, backend="pallas", mxu=True, **kw).step(h, x, m)
    ref_deployed = JStep(jqp, backend="pallas", mxu=True).step(h, x, m)
    np.testing.assert_array_equal(bits(ref), bits(ref_deployed))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # the Q15 step with the same storage does round, in both packages
    stored = JStep(jqp, backend="exact", **kw).step(h, x, m)
    port_stored = ops.Q15StreamStep(qp, device="cpu", **kw).step(h, x, m)
    np.testing.assert_array_equal(bits(port_stored), bits(stored))
    assert np.abs(stored - ref).max() > 1e-6


def test_mxu_on_the_cpu_runs_the_plain_version_and_counts_no_launch():
    qp, _, _ = models(True)
    k = ops.Q15StreamStep(qp, device="cpu", mxu=True)
    assert isinstance(k.kernel, DenseStep)
    h, x, m = inputs(40)
    out = k.step(h, x, m)
    np.testing.assert_array_equal(bits(out), bits(port_dense(qp, {}, h, x, m)))
    rows = k.step_rows(h, x, m)
    np.testing.assert_array_equal(bits(rows), bits(out))
    assert k.kernel.launches == 0
    r = k.roofline(1e9)
    assert r["mxu"] is True
    assert r["model_flops_per_stream_step"] == 2 * (D * H + H * H) + 10 * H
    assert r["hbm_bytes_per_stream_step"] == 141


def test_mxu_engine_predictions_match_reference_dense_engine():
    """The slice as a whole on the CPU: a port engine with ``mxu=True``
    against the reference engine on its dense Pallas kernel, same windows:
    every prediction equal, logits within the step tolerance."""
    qp, jqp, _ = models(True)
    windows = hapt.generate_synthetic("test", 0, n=6).windows
    from repro.serve.streaming import StreamingConfig as JConfig
    from repro.serve.streaming import StreamingEngine as JEngine
    eng = StreamingEngine(qp, StreamingConfig(max_slots=8, device="cpu",
                                              mxu=True))
    ref = JEngine(jqp, JConfig(max_slots=8, backend="pallas", mxu=True))
    logs = []
    for e in (eng, ref):
        for i, w in enumerate(windows):
            e.attach(f"w{i}", w, total_steps=len(w))
        logs.append(fold_log(e.drain()))
    got, want = logs
    assert set(got) == set(want) == {f"w{i}" for i in range(len(windows))}
    for sid in want:
        (g,), (r,) = got[sid], want[sid]
        assert g[:4] == r[:4] and g[5] == r[5]      # kind, steps, prediction
        np.testing.assert_allclose(np.frombuffer(g[4], np.float32),
                                   np.frombuffer(r[4], np.float32),
                                   rtol=0, atol=1e-4)
