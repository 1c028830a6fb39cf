"""Port parity, the activation-calibration names of ``core/``:
``repro_torch.core.quantization``'s ``calibrate_activations``,
``fake_quant_activation`` and ``NAIVE_ACT_SCALE``, and
``repro_torch.core.qruntime``'s ``record_activations_deploy`` and
``calibrate_deploy``, each against the reference function on the same
seeded numpy inputs.  Mirrors ``tests/test_quantization.py``'s headroom,
naive-collapse and calibrated round-trip cases."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qruntime as JQR
from repro.core import quantization as JQ
from repro.data import hapt as jhapt
from repro_torch.core import qruntime as QR
from repro_torch.core import quantization as Q
from repro_torch.data import hapt
from torchharness import np_params


def f32(v) -> np.float32:
    return np.float32(v)


def seeded_batches(seed, n=4):
    rng = np.random.default_rng(seed)
    return [{"pre": (3.0 * rng.standard_normal((8, 16))).astype(np.float32),
             "h": (60.0 * rng.standard_normal(16)).astype(np.float32),
             "zero": np.zeros(5, np.float32)} for _ in range(n)]


@pytest.mark.parametrize("seed, headroom", [(0, 0.10), (1, 0.0), (2, 0.25)])
def test_calibrate_activations_equals_reference(seed, headroom):
    """The same scales, to float32 rounding, for seeded batches (an
    all-zero activation included: 1/32767 in both)."""
    batches = seeded_batches(seed)
    got = Q.calibrate_activations(
        lambda b: {k: torch.from_numpy(v) for k, v in b.items()}, batches,
        headroom=headroom)
    want = JQ.calibrate_activations(
        lambda b: {k: jnp.asarray(v) for k, v in b.items()}, batches,
        headroom=headroom)
    assert got.keys() == want.keys()
    assert {k: f32(v) for k, v in got.items()} == \
        {k: f32(v) for k, v in want.items()}
    assert got["zero"] == 1.0 / Q.Q15_MAX


def test_calibration_headroom():
    """``tests/test_quantization.py::test_calibration_headroom`` on the
    port."""
    acts = [{"h": torch.tensor([1.0, -3.0])}, {"h": torch.tensor([5.0, 0.1])}]
    scales = Q.calibrate_activations(lambda b: b, acts, headroom=0.10)
    assert abs(scales["h"] - (1.1 * 5.0) / Q.Q15_MAX) < 1e-9


def test_naive_activation_quant_clips_out_of_range():
    """The paper's collapse mechanism, as
    ``tests/test_quantization.py`` checks it: |h| ~ 62 >> 1 is
    unrepresentable in naive Q15 [-1, 1) and clips to ~1; a calibrated
    scale covers the range."""
    assert Q.NAIVE_ACT_SCALE == JQ.NAIVE_ACT_SCALE == 1.0 / 32767
    h = torch.tensor([62.0, -0.5, 0.9])
    out = Q.fake_quant_activation(h, Q.NAIVE_ACT_SCALE)
    assert abs(float(out[0]) - 1.0) < 1e-3
    assert abs(float(out[1]) + 0.5) < 1e-4
    out2 = Q.fake_quant_activation(h, (1.1 * 62.0) / Q.Q15_MAX)
    assert abs(float(out2[0]) - 62.0) < 0.01


@pytest.mark.parametrize("scale", ["naive", "calibrated", "coarse"])
def test_fake_quant_activation_bitwise_reference(scale):
    """Seeded float32 activations (half-way points and the clip edges
    included) through both packages' fake quantization: the same float32
    bits."""
    rng = np.random.default_rng(7)
    t = (40.0 * rng.standard_normal(4096)).astype(np.float32)
    s = {"naive": JQ.NAIVE_ACT_SCALE,
         "calibrated": (1.1 * float(np.abs(t).max())) / JQ.Q15_MAX,
         "coarse": 0.5}[scale]
    t[:4] = np.float32([0.5 * s, 1.5 * s, -2.5 * s, 32767.5 * s])
    got = Q.fake_quant_activation(torch.from_numpy(t), s).numpy()
    want = np.asarray(JQ.fake_quant_activation(jnp.asarray(t), s))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def runtimes():
    """Both packages' ``QRuntime`` over Q15 weights of the same low-rank
    float parameters, and 5 synthetic HAPT training windows."""
    params = np_params(0)
    rt = QR.QRuntime(Q.quantize_params(params, Q.QuantConfig()))
    jrt = JQR.QRuntime(JQ.quantize_params(params, JQ.QuantConfig()))
    windows = hapt.load("train", n=5).windows
    np.testing.assert_array_equal(windows, jhapt.load("train", n=5).windows)
    return rt, jrt, windows


def test_record_activations_deploy_equals_reference(runtimes):
    """One window's deploy-scope maxima (x, the low-rank intermediates,
    the bias-inclusive pre, z, h_tilde, h, logits), equal."""
    rt, jrt, windows = runtimes
    got = QR.record_activations_deploy(rt, windows[0])
    assert got == JQR.record_activations_deploy(jrt, windows[0])
    assert got == QR.record_activations(rt, windows[0], deploy=True)
    assert {"x", "wx1", "uh1", "pre", "logits"} <= got.keys()


@pytest.mark.parametrize("headroom", [0.10, 0.0])
def test_calibrate_deploy_equals_reference(runtimes, headroom):
    """``calibrate_deploy`` over 5 synthetic HAPT windows: the reference's
    scales, and the port's ``calibrate(..., deploy=True)``'s."""
    rt, jrt, windows = runtimes
    got = QR.calibrate_deploy(rt, windows, headroom)
    assert got == JQR.calibrate_deploy(jrt, windows, headroom)
    assert got == QR.calibrate(rt, windows, headroom, deploy=True)
