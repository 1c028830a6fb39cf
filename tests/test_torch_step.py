"""Port parity, the batched step: ``repro_torch``'s ``Q15StreamStep`` (the
plain torch step on the CPU) against the reference ``Q15StreamStep``
backends and the scalar oracle, plus the CUDA kernel wrapper's CPU
contract (plain version, no launch counted, strict input checks)."""
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core.qruntime import QRuntime as JQRuntime, calibrate as jcalibrate
from repro.kernels.fastgrnn_cell import qstep as jqstep
from repro.kernels.fastgrnn_cell.ops import Q15StreamStep as JStep
from repro.kernels.fastgrnn_cell.ref import q15_step_batched_ref as jref
from repro_torch.core import quantization as q
from repro_torch.core.qruntime import QRuntime, calibrate
from repro_torch.data import hapt
from repro_torch.kernels.fastgrnn_cell import ops, qstep
from repro_torch.kernels.fastgrnn_cell.kernel import (FastGRNNStep,
                                                      make_fastgrnn_step)
from repro_torch.kernels.fastgrnn_cell.ref import q15_step_batched_ref


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


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def models(low_rank, mode, seed=0):
    """(port qp, reference qp, port kwargs, reference kwargs) for a mode."""
    p = np_params(seed, low_rank)
    qp = q.quantize_params(p, q.QuantConfig())
    jqp = jq.quantize_params(p, jq.QuantConfig())
    kw, jkw = {}, {}
    if mode == "calibrated":
        w = hapt.generate_synthetic("train", 0, n=4).windows
        kw["act_scales"] = calibrate(QRuntime(qp), w)
        jkw["act_scales"] = jcalibrate(JQRuntime(jqp), w)
    elif mode == "naive":
        kw["naive_acts"] = jkw["naive_acts"] = True
    return qp, jqp, kw, jkw


def inputs(S, seed, H=16, d=3):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(S, H)) * 0.4).astype(np.float32)
    x = rng.normal(size=(S, d)).astype(np.float32)
    x[::7] *= 60.0                           # drive the LUT saturation paths
    return h, x


MODES = ["deployed", "calibrated", "naive"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("low_rank", [True, False])
def test_step_and_head_bitwise_vs_reference_exact_and_oracle(low_rank, mode):
    qp, jqp, kw, jkw = models(low_rank, mode)
    h, x = inputs(64, 5)
    active = np.ones(64, bool)
    k = ops.Q15StreamStep(qp, device="cpu", **kw)
    h_new = k.step(h, x, active)
    logits = k.head_logits(h_new)
    j = JStep(jqp, backend="exact", **jkw)
    jh = j.step(h, x, active)
    # bitwise: eager torch and numpy run the same scalar f32 op sequence
    np.testing.assert_array_equal(bits(h_new), bits(jh))
    np.testing.assert_array_equal(bits(logits), bits(j.head_logits(jh)))
    for oracle in (q15_step_batched_ref(qp, h, x, **kw), jref(jqp, h, x, **jkw)):
        np.testing.assert_array_equal(bits(h_new), bits(oracle[0]))
        np.testing.assert_array_equal(bits(logits), bits(oracle[1]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("low_rank", [True, False])
def test_chained_masked_steps_bitwise_vs_reference_exact(low_rank, mode):
    qp, jqp, kw, jkw = models(low_rank, mode, seed=1)
    k = ops.Q15StreamStep(qp, device="cpu", **kw)
    j = JStep(jqp, backend="exact", **jkw)
    rng = np.random.default_rng(9)
    h, _ = inputs(256, 2)
    jh = h
    for _ in range(24):
        x = rng.normal(size=(256, 3)).astype(np.float32) * 3
        active = rng.random(256) >= 1 / 3
        h = k.step(h, x, active)
        jh = j.step(jh, x, active)
        # bitwise, every step (masked rows included)
        np.testing.assert_array_equal(bits(h), bits(jh))


@pytest.mark.parametrize("low_rank", [True, False])
def test_step_vs_reference_pallas_interpret(low_rank):
    qp, jqp, _, _ = models(low_rank, "deployed")
    h, x = inputs(16, 6)
    h[:, 3] = 0.0
    active = np.ones(16, bool)
    active[5] = False
    got = ops.Q15StreamStep(qp, device="cpu").step(h, x, active)
    ref = JStep(jqp, backend="pallas").step(h, x, active)
    # atol 1e-5: the reference Pallas path runs under XLA, which contracts
    # a*b+c into FMAs (reference qstep.py module docstring); the deployed
    # storage mode only, because a Q15 storage rounding flipped by an FMA
    # moves a value by a whole storage step (>= 3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bits(got[5]), bits(h[5]))


def test_inactive_slots_hold_state():
    qp, _, _, _ = models(True, "deployed")
    h, x = inputs(8, 6)
    active = np.zeros(8, bool)
    active[::2] = True
    h_new = ops.Q15StreamStep(qp, device="cpu").step(h, x, active)
    np.testing.assert_array_equal(bits(h_new[1::2]), bits(h[1::2]))
    assert not np.array_equal(h_new[::2].numpy(), h[::2])


def test_step_rows_gathered_equals_masked_step_and_tallies_like_reference():
    qp, jqp, _, _ = models(True, "deployed")
    h, x = inputs(32, 7)
    active = np.random.default_rng(3).random(32) > 0.4
    rows = np.nonzero(active)[0]
    k = ops.Q15StreamStep(qp, device="cpu")
    j = JStep(jqp, backend="exact")
    k.numeric_events, j.numeric_events = {"pre_limit": 0.5}, {"pre_limit": 0.5}
    got = k.step_rows(h, x, active, rows)
    ref = j.step_rows(h, x, active, rows)
    # bitwise step; tallies equal (same intermediates, same comparisons)
    np.testing.assert_array_equal(bits(got), bits(ref))
    np.testing.assert_array_equal(bits(got), bits(k.step(h, x, active)))
    assert k.numeric_events == j.numeric_events
    k.numeric_events, j.numeric_events = {}, {}
    k.tally_numeric_events(h, x, rows)
    j.tally_numeric_events(h, x, rows)
    assert k.numeric_events == j.numeric_events and k.numeric_events


def test_step_weights_match_reference():
    qp, jqp, kw, jkw = models(False, "calibrated")
    sw = qstep.StepWeights.from_quantized(qp, **kw)
    jsw = jqstep.StepWeights.from_quantized(jqp, **jkw)
    for n in jsw.w:
        np.testing.assert_array_equal(bits(sw.w[n]), bits(jsw.w[n]))
        np.testing.assert_array_equal(sw.q[n].numpy(), jsw.q[n])
    assert np.float32(sw.zeta) == jsw.zeta and np.float32(sw.nu) == jsw.nu
    for n in qstep.STORE_NAMES:
        s, js = sw.store_scale(n), jsw.store_scale(n)
        assert (s is None and js is None) or np.float32(s) == js
    assert (sw.input_dim, sw.hidden_dim, sw.num_classes) == \
        (jsw.input_dim, jsw.hidden_dim, jsw.num_classes)
    # storage scales are 0-dim tensors on the target device: CUDA divides
    # by a CPU scalar as a multiply by its reciprocal
    st = sw.arrays("cpu")["store"]
    assert all(v is None or (v.dim() == 0 and v.dtype == torch.float32)
               for v in st.values())


def test_plain_division_by_scale_tensor_is_exact():
    t = torch.from_numpy(
        np.random.default_rng(0).standard_normal(200_000).astype(np.float32))
    s = np.float32(1.0 / 32767)
    got = qstep.store_batched(t, torch.tensor(float(s)))
    ref = np.clip(np.round(t.numpy() / s), -32768, 32767) * s
    np.testing.assert_array_equal(bits(got), bits(ref.astype(np.float32)))


# ---- the kernel wrapper on the CPU -------------------------------------------

def test_kernel_wrapper_cpu_runs_plain_and_counts_no_launch():
    qp, _, kw, _ = models(True, "naive")
    sw = qstep.StepWeights.from_quantized(qp, **kw)
    k = make_fastgrnn_step(sw, device="cpu")
    assert isinstance(k, FastGRNNStep)
    h, x = inputs(40, 8)
    m = torch.from_numpy(np.arange(40) % 3 != 0)
    out = k(torch.from_numpy(h), torch.from_numpy(x), m)
    ref = q15_step_batched_ref(qp, h, x, **kw)[0]
    ref[~m.numpy()] = h[~m.numpy()]
    np.testing.assert_array_equal(bits(out), bits(ref))
    assert k.launches == 0


def test_kernel_wrapper_rejects_bad_inputs():
    """Both step wrappers (the Q15 step and, with ``mxu=True``, the dense
    layout) refuse what their kernels do not take."""
    sw = qstep.StepWeights.from_quantized(models(True, "deployed")[0])
    h = torch.zeros(8, 16)
    x = torch.zeros(8, 3)
    m = torch.ones(8, dtype=torch.bool)
    for mxu in (False, True):
        k = make_fastgrnn_step(sw, device="cpu", mxu=mxu)
        with pytest.raises(TypeError):
            k(h.double(), x, m)
        with pytest.raises(TypeError):
            k(h, x, m.to(torch.uint8))
        with pytest.raises(ValueError):
            k(h, torch.zeros(8, 4), m)
        with pytest.raises(ValueError):
            k(h, x, torch.ones(7, dtype=torch.bool))
        with pytest.raises(ValueError):
            k(torch.zeros(16, 8).T, x, m)      # not contiguous


def test_device_state_api_semantics_on_cpu_tensors():
    qp = models(True, "deployed")[0]
    k = ops.Q15StreamStep(qp, device="cpu")
    assert not k.supports_device_state
    h = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    h2 = k.set_rows_device(h, [1, 5], np.ones((2, 16), np.float32))
    assert h2 is not h and float(h[1, 0]) == 16.0 and float(h2[1, 0]) == 1.0
    np.testing.assert_array_equal(k.rows_to_host(h2, [5]), np.ones((1, 16)))
    mask = np.zeros(8, bool)
    mask[2] = True
    h3 = k.reset_device(h2, mask)
    assert float(h3[2].abs().sum()) == 0.0 and float(h2[2, 0]) == 32.0
    np.testing.assert_array_equal(k.to_host(k.to_device(h3.numpy())), h3.numpy())
    assert k.concat_device([h3[:3], h3[3:]]).equal(h3)
    assert k.init_state_device(4).shape == (4, 16)
    tr = k.transfers.snapshot()
    assert tr["h_h2d_bytes"] == 2 * 16 * 4 + 8 * 16 * 4
    assert tr["h_d2h_bytes"] == 16 * 4 + 8 * 16 * 4
    assert tr["h2d_bytes"] == tr["h_h2d_bytes"] + 8


def test_roofline_uses_h100_constants():
    r = ops.Q15StreamStep(models(True, "deployed")[0], device="cpu").roofline(1e9)
    assert r["hbm_bw_bytes_per_sec"] == 3.35e12 and r["peak_flops"] == 67e12
    assert r["hbm_bytes_per_stream_step"] == 4 * (3 + 2 * 16) + 1
    assert r["model_flops_per_stream_step"] == 2 * (3 * 2 + 16 * 2 + 2 * 16 * 8) + 160
