"""Port parity, the FP32 window path: the fused window scan
(``repro_torch.kernels.fastgrnn_cell.ops.fastgrnn_window_kernel``, its
plain version ``qstep.window_scan`` on the CPU) against the reference's
Pallas ``fastgrnn_window_kernel`` in interpret mode and its oracle, on the
same numpy params and inputs; the scan against chained dense steps; and a
mirror of the three-path agreement of ``tests/test_qruntime.py:17-51``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastgrnn as jfg
from repro.core import pipeline as jpl
from repro.kernels.fastgrnn_cell.ops import (
    fastgrnn_window_kernel as j_window_kernel)
from repro.kernels.fastgrnn_cell.ref import fastgrnn_window_ref as j_window_ref
from repro_torch import weights
from repro_torch.core import fastgrnn as fg
from repro_torch.core.lut import lut_sigmoid, lut_tanh
from repro_torch.core.qruntime import QRuntime
from repro_torch.kernels.fastgrnn_cell import qstep
from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan
from repro_torch.kernels.fastgrnn_cell.ops import fastgrnn_window_kernel
from repro_torch.kernels.fastgrnn_cell.ref import fastgrnn_window_ref
from torchharness import np_cell_params as np_params


def as_bits(t):
    return np.ascontiguousarray(t.numpy()).view(np.int32)


@pytest.mark.parametrize("low_rank,alpha", [(False, False), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("T,B", [(16, 1), (128, 5), (64, 8)])
def test_window_kernel_vs_reference(low_rank, alpha, T, B):
    p = np_params(0, low_rank=low_rank, alpha=alpha)
    xs = np.random.default_rng(1).normal(size=(T, B, 3)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    h_r, traj_r = j_window_kernel(jp, jnp.asarray(xs))
    h_o, traj_o = j_window_ref(jp, jnp.asarray(xs), lut=True, mode="nearest")
    h, traj = fastgrnn_window_kernel(p, xs, device="cpu")
    assert h.shape == (B, 16) and traj.shape == (T, B, 16)
    # 2e-5: the reference's kernel-vs-oracle bound (sums in another order)
    for want_h, want_traj in ((h_r, traj_r), (h_o, traj_o)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj),
                                   rtol=0, atol=2e-5)
    # the port's own oracle (the FP32 cell + LUTs) within the same bound
    tp = weights.params_from_numpy(p)
    h_p, traj_p = fastgrnn_window_ref(tp, torch.from_numpy(xs))
    np.testing.assert_allclose(traj.numpy(), traj_p.numpy(), rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(as_bits(h), as_bits(traj[-1]))


@pytest.mark.parametrize("low_rank,alpha", [(False, False), (True, False),
                                            (True, True)])
def test_window_scan_is_chained_dense_steps_bitwise(low_rank, alpha):
    p = np_params(2, low_rank=low_rank, alpha=alpha)
    # large inputs in some rows drive the LUTs into saturation too
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(40, 9, 3)).astype(np.float32)
    xs[:, ::4] *= 60.0
    arrs = qstep.window_arrays(p, "cpu")
    h_w, traj_w = qstep.window_scan(arrs, torch.from_numpy(xs))
    h = torch.zeros(9, 16)
    mask = torch.ones(9, dtype=torch.bool)
    for t in range(40):
        h = qstep.step_dense(arrs, h, torch.from_numpy(xs[t]), mask)
        np.testing.assert_array_equal(as_bits(traj_w[t]), as_bits(h))
    np.testing.assert_array_equal(as_bits(h_w), as_bits(h))


def test_window_arrays_match_reference_operands():
    """Effective W/U from numpy's ``@`` (+ diag(alpha)), zeta/nu as float64
    sigmoids rounded to float32: the reference wrapper's operands."""
    p = np_params(4, alpha=True)
    arrs = qstep.window_arrays(p, "cpu")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(arrs["W"].numpy(),
                               np.asarray(jfg.effective_W(jp)), atol=1e-7)
    np.testing.assert_allclose(arrs["U"].numpy(),
                               np.asarray(jfg.effective_U(jp)), atol=1e-7)
    for k in ("zeta", "nu"):
        assert arrs[k] == float(np.float32(1 / (1 + np.exp(-float(p[k])))))
    # the same operands from tensor leaves
    arrs_t = qstep.window_arrays(weights.params_from_numpy(p), "cpu")
    for k in ("W", "U", "b_z", "b_h"):
        np.testing.assert_array_equal(as_bits(arrs_t[k]), as_bits(arrs[k]))


def test_window_scan_wrapper_contract():
    scan = WindowScan(np_params(5), device="cpu")
    before = WindowScan.launches
    xs = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 3, 3))
                          .astype(np.float32))
    h, traj = scan(xs)
    np.testing.assert_array_equal(as_bits(traj), as_bits(scan.plain(xs)[1]))
    assert WindowScan.launches == before     # the CPU path launches nothing
    with pytest.raises(TypeError):
        scan(xs.double())
    with pytest.raises(ValueError):
        scan(xs[:, :, :2].contiguous())
    with pytest.raises(ValueError):
        scan(xs.transpose(0, 1))
    h0, traj0 = scan(torch.zeros(0, 3, 3))   # an empty window: h stays 0
    assert traj0.shape == (0, 3, 16) and not h0.any()


# ---- mirror of tests/test_qruntime.py:17-51 ---------------------------------

def _port_qp(rt):
    """The reference runtime's quantized params carried across as numpy."""
    return weights.quantized_from_numpy(
        {k: np.asarray(v) for k, v in rt.qp.q.items()},
        {k: np.asarray(v) for k, v in rt.qp.scales.items()},
        {k: np.asarray(v) for k, v in rt.qp.fp.items()}, rt.qp.bits)


def test_three_path_agreement(trained_har):
    cfg, params, tr, te = trained_har
    windows = te.windows[:80]
    qp = _port_qp(jpl.deploy(params, tr.windows[:5]))
    fp = weights.params_from_numpy({k: np.asarray(v)
                                    for k, v in params.items()})
    xs = torch.from_numpy(np.ascontiguousarray(np.transpose(windows,
                                                            (1, 0, 2))))
    # path 1: torch FP32 with nearest-LUT activations
    p1 = fg.forward_window(fp, xs, sigma=lut_sigmoid,
                           tanh=lut_tanh).argmax(-1).numpy()
    # path 2: the port's integer C-equivalent runtime
    p2 = QRuntime(qp).predict_batch(windows)
    # path 3: the window scan on the dequantized params
    deq = qp.dequantize()
    h, _ = fastgrnn_window_kernel(deq, xs, device="cpu")
    p3 = (h @ deq["head_w"] + deq["head_b"]).argmax(-1).numpy()
    assert np.mean(p2 == p3) == 1.0          # integer vs kernel: exact
    assert np.mean(p1 == p2) >= 0.97         # fp32 vs Q15: paper >= 99.9 %


def test_hidden_trajectory_determinism(trained_har):
    cfg, params, tr, te = trained_har
    qp = _port_qp(jpl.deploy(params, tr.windows[:5]))
    rt = QRuntime(qp)
    w = te.windows[0]
    _, traj_a = rt.run_window(w, return_trajectory=True)
    _, traj_b = rt.run_window(w.copy(), return_trajectory=True)
    np.testing.assert_array_equal(traj_a, traj_b)   # bit-equal
    _, traj_k = fastgrnn_window_kernel(qp.dequantize(), w[:, None, :],
                                       device="cpu")
    np.testing.assert_allclose(traj_a, traj_k[:, 0].numpy(), rtol=0,
                               atol=2e-5)
