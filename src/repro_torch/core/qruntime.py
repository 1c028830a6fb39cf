"""Deterministic 'C-equivalent' inference runtime (paper Sec. IV-D,
V-F, VI-B), a numpy copy of the reference ``repro.core.qruntime``.

Mirrors the deployed ~200-line fastgrnn.cpp translation unit:

  * weights stored as int16 Q15 + per-tensor float scale
  * dequantize-on-use:  float w = (float) W_q15[i] * scale   (Appendix B)
  * FP32 accumulate in a FIXED evaluation order (matvec as an ordered
    dot-product loop -> bit-stable across IEEE-754 implementations)
  * activations through the 256-entry nearest-bucket LUT (Appendix C)
  * optional calibrated Q15 *activation* storage between steps — the
    'calibrated Q15 acts' counterfactual of Table V.

It stays scalar numpy on purpose: it is the oracle that the batched torch
step (``kernels/fastgrnn_cell/qstep.py``) and the CUDA kernel are held to,
so it shares no arithmetic with them.  It reads the port's
:class:`~repro_torch.core.quantization.QuantizedParams` (CPU tensors) and
is bitwise equal to the reference runtime on the same parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .lut import make_lut, LUT_SIZE, INPUT_MIN, INPUT_MAX
from .quantization import QuantizedParams, Q15_MAX


_SIG_LUT = make_lut("sigmoid").numpy()
_TANH_LUT = make_lut("tanh").numpy()
_BW = (INPUT_MAX - INPUT_MIN) / LUT_SIZE
_INV_BW = 1.0 / _BW


def _lut_eval_scalar(lut: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vector-of-scalars nearest-bucket LUT, identical to Appendix C."""
    x = np.asarray(x, np.float32)
    idx = np.clip(((x - INPUT_MIN) * _INV_BW).astype(np.int32), 0, LUT_SIZE - 1)
    y = lut[idx]
    y = np.where(x >= INPUT_MAX, lut[LUT_SIZE - 1], y)
    y = np.where(x <= INPUT_MIN, lut[0], y)
    return y.astype(np.float32)


def _deq(qp: QuantizedParams, name: str) -> np.ndarray:
    """Dequantize one tensor the way the C engine does (elementwise f32)."""
    q = np.asarray(qp.q[name].numpy(), np.int32)
    s = np.float32(qp.scales[name])
    return (q.astype(np.float32) * s).astype(np.float32)


def _matvec(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Fixed-order FP32 matvec: out[i] = sum_j A[i,j]*x[j], j ascending.

    np.dot on contiguous float32 uses pairwise summation whose order can
    differ across BLAS builds; an explicit loop is the bit-stable reference.
    """
    out = np.zeros(A.shape[0], np.float32)
    for j in range(A.shape[1]):
        out += A[:, j] * np.float32(x[j])
    return out.astype(np.float32)


@dataclasses.dataclass
class QRuntime:
    """Deployed-model runtime: Q15 weights + scales (+ optional act quant)."""
    qp: QuantizedParams
    act_scales: dict[str, float] | None = None  # calibrated Q15 activations
    naive_acts: bool = False                     # naive Q15 [-1,1) activations

    @classmethod
    def from_artifact(cls, artifact, *, quantized_acts: bool = False,
                      naive_acts: bool = False) -> "QRuntime":
        """Build the runtime from a :class:`repro_torch.compress.ModelArtifact`.

        Defaults to the deployed configuration (FP32 activations through
        the LUTs); ``quantized_acts=True`` selects the Table V
        calibrated-Q15-activation counterfactual via the artifact's
        ``storage_scales`` — see ``ModelArtifact.runtime_scales``, the one
        gate shared with ``StreamingEngine.from_artifact``."""
        return cls(artifact.require_qp(),
                   act_scales=artifact.runtime_scales(quantized_acts),
                   naive_acts=naive_acts)

    def __post_init__(self):
        self.low_rank = "W1" in self.qp.q or "W1" in self.qp.fp
        names = (["W1", "W2", "U1", "U2"] if self.low_rank else ["W", "U"])
        self._w = {n: _deq(self.qp, n) for n in names + ["head_w"]}
        f32 = lambda n: np.asarray(self.qp.fp[n].numpy(), np.float32)
        self._b_z, self._b_h = f32("b_z"), f32("b_h")
        self._head_b = f32("head_b")
        self._zeta = np.float32(1.0 / (1.0 + np.exp(-float(self.qp.fp["zeta"]))))
        self._nu = np.float32(1.0 / (1.0 + np.exp(-float(self.qp.fp["nu"]))))

    # -- activation storage quantization (Table V modes) ------------------
    def _store(self, name: str, t: np.ndarray) -> np.ndarray:
        if self.naive_acts:
            scale = np.float32(1.0 / Q15_MAX)
        elif self.act_scales is not None and name in self.act_scales:
            scale = np.float32(self.act_scales[name])
        else:
            return t
        q = np.clip(np.round(t / scale), -Q15_MAX - 1, Q15_MAX)
        return (q * scale).astype(np.float32)

    # -- public introspection (export compiler / parity harness) -----------
    @property
    def hidden_dim(self) -> int:
        return int(self._b_z.shape[0])

    @property
    def input_dim(self) -> int:
        return int(self._w["W2"].shape[0] if self.low_rank
                   else self._w["W"].shape[1])

    @property
    def num_classes(self) -> int:
        return int(self._head_b.shape[0])

    def step(self, h: np.ndarray, x: np.ndarray) -> np.ndarray:
        """One fastgrnn_step() — mirrors the C translation unit."""
        if self.low_rank:
            wx = _matvec(self._w["W1"], _matvec(self._w["W2"].T, x))
            uh = _matvec(self._w["U1"], _matvec(self._w["U2"].T, h))
        else:
            wx = _matvec(self._w["W"], x)
            uh = _matvec(self._w["U"], h)
        pre = self._store("pre", wx + uh)
        z = _lut_eval_scalar(_SIG_LUT, pre + self._b_z)
        h_tilde = _lut_eval_scalar(_TANH_LUT, pre + self._b_h)
        z = self._store("z", z)
        h_tilde = self._store("h_tilde", h_tilde)
        h_new = (self._zeta * (1.0 - z) + self._nu) * h_tilde + z * h
        return self._store("h", h_new.astype(np.float32))

    def run_window(self, xs: np.ndarray, return_trajectory: bool = False):
        """xs: (T, d) -> logits (C,) [+ (T, H) hidden trajectory]."""
        H = self._b_z.shape[0]
        h = np.zeros(H, np.float32)
        traj = np.zeros((xs.shape[0], H), np.float32) if return_trajectory else None
        for t in range(xs.shape[0]):
            h = self.step(h, xs[t])
            if return_trajectory:
                traj[t] = h
        logits = _matvec(self._w["head_w"].T, h) + self._head_b
        logits = self._store("logits", logits)
        return (logits, traj) if return_trajectory else logits

    def predict(self, xs: np.ndarray) -> int:
        return int(np.argmax(self.run_window(xs)))

    def predict_batch(self, windows: np.ndarray) -> np.ndarray:
        """windows: (N, T, d) -> (N,) predictions."""
        return np.array([self.predict(w) for w in windows], np.int32)


def _record_maxima(rt: QRuntime, xs: np.ndarray, deploy: bool) -> dict[str, float]:
    """One pass of the FP32 recurrence, recording per-tensor max-abs.

    ``deploy=False`` records the activation-storage tensors (Table V
    modes: pre, z, h_tilde, h, logits).  ``deploy=True`` additionally
    records what the fixed-point export compiler must scale:

      * ``x``    — raw input samples (the qvm quantizes inputs once at the
        boundary, so the input scale is part of the weight image);
      * ``wx1`` / ``uh1`` — the low-rank intermediate vectors W2^T x and
        U2^T h, which the integer engine requantizes between the two
        factored matvecs;
      * ``pre``  — widened to cover pre+b_z and pre+b_h, because the
        integer engine adds the (pre-scale-quantized) biases *before* the
        LUT lookup and the bias-inclusive value must be representable.
    """
    H = rt.hidden_dim
    h = np.zeros(H, np.float32)
    maxima: dict[str, float] = {}

    def upd(name, t):
        maxima[name] = max(maxima.get(name, 0.0), float(np.max(np.abs(t))))

    if deploy:
        upd("x", xs)
    for t in range(xs.shape[0]):
        if rt.low_rank:
            wx1 = _matvec(rt._w["W2"].T, xs[t])
            uh1 = _matvec(rt._w["U2"].T, h)
            if deploy:
                upd("wx1", wx1)
                upd("uh1", uh1)
            wx = _matvec(rt._w["W1"], wx1)
            uh = _matvec(rt._w["U1"], uh1)
        else:
            wx = _matvec(rt._w["W"], xs[t])
            uh = _matvec(rt._w["U"], h)
        pre = wx + uh
        if deploy:
            upd("pre", pre + rt._b_z)
            upd("pre", pre + rt._b_h)
        z = _lut_eval_scalar(_SIG_LUT, pre + rt._b_z)
        h_tilde = _lut_eval_scalar(_TANH_LUT, pre + rt._b_h)
        h = (rt._zeta * (1.0 - z) + rt._nu) * h_tilde + z * h
        for n, v in (("pre", pre), ("z", z), ("h_tilde", h_tilde), ("h", h)):
            upd(n, v)
    logits = _matvec(rt._w["head_w"].T, h) + rt._head_b
    upd("logits", logits)
    return maxima


def record_activations(rt: QRuntime, xs: np.ndarray, *,
                       deploy: bool = False) -> dict[str, float]:
    """Collect per-tensor max-abs over one window — THE recorder behind
    both calibration scopes.  ``deploy=False`` records the activation-
    storage tensors (Table V); ``deploy=True`` additionally records the
    export-compiler scales (x, low-rank intermediates, bias-inclusive
    pre) — see ``_record_maxima``."""
    return _record_maxima(rt, xs, deploy)


def calibrate(rt: QRuntime, windows: np.ndarray, headroom: float = 0.10, *,
              deploy: bool = False) -> dict[str, float]:
    """Paper Sec. III-D: max-abs calibration with headroom — the ONE
    parameterized implementation behind both scopes.  ``deploy=False``
    yields the Table V activation-storage scales; ``deploy=True`` yields
    every scale the fixed-point export compiler packs into the weight
    image (what the reference ``repro.compress.CalibrateActivations`` and
    ``deploy/image.build_image`` consume)."""
    maxima: dict[str, float] = {}
    for w in windows:
        for k, v in _record_maxima(rt, w, deploy).items():
            maxima[k] = max(maxima.get(k, 0.0), v)
    return {k: ((1.0 + headroom) * v) / Q15_MAX if v > 0 else 1.0 / Q15_MAX
            for k, v in maxima.items()}


def record_activations_deploy(rt: QRuntime, xs: np.ndarray) -> dict[str, float]:
    """Thin alias: ``record_activations(rt, xs, deploy=True)``."""
    return record_activations(rt, xs, deploy=True)


def calibrate_deploy(rt: QRuntime, windows: np.ndarray,
                     headroom: float = 0.10) -> dict[str, float]:
    """Thin alias: ``calibrate(rt, windows, headroom, deploy=True)``."""
    return calibrate(rt, windows, headroom, deploy=True)
