"""Batched single-step Q15 FastGRNN cell math in plain PyTorch.

This is the **plain version** of the CUDA step kernel (``kernel.py``,
``csrc/q15_step.cu``) and the port of the reference
``repro.kernels.fastgrnn_cell.qstep``: one FastGRNN step for a whole batch
of independent streams, written as the same scalar IEEE-754 float32 ops per
stream row as the scalar ``core/qruntime.QRuntime.step`` — fixed ascending-j
matvec with the accumulator starting at +0.0, dequantize-on-use weights,
nearest-bucket LUT activations, the gate combine in a fixed order.

Eager PyTorch runs every op as its own kernel, so no multiply-add is ever
contracted into an FMA, and the result is bitwise equal to the scalar
runtime on the CPU and on the card.  One trap is avoided explicitly: on
CUDA, ``a / b`` with ``b`` a CPU scalar (a Python float or a 0-dim CPU
tensor) is computed as ``a * (1/b)``, which changes about one rounded Q15
value in 5,000.  Every storage scale is therefore a 0-dim tensor on the
device of the data (:meth:`StepWeights.arrays`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lut import make_lut, LUT_SIZE, INPUT_MIN, INPUT_MAX
from repro_torch.core.quantization import QuantizedParams, Q15_MAX

_INV_BW = LUT_SIZE / (INPUT_MAX - INPUT_MIN)   # exact python float (16.0)

LOW_RANK_NAMES = ("W1", "W2", "U1", "U2")
FULL_RANK_NAMES = ("W", "U")
#: Activation-storage sites, in op order (Table V modes).
STORE_NAMES = ("pre", "z", "h_tilde", "h", "logits")


def _sigmoid_f32(raw) -> float:
    """sigmoid(raw) in float64 numpy, rounded to float32 — as deployed
    (``qstep.py``/``qruntime.py`` of the reference), never ``torch.sigmoid``
    in float32."""
    return float(np.float32(1.0 / (1.0 + np.exp(-float(raw)))))


@dataclasses.dataclass
class StepWeights:
    """Deployment-time constants for the batched step: dequantized f32
    weights, raw Q15 tensors + scales (for the kernel, which dequantizes
    on use), float biases, post-sigmoid zeta/nu scalars, the two LUTs and
    the activation-storage mode.  Every tensor is on the CPU;
    :meth:`arrays` places them on a device."""
    low_rank: bool
    w: dict[str, torch.Tensor]          # dequantized float32 (incl. head_w)
    q: dict[str, torch.Tensor]          # raw int16 Q15 tensors
    scales: dict[str, float]            # per-tensor dequant scales (f32 values)
    b_z: torch.Tensor
    b_h: torch.Tensor
    head_b: torch.Tensor
    zeta: float                         # sigmoid(raw), f32 value — as deployed
    nu: float
    sig_lut: torch.Tensor               # (256,) f32
    tanh_lut: torch.Tensor
    act_scales: dict[str, float] | None = None   # calibrated Q15 act storage
    naive_acts: bool = False                     # naive [-1,1) act storage

    @property
    def input_dim(self) -> int:
        return self.w["W2"].shape[0] if self.low_rank else self.w["W"].shape[1]

    @property
    def hidden_dim(self) -> int:
        return self.b_z.shape[0]

    @property
    def num_classes(self) -> int:
        return self.head_b.shape[0]

    @property
    def ranks(self) -> tuple[int, int]:
        """(r_w, r_u) of a low-rank cell, (0, 0) for full rank."""
        if not self.low_rank:
            return 0, 0
        return self.w["W1"].shape[1], self.w["U1"].shape[1]

    @classmethod
    def from_quantized(cls, qp: QuantizedParams, *,
                       act_scales: dict[str, float] | None = None,
                       naive_acts: bool = False) -> "StepWeights":
        low_rank = "W1" in qp.q or "W1" in qp.fp
        names = list(LOW_RANK_NAMES if low_rank else FULL_RANK_NAMES) + ["head_w"]
        w, q, scales = {}, {}, {}
        for n in names:
            qi = qp.q[n].to(torch.int16).cpu()
            s = float(np.float32(qp.scales[n]))
            q[n] = qi
            scales[n] = s
            w[n] = qi.to(torch.float32) * torch.tensor(s, dtype=torch.float32)
        f32 = lambda n: qp.fp[n].to("cpu", torch.float32)
        return cls(
            low_rank=low_rank, w=w, q=q, scales=scales,
            b_z=f32("b_z"), b_h=f32("b_h"), head_b=f32("head_b"),
            zeta=_sigmoid_f32(qp.fp["zeta"]), nu=_sigmoid_f32(qp.fp["nu"]),
            sig_lut=make_lut("sigmoid"), tanh_lut=make_lut("tanh"),
            act_scales=dict(act_scales) if act_scales else None,
            naive_acts=naive_acts,
        )

    def store_scale(self, name: str) -> float | None:
        """Activation-storage scale for ``name`` (Table V modes) as the exact
        value of a float32, or None when the tensor stays FP32 (the
        deployed configuration)."""
        if self.naive_acts:
            return float(np.float32(1.0 / Q15_MAX))
        if self.act_scales is not None and name in self.act_scales:
            return float(np.float32(self.act_scales[name]))
        return None

    def arrays(self, device) -> dict:
        """Every constant the plain step needs, on ``device``: weights,
        biases, LUTs, and ``"store"``: a 0-dim float32 tensor on ``device``
        per storage site (or None)."""
        dev = torch.device(device)
        out = {n: a.to(dev) for n, a in self.w.items()}
        out.update(b_z=self.b_z.to(dev), b_h=self.b_h.to(dev),
                   head_b=self.head_b.to(dev),
                   sig_lut=self.sig_lut.to(dev), tanh_lut=self.tanh_lut.to(dev))
        out["store"] = {
            n: (None if (s := self.store_scale(n)) is None
                else torch.tensor(s, dtype=torch.float32, device=dev))
            for n in STORE_NAMES}
        return out


# ---------------------------------------------------------------------------
# Plain batched math
# ---------------------------------------------------------------------------

def matvec_batched(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b, i] = sum_j A[i, j] * x[b, j], j ascending, from +0.0.

    Per row the multiply and the accumulate are the same two scalar f32
    ops in the same order as ``qruntime._matvec``."""
    out = torch.zeros((x.shape[0], A.shape[0]), dtype=torch.float32,
                      device=x.device)
    for j in range(A.shape[1]):
        out = out + x[:, j:j + 1] * A[:, j][None, :]
    return out


def lut_eval_batched(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nearest-bucket LUT over (B, H), identical to qruntime._lut_eval_scalar:
    index truncated toward zero, clamped, then the saturation overrides."""
    idx = ((v - INPUT_MIN) * _INV_BW).to(torch.int32).clamp(0, LUT_SIZE - 1)
    y = table[idx.long()]
    y = torch.where(v >= INPUT_MAX, table[LUT_SIZE - 1], y)
    return torch.where(v <= INPUT_MIN, table[0], y)


def store_batched(t: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """Q15 activation-storage fake-quant (qruntime._store); ``scale`` is a
    0-dim tensor on ``t``'s device, or None for FP32 storage."""
    if scale is None:
        return t
    q = torch.clamp(torch.round(t / scale), -Q15_MAX - 1, Q15_MAX)
    return q * scale


#: Bound-check slack for the tally fast path: the elementwise ``pre + b``
#: sums round in float32, so the (float64) ``max(pre) + max(b)`` bound can
#: undershoot an elementwise result by up to half a float32 ulp.  1e-3 at
#: a threshold of 8.0 is ~1000x that — conservative, never unsound.
_TALLY_SLACK = 1e-3


def tally_step_events(events: dict, pre, z_in, ht_in,
                      bias_ext: tuple | None = None) -> None:
    """Accumulate numeric-health tallies from one step's already
    materialized intermediates (see :mod:`repro_torch.obs.numerics`); the
    same counts, ranges and fast path as the reference's
    ``tally_step_events``.

    ``act.*.idx`` counts LUT boundary hits (a pre-activation at or beyond
    ``INPUT_MAX`` / ``INPUT_MIN``); ``pre`` range is tallied as (vmin,
    vmax, n, n_over) against the optional ``events["pre_limit"]``.  The
    bias extremes ``bias_ext = (bz_lo, bz_hi, bh_lo, bh_hi)`` let healthy
    steps skip the elementwise counts."""
    pmin, pmax = float(pre.min()), float(pre.max())
    if bias_ext is None:
        near_z = near_ht = True
    else:
        bz_lo, bz_hi, bh_lo, bh_hi = bias_ext
        near_z = (pmax + bz_hi >= INPUT_MAX - _TALLY_SLACK
                  or pmin + bz_lo <= INPUT_MIN + _TALLY_SLACK)
        near_ht = (pmax + bh_hi >= INPUT_MAX - _TALLY_SLACK
                   or pmin + bh_lo <= INPUT_MIN + _TALLY_SLACK)
    if near_z:
        events["act.z.idx"] = events.get("act.z.idx", 0) + int(
            torch.count_nonzero(z_in >= INPUT_MAX)
            + torch.count_nonzero(z_in <= INPUT_MIN))
    if near_ht:
        events["act.ht.idx"] = events.get("act.ht.idx", 0) + int(
            torch.count_nonzero(ht_in >= INPUT_MAX)
            + torch.count_nonzero(ht_in <= INPUT_MIN))
    lim = events.get("pre_limit")
    # exact comparisons on pre itself: bounds inside +-lim imply zero over
    n_over = int(torch.count_nonzero(pre.abs() > lim)) \
        if lim and (pmax > lim or pmin < -lim) else 0
    vmin, vmax, n, over = events.get("pre_range", (0.0, 0.0, 0, 0))
    if n == 0:
        events["pre_range"] = (pmin, pmax, int(pre.numel()), n_over)
    else:
        events["pre_range"] = (min(vmin, pmin), max(vmax, pmax),
                               n + int(pre.numel()), over + n_over)


def step_batched(arrs: dict, sw: StepWeights, h: torch.Tensor,
                 x: torch.Tensor, events: dict | None = None) -> torch.Tensor:
    """One batched FastGRNN step.  h: (B, H), x: (B, d) -> h_new (B, H).

    Mirrors ``QRuntime.step`` line for line; ``arrs`` is
    ``sw.arrays(h.device)``.  ``events`` is a mutable dict that
    :func:`tally_step_events` fills from the intermediates this call
    materializes anyway, so monitored and unmonitored runs execute the same
    float op sequence and stay byte-identical."""
    st = arrs["store"]
    if sw.low_rank:
        wx = matvec_batched(arrs["W1"], matvec_batched(arrs["W2"].T, x))
        uh = matvec_batched(arrs["U1"], matvec_batched(arrs["U2"].T, h))
    else:
        wx = matvec_batched(arrs["W"], x)
        uh = matvec_batched(arrs["U"], h)
    pre = store_batched(wx + uh, st["pre"])
    z_in = pre + arrs["b_z"]
    ht_in = pre + arrs["b_h"]
    z = lut_eval_batched(arrs["sig_lut"], z_in)
    h_tilde = lut_eval_batched(arrs["tanh_lut"], ht_in)
    if events is not None:
        ext = events.get("_bias_ext")
        if ext is None:
            ext = events["_bias_ext"] = (
                float(arrs["b_z"].min()), float(arrs["b_z"].max()),
                float(arrs["b_h"].min()), float(arrs["b_h"].max()))
        tally_step_events(events, pre, z_in, ht_in, ext)
    z = store_batched(z, st["z"])
    h_tilde = store_batched(h_tilde, st["h_tilde"])
    h_new = (sw.zeta * (1.0 - z) + sw.nu) * h_tilde + z * h
    return store_batched(h_new, st["h"])


def logits_batched(arrs: dict, sw: StepWeights, h: torch.Tensor) -> torch.Tensor:
    """Classifier head, the batched image of ``qruntime.run_window``'s
    ``_matvec(head_w.T, h) + head_b`` (+ optional Q15 logit storage)."""
    out = matvec_batched(arrs["head_w"].T, h)
    return store_batched(out + arrs["head_b"], arrs["store"]["logits"])
