"""Pure-integer Q15 FastGRNN virtual machine (paper Sec. V-G), ported from
the reference ``repro.deploy.qvm``: NumPy integer code, bit for bit the
reference's (``tests/test_torch_deploy.py``).

Executes a packed :class:`~repro_torch.deploy.image.DeployImage` with **zero
float operations in the hot loop** — the repo's stand-in for the
multiplier-less MSP430 path, and the bit-exact twin of the generated
integer C translation unit (``emit_c`` with ``engine="int"``): every
operation below is specified at the bit level and the C engine implements
the identical sequence, so per-step hidden-state traces are byte-identical
between the two.

Numeric conventions (mirrored one-for-one in the C):

  * persistent state (h) and all tensors are int16; saturation (not
    wraparound) at [-32768, 32767] wherever a value is stored to int16;
  * transient within-step intermediates (pre-activations, low-rank
    intermediates) are int32 at *fine* scales — 8 extra fractional bits
    below their calibrated Q15 scale (``FINE_SHIFT``) — the TFLite int16
    convention of int32 intermediate precision.  This keeps the engine's
    rounding noise well under the float reference's LUT bucket width,
    which is what makes the paper's 100%-agreement protocol reachable;
  * matvec accumulators are 64-bit, the CMSIS-NN q15 convention
    (``arm_fully_connected_q15`` accumulates in ``q63_t``): two int16
    operands already produce 2^30-scale products, so 16-term rows
    overflow int32 in the worst case;
  * rescaling between fixed-point formats is ``requant``:
    ``(acc * M + (1 << (SH-1))) >> SH`` with a precomputed integer
    multiplier ``M in [2^24, 2^25)`` — round-half-up, arithmetic shift
    (the TFLite/gemmlowp scheme, normalized mantissa form);
  * activations go through the 256-entry int16 Q15 LUTs; the bucket index
    is one integer multiply+shift (floor — no libm, no float compare);
  * the gate combine is evaluated at product scale and rounded **once**
    into the stored int16 h — matching the float engine's single
    store-rounding, which keeps the two paths' trajectories locked to the
    same Q15 grid outside genuine rounding-boundary ties;
  * z, h~, zeta, nu live at the *unit* Q15 scale (value = q/32767 — they
    are bounded by 1); x and h live at the calibrated scales packed in
    the image.

The only float touchpoint is :meth:`QVM.quantize_input`, the sensor
boundary (the MCU's ADC equivalent) — it runs once per sample *outside*
the recurrence and is excluded from the zero-float contract, which
``tests/test_torch_deploy.py`` enforces by checking dtypes through the hot
path.  The qvm is the microcontroller's twin, so it runs on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.core.lut import LUT_SIZE, INPUT_MIN, INPUT_MAX
from repro_torch.obs.numerics import site_order
from .image import DeployImage

I16_MIN, I16_MAX = -32768, 32767
Q15_ONE = 32767
# Extra fractional bits of the int32 within-step intermediates below their
# calibrated Q15 scale: value = q * (s / 2^FINE_SHIFT), |q| <~ 2^23.
FINE_SHIFT = 8
# Fine int32 intermediates saturate at ±2^29 so that sums of two matvec
# outputs plus a bias always stay inside int32 in the C engine, even for
# pathological inputs 2^6 beyond the calibrated range (the LUT saturates
# far earlier, so the clip is semantically inert on real data).
FINE_CLIP = (1 << 29) - 1
# LUT index = (v * M + (idx0 << SH)) >> SH with v at the fine pre scale;
# idx0 = -INPUT_MIN / bucket_width = 128 for the [-8, 8) x 256 domain.
_LUT_IDX0 = int(-INPUT_MIN * LUT_SIZE / (INPUT_MAX - INPUT_MIN))
_LUT_GAIN = LUT_SIZE / (INPUT_MAX - INPUT_MIN)     # buckets per unit (16.0)


@dataclasses.dataclass(frozen=True)
class Requant:
    """Integer rescale ``s_in -> s_out``: floor-preshift by ``pre`` (folds
    into the factor), multiply by ``m``, round-shift by ``sh``."""
    m: int
    sh: int
    pre: int = 0

    def raw(self, acc: np.ndarray) -> np.ndarray:
        """The rescaled int64 value BEFORE the int32 saturation — the
        monitored path reads this to count ``*.out`` saturation events
        without changing the applied result."""
        acc = np.asarray(acc).astype(np.int64) >> self.pre
        return (acc * self.m + (1 << (self.sh - 1))) >> self.sh

    def apply(self, acc: np.ndarray) -> np.ndarray:
        """((acc >> pre) * m + half) >> sh on int64, round-half-up,
        arithmetic shifts (numpy and C agree on negative operands).
        The result saturates to int32 range — the C twin returns int32_t,
        and without the clip a pathological gate product (tiny calibrated
        h scale + saturating inputs) would wrap there but not here,
        breaking the bit-exact C/qvm contract."""
        return np.clip(self.raw(acc), -(1 << 31), (1 << 31) - 1)


def quantize_multiplier(factor: float, acc_bits: int = 37) -> Requant:
    """Normalized-mantissa fixed-point representation of a positive real
    rescale factor: ``factor ~= m * 2^(pre - sh)`` with ``m in [2^24, 2^25)``.

    25-bit mantissas keep the worst relative representation error below
    2^-24.  ``acc_bits`` is the caller's bound on the accumulator
    magnitude (bits); when it exceeds 37 the accumulator is floor-shifted
    right first so the ``m`` product can never overflow int64
    (2^37 * 2^25 < 2^63).  The preshift's floor loss is ~2^-37 relative —
    far below the mantissa error."""
    if not (factor > 0.0 and math.isfinite(factor)):
        raise ValueError(f"requant factor must be positive finite: {factor}")
    pre = max(0, acc_bits - 37)
    factor = factor * (1 << pre)            # folded into the mantissa
    mant, exp = math.frexp(factor)          # factor = mant * 2^exp, mant in [0.5,1)
    m = round(mant * (1 << 25))             # in [2^24, 2^25]
    sh = 25 - exp
    if m == (1 << 25):                      # rounding pushed mantissa to 1.0
        m >>= 1
        sh -= 1
    if sh < 1:
        raise ValueError(f"requant factor too large: {factor}")
    if sh > 62:                             # factor ~ 0: underflow to zero
        m, sh = 0, 62
    return Requant(m=m, sh=sh, pre=pre)


def sat16(v: np.ndarray) -> np.ndarray:
    """Saturate int values to int16 range (the paper's clip(round(.)))."""
    return np.clip(v, I16_MIN, I16_MAX)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Every integer constant the step loop needs, derived deterministically
    from the image.  ``emit_c`` bakes this same plan into the C header, so
    the emulator and the compiled C share one source of truth."""
    low_rank: bool
    d: int
    H: int
    C: int
    rank_w: int
    rank_u: int
    # weights as int64 numpy (exact integer matmuls)
    w: dict[str, np.ndarray]
    # matvec requants into fine int32 scales (names match the C macros)
    rq: dict[str, Requant]
    # biases at the fine pre scale, int32 range
    bz_q: np.ndarray
    bh_q: np.ndarray
    # gate constants: g2 = zeta_q*(Q15-z) + nu2_q at unit^2 scale
    zeta_q: int
    nu2_q: int
    rq_gate: Requant        # unit^2 / s_h: g2*h~ product -> F = s_h/Q15
    rq_hstore: Requant      # F -> s_h (the single h store-rounding, 1/Q15)
    # LUT index mapping for fine-pre-scale inputs
    lut_m: int
    lut_sh: int
    sig_lut: np.ndarray     # int64 view for exact gathers
    tanh_lut: np.ndarray
    # head
    headb_q: np.ndarray     # int32, at scale s_headw * s_h * 2^logit_sh
    logit_sh: int
    # boundary scales (float, used OUTSIDE the hot loop only)
    s_x: float
    s_h: float
    s_logits_q: float       # scale of the int32 logits the vm emits


def plan_from_image(img: DeployImage) -> QuantPlan:
    a = img.act_scales
    s_x, s_h = a["x"], a["h"]
    fine = 1 << FINE_SHIFT
    s_pref = a["pre"] / fine                # fine pre scale (int32 domain)
    w = {n: np.asarray(img.q[n], np.int64) for n in img.tensor_order()}
    # accumulator magnitude bounds (bits) for int64-overflow-safe requants:
    # int16*int16 products are 2^30; second-stage products are
    # 2^15 * FINE_CLIP = 2^44; each sum adds log2(n_terms).
    bits30 = lambda n: 30 + max(1, n).bit_length()
    bits44 = lambda n: 45 + max(1, n).bit_length()
    rq: dict[str, Requant] = {}
    if img.low_rank:
        s_t1 = a["wx1"] / fine              # fine low-rank intermediates
        s_t2 = a["uh1"] / fine
        rq["w2"] = quantize_multiplier(img.scales["W2"] * s_x / s_t1,
                                       bits30(img.d))
        rq["w1"] = quantize_multiplier(img.scales["W1"] * s_t1 / s_pref,
                                       bits44(img.rank_w))
        rq["u2"] = quantize_multiplier(img.scales["U2"] * s_h / s_t2,
                                       bits30(img.H))
        rq["u1"] = quantize_multiplier(img.scales["U1"] * s_t2 / s_pref,
                                       bits44(img.rank_u))
    else:
        rq["w"] = quantize_multiplier(img.scales["W"] * s_x / s_pref,
                                      bits30(img.d))
        rq["u"] = quantize_multiplier(img.scales["U"] * s_h / s_pref,
                                      bits30(img.H))
    bz_q = np.round(np.asarray(img.b_z, np.float64) / s_pref).astype(np.int64)
    bh_q = np.round(np.asarray(img.b_h, np.float64) / s_pref).astype(np.int64)
    zeta = 1.0 / (1.0 + math.exp(-img.zeta_raw))
    nu = 1.0 / (1.0 + math.exp(-img.nu_raw))
    # LUT index: float semantics are idx = clip(int((v_real + 8) * 16));
    # v_real = v_q * s_pref.  Floor, no rounding half — mirrors the float
    # engine's astype(int32) truncation.
    rq_lut = quantize_multiplier(s_pref * _LUT_GAIN, 31)   # |v| <= 2^31
    # head: logits = (acc >> logit_sh) + headb_q, argmax-invariant common
    # shift sized so the worst-case |acc| lands in int32.
    s_headw = img.scales["head_w"]
    acc_max = img.H * (Q15_ONE ** 2)
    logit_sh = max(0, int(acc_max).bit_length() - 30)
    headb_q = np.round(np.asarray(img.head_b, np.float64)
                       / (s_headw * s_h * (1 << logit_sh))).astype(np.int64)
    if np.any(np.abs(headb_q) > (1 << 31) - 1):
        raise ValueError("head bias overflows the shifted logit scale")
    unit = 1.0 / Q15_ONE
    return QuantPlan(
        low_rank=img.low_rank, d=img.d, H=img.H, C=img.C,
        rank_w=img.rank_w, rank_u=img.rank_u, w=w, rq=rq,
        bz_q=bz_q, bh_q=bh_q,
        zeta_q=round(zeta * Q15_ONE),
        nu2_q=round(nu * Q15_ONE * Q15_ONE),
        # gate product g2*h~ is bounded by 2^31 * 2^15 = 2^46; the
        # F-scale sum hf is clipped to ±2^31 before the store requant.
        rq_gate=quantize_multiplier(unit * unit / s_h, 47),
        rq_hstore=quantize_multiplier(unit, 32),
        lut_m=rq_lut.m, lut_sh=rq_lut.sh,
        sig_lut=np.asarray(img.sig_lut, np.int64),
        tanh_lut=np.asarray(img.tanh_lut, np.int64),
        headb_q=headb_q, logit_sh=logit_sh,
        s_x=float(s_x), s_h=float(s_h),
        s_logits_q=float(s_headw * s_h * (1 << logit_sh)))


def _count_outside(v: np.ndarray, lo: int, hi: int) -> int:
    """Number of elements strictly outside [lo, hi] — the shared counting
    semantic of every saturation site (qvm, C and kernel monitors must
    agree on this definition for the parity gates to hold)."""
    return int(np.count_nonzero((v < lo) | (v > hi)))


class QVM:
    """Batched pure-integer executor.  State is (B, H) int16; every public
    method except :meth:`quantize_input` is integer-only.

    ``monitor``: optional :class:`repro_torch.obs.numerics.NumericsMonitor` —
    counts saturation/clamp events per analyzer site ID and observes
    pre-activation / hidden ranges at their real (dequantized) scales.
    The monitored path only *reads* intermediates; outputs are
    byte-identical with and without a monitor (test-gated)."""

    def __init__(self, img: DeployImage, monitor=None):
        self.img = img
        self.plan = plan_from_image(img)
        self.monitor = monitor
        if monitor is not None:
            monitor.declare(site_order(self.plan.low_rank))
            monitor.set_default_limits({
                "x": self.plan.s_x * Q15_ONE,
                "pre": float(img.act_scales["pre"]) * Q15_ONE,
                "h": self.plan.s_h * Q15_ONE,
            })

    # -- boundary (the ADC): float -> Q15, OUTSIDE the hot loop ----------
    def quantize_input(self, x: np.ndarray) -> np.ndarray:
        """(..., d) float samples -> int16 at the calibrated input scale."""
        x = np.asarray(x, np.float64)
        if self.monitor is not None:
            self.monitor.observe("x", x)
        q = np.round(x / self.plan.s_x)
        return sat16(q).astype(np.int16)

    def dequantize_input(self, xq: np.ndarray) -> np.ndarray:
        """The float engines' view of the same recorded sensor samples."""
        return (np.asarray(xq, np.float32)
                * np.float32(self.plan.s_x)).astype(np.float32)

    def init_state(self, batch: int) -> np.ndarray:
        return np.zeros((batch, self.plan.H), np.int16)

    # -- integer hot loop -------------------------------------------------
    def _matvec(self, name: str, wq: np.ndarray, vq: np.ndarray) -> np.ndarray:
        """(B, n) int @ (m, n)^T -> requant -> (B, m) int64 fine scale
        (exact: integer addition is associative, so numpy's sum order is
        irrelevant)."""
        acc = vq.astype(np.int64) @ wq.T        # (B, m)
        rq = self.plan.rq[name]
        if self.monitor is None:
            return np.clip(rq.apply(acc), -FINE_CLIP - 1, FINE_CLIP)
        raw = rq.raw(acc)
        self.monitor.count(f"{name}.out",
                           _count_outside(raw, -(1 << 31), (1 << 31) - 1))
        v32 = np.clip(raw, -(1 << 31), (1 << 31) - 1)
        self.monitor.count(f"{name}.fine",
                           _count_outside(v32, -FINE_CLIP - 1, FINE_CLIP))
        return np.clip(v32, -FINE_CLIP - 1, FINE_CLIP)

    def _lut(self, table: np.ndarray, vq: np.ndarray,
             site: str | None = None) -> np.ndarray:
        """Nearest-bucket lookup from a fine-pre-scale int value: one
        integer multiply+shift, then clip to the table (saturating the ±8
        tails — identical to the float engine's boundary handling)."""
        p = self.plan
        idx = (vq.astype(np.int64) * p.lut_m
               + (_LUT_IDX0 << p.lut_sh)) >> p.lut_sh
        if self.monitor is not None and site is not None:
            self.monitor.count(site, _count_outside(idx, 0, LUT_SIZE - 1))
        return table[np.clip(idx, 0, LUT_SIZE - 1)]

    def step(self, hq: np.ndarray, xq: np.ndarray) -> np.ndarray:
        """One integer FastGRNN step.  hq: (B, H) int16 at s_h; xq: (B, d)
        int16 at s_x -> new (B, H) int16 at s_h."""
        p = self.plan
        hq64 = hq.astype(np.int64)
        if p.low_rank:
            t1 = self._matvec("w2", p.w["W2"].T, xq)          # (B,rw) fine
            wx = self._matvec("w1", p.w["W1"], t1)            # (B,H) fine pre
            t2 = self._matvec("u2", p.w["U2"].T, hq64)        # (B,ru) fine
            uh = self._matvec("u1", p.w["U1"], t2)            # (B,H) fine pre
        else:
            wx = self._matvec("w", p.w["W"], xq)
            uh = self._matvec("u", p.w["U"], hq64)
        pre = wx + uh                                         # int32, fine
        zq = self._lut(p.sig_lut, pre + p.bz_q, "act.z.idx")  # (B,H) unit Q15
        htq = self._lut(p.tanh_lut, pre + p.bh_q, "act.ht.idx")
        # gate combine at product scale, ONE store-rounding into int16 h:
        #   h' = (zeta*(1-z) + nu) * h~ + z*h
        g2 = p.zeta_q * (Q15_ONE - zq) + p.nu2_q              # unit^2
        gate_acc = g2 * htq
        if self.monitor is None:
            a_f = p.rq_gate.apply(gate_acc)                   # F = s_h/Q15
        else:
            raw = p.rq_gate.raw(gate_acc)
            self.monitor.count(
                "gate.out", _count_outside(raw, -(1 << 31), (1 << 31) - 1))
            a_f = np.clip(raw, -(1 << 31), (1 << 31) - 1)
        h_f = a_f + zq * hq64                                 # F (z*h exact)
        # clip at ±2^31: beyond the int16 saturation threshold in F units
        # (2^30), so semantically inert — it only bounds the requant input
        if self.monitor is not None:
            self.monitor.count(
                "gate.hf_clip",
                _count_outside(h_f, -(1 << 31), (1 << 31) - 1))
        h_f = np.clip(h_f, -(1 << 31), (1 << 31) - 1)
        if self.monitor is None:
            h_new = sat16(p.rq_hstore.apply(h_f))             # s_h, int16
        else:
            raw = p.rq_hstore.raw(h_f)
            self.monitor.count(
                "hstore.out", _count_outside(raw, -(1 << 31), (1 << 31) - 1))
            v32 = np.clip(raw, -(1 << 31), (1 << 31) - 1)
            self.monitor.count("h_next", _count_outside(v32, I16_MIN, I16_MAX))
            h_new = sat16(v32)
            # activation-range telemetry at real (dequantized) scales
            s_pref = self.img.act_scales["pre"] / (1 << FINE_SHIFT)
            pre_real = pre.astype(np.float64) * s_pref
            self.monitor.observe("pre", pre_real)
            self.monitor.observe("h", h_new.astype(np.float64) * p.s_h)
        return h_new.astype(np.int16)

    def logits(self, hq: np.ndarray) -> np.ndarray:
        """(B, H) int16 -> (B, C) int32 logits at ``plan.s_logits_q``."""
        p = self.plan
        acc = hq.astype(np.int64) @ p.w["head_w"]             # (B, C)
        out = (acc >> p.logit_sh) + p.headb_q
        if self.monitor is not None:
            self.monitor.count(
                "head.logits", _count_outside(out, -(1 << 31), (1 << 31) - 1))
        return out.astype(np.int32)

    # -- window/batch drivers ---------------------------------------------
    def run_window(self, xq: np.ndarray, return_trajectory: bool = False):
        """xq: (T, d) int16 -> (C,) int32 logits [+ (T, H) int16 trace]."""
        lg, traj = self.run_windows(xq[None], return_trajectory=True)
        return (lg[0], traj[0]) if return_trajectory else lg[0]

    def run_windows(self, xq: np.ndarray, return_trajectory: bool = False):
        """xq: (B, T, d) int16 -> (B, C) int32 [+ (B, T, H) int16 traces].
        Steps all windows in lockstep — the vectorized image of the scalar
        MCU loop (identical per-row integer ops)."""
        B, T, _ = xq.shape
        hq = self.init_state(B)
        traj = (np.zeros((B, T, self.plan.H), np.int16)
                if return_trajectory else None)
        for t in range(T):
            hq = self.step(hq, xq[:, t])
            if return_trajectory:
                traj[:, t] = hq
        lg = self.logits(hq)
        return (lg, traj) if return_trajectory else lg

    def predict_batch(self, windows: np.ndarray) -> np.ndarray:
        """(B, T, d) float windows -> (B,) argmax predictions (input
        quantization at the boundary, then integer-only)."""
        xq = self.quantize_input(windows)
        return np.argmax(self.run_windows(xq), axis=1).astype(np.int32)

    def stats(self) -> dict[str, Any]:
        p = self.plan
        return {"low_rank": p.low_rank, "d": p.d, "H": p.H, "C": p.C,
                "rank_w": p.rank_w, "rank_u": p.rank_u,
                "fine_shift": FINE_SHIFT, "logit_shift": p.logit_sh,
                "requants": {k: (v.m, v.sh) for k, v in p.rq.items()}}
