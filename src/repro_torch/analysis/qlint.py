"""``qlint`` — integer-safety abstract interpreter for the Q15 programs,
ported from the reference ``repro.analysis.qlint``; its report on an image
equals the reference's (``tests/test_torch_qlint.py``).

The integer step program executed by :class:`repro_torch.deploy.qvm.QVM` and
its bit-exact C twin (``repro_torch.deploy.emit_c`` with ``engine="int"``) is
specified down to the bit: int16 state, int32 fine intermediates, int64
matvec accumulators, gemmlowp requantization, 256-entry LUT activations.
Until now those width claims were comments backed by hand audits (the
``bits30``/``bits44`` sizing in ``plan_from_image``, the "semantically
inert" clip notes).  ``qlint`` mechanizes them: it re-executes the whole
step + head program over the exact interval domain
(:mod:`repro_torch.analysis.intervals`), seeded with the **actual** tensors of
a packed :class:`~repro_torch.deploy.image.DeployImage` — real weight row
sums, real LUT table contents, real requant multipliers — and emits one
site record per instruction with the *proven* bound, the minimum signed
width that holds it, and the declared storage width of the concrete
program.  A declared width the proof does not cover is a finding, and
a finding makes ``proved_overflow_free`` false.

Checks (ids cited by findings and mutation fixtures):

* ``q-acc-width``      — every accumulator / intermediate / constant
  table fits its declared width (int64 matvec accs, int32 fine values
  and logits, int16 state).  The C engine has no saturating hardware:
  an unproved width is undefined behavior on the MCU, not a wrap.
* ``q-requant-range``  — every gemmlowp requant is well-formed:
  normalized mantissa ``m in [2^24, 2^25)`` (or the documented
  underflow-to-zero form ``m == 0``), round shift ``1 <= sh <= 62``,
  floor preshift ``pre >= 0``.
* ``q-requant-overflow`` — the requant's int64 internal product
  ``((acc >> pre) * m + 2^(sh-1))`` cannot overflow for the *proven*
  accumulator interval (the ``acc_bits`` contract of
  ``quantize_multiplier``, discharged against real ranges).
* ``q-lut-bounds``     — LUT index arithmetic fits int64 and the
  clamped index range lies inside the actual table (256 entries).
* ``q-int16-neg``      — no negation whose operand interval contains
  ``INT16_MIN`` lands in an int16 slot (``-(-32768)`` overflows).
* ``q-shift-neg``      — shift amounts are in ``[0, 63]``, and right
  shifts of possibly-negative operands occur only at the documented
  arithmetic-shift primitives (requant / LUT index / head shift — the
  qvm and the C twin pin those to arithmetic semantics; anywhere else a
  negative operand is a portability hazard).

Saturation sites are additionally classified **reachable or dead**: a
clamp whose operand interval already fits is dead (documentation), one
whose interval exceeds the clamp is load-bearing (the int16 store
saturation, by design).  The classification is recorded per site so a
calibration change that silently flips a "semantically inert" clip into
a load-bearing one shows up in the committed report diff.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.lut import LUT_SIZE
from repro_torch.deploy.image import DeployImage
from repro_torch.deploy.qvm import (FINE_CLIP, I16_MAX, I16_MIN, Q15_ONE,
                                    Requant, _LUT_IDX0, plan_from_image)
from .intervals import Interval, WIDTH_RANGE
from .report import Finding

#: check id -> one-line statement (the docstring above carries the detail)
QLINT_CHECKS = {
    "q-acc-width": "value proven to fit its declared signed storage width",
    "q-requant-range": "requant m/sh/pre are well-formed gemmlowp constants",
    "q-requant-overflow": "requant internal product fits int64 for the "
                          "proven accumulator interval",
    "q-lut-bounds": "LUT index arithmetic in-range against the real table",
    "q-int16-neg": "no negation of an interval containing INT16_MIN into "
                   "an int16 slot",
    "q-shift-neg": "shift amounts in [0, 63]; negative operands only at "
                   "documented arithmetic-shift sites",
}

#: Declared storage widths of the concrete program (the qvm/emit_c
#: contract).  Mutation fixtures downgrade these to prove the gate bites.
DEFAULT_WIDTHS = {
    "acc": 64,       # matvec accumulators (CMSIS-NN q63_t convention)
    "fine": 32,      # fine-scale intermediates (pre, t1, t2)
    "requant": 64,   # requant internal product
    "wide": 64,      # gate-path int64 temporaries
    "logits": 32,    # head output (int32_t in C)
    "state": 16,     # persistent h
}

INT32 = WIDTH_RANGE[32]


@dataclasses.dataclass(frozen=True)
class Assumptions:
    """Analysis-time parameters.  The defaults are the real contract;
    mutation fixtures (the reference's ``selftest``; ROADMAP A8 for the
    port) perturb them (accumulator-width downgrade, truncated LUT) to
    prove every check can actually fire."""
    x: Interval = Interval(I16_MIN, I16_MAX)      # quantize_input saturates
    h: Interval = Interval(I16_MIN, I16_MAX)      # sat16-stored state
    widths: dict[str, int] = dataclasses.field(default_factory=dict)
    fine_clip: int = FINE_CLIP
    lut_size: int = LUT_SIZE

    def width(self, kind: str) -> int:
        return self.widths.get(kind, DEFAULT_WIDTHS[kind])


@dataclasses.dataclass
class Site:
    """One analyzed instruction: the report's unit of proof."""
    name: str
    op: str
    declared_bits: int
    iv: Interval
    sat: str | None = None      # "reachable" | "dead" | None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "site": self.name,
            "op": self.op,
            "declared_bits": self.declared_bits,
            "lo": self.iv.lo,
            "hi": self.iv.hi,
            "bits_needed": self.iv.bits_needed(),
            "margin_bits": self.declared_bits - self.iv.bits_needed(),
        }
        if self.sat is not None:
            d["saturation"] = self.sat
        return d


class Machine:
    """The abstract machine: each primitive mirrors one concrete
    operation of the qvm/C step program, records a :class:`Site` with
    the proven interval, and raises findings against the declared
    widths.  Public so the mutation fixtures can drive single
    primitives directly (e.g. an int16 negation site)."""

    def __init__(self, assume: Assumptions | None = None):
        self.assume = assume or Assumptions()
        self.sites: list[Site] = []
        self.findings: list[Finding] = []

    # -- recording -------------------------------------------------------
    def _site(self, name: str, op: str, iv: Interval, bits: int,
              sat: str | None = None) -> Interval:
        self.sites.append(Site(name, op, bits, iv, sat))
        if not iv.fits(bits):
            self._find("q-acc-width", name,
                       f"{op} value {iv} needs {iv.bits_needed()} bits but "
                       f"is stored in int{bits}")
        return iv

    def _find(self, check: str, site: str, message: str) -> None:
        self.findings.append(Finding(check=check, where=site, message=message))

    def _sat_class(self, iv: Interval, lo: int, hi: int) -> str:
        return "reachable" if iv.exceeds(lo, hi) else "dead"

    # -- primitives ------------------------------------------------------
    def const_table(self, name: str, values: np.ndarray, bits: int) -> Interval:
        """A baked constant array (biases, head bias) with its C storage
        width — ``plan_from_image`` range-checks ``headb_q`` but not the
        fine-scale biases; this closes that gap."""
        iv = Interval(int(np.min(values)), int(np.max(values)))
        return self._site(name, "const", iv, bits)

    def matvec(self, name: str, w_rows: np.ndarray, v: Interval) -> Interval:
        """Exact accumulator bound for ``acc_i = sum_j W[i, j] * v_j``
        with every ``v_j`` in ``v``: per-row positive/negative
        coefficient sums against the interval endpoints (the true
        reachable range, not the ``n * max|W|`` worst case)."""
        w = np.asarray(w_rows, np.int64)
        pos = np.where(w > 0, w, 0).sum(axis=1)
        neg = np.where(w < 0, w, 0).sum(axis=1)
        hi = max(int(p) * v.hi + int(n) * v.lo for p, n in zip(pos, neg))
        lo = min(int(p) * v.lo + int(n) * v.hi for p, n in zip(pos, neg))
        return self._site(f"{name}.acc", "matvec",
                          Interval(lo, hi), self.assume.width("acc"))

    def requant(self, name: str, rq: Requant, acc: Interval,
                out_clip: tuple[int, int] | None = INT32) -> Interval:
        """The gemmlowp rescale ``((acc >> pre) * m + 2^(sh-1)) >> sh``
        with the int32 output saturation both engines apply."""
        if not (rq.m == 0 or (1 << 24) <= rq.m < (1 << 25)):
            self._find("q-requant-range", name,
                       f"mantissa m={rq.m} outside [2^24, 2^25) "
                       f"(and not the underflow form m=0)")
        if not 1 <= rq.sh <= 62:
            self._find("q-requant-range", name,
                       f"round shift sh={rq.sh} outside [1, 62]")
        if rq.pre < 0:
            self._find("q-requant-range", name,
                       f"preshift pre={rq.pre} is negative")
        shifted = self.shr(f"{name}.pre", acc, max(rq.pre, 0),
                           self.assume.width("acc"), arith_ok=True,
                           record=False)
        sh = min(max(rq.sh, 1), 62)      # analyze on the clamped form
        half = 1 << (sh - 1)
        internal = shifted.mul(Interval.const(rq.m)).add(Interval.const(half))
        self.sites.append(Site(f"{name}.requant_acc", "requant",
                               self.assume.width("requant"), internal))
        if not internal.fits(self.assume.width("requant")):
            self._find("q-requant-overflow", f"{name}.requant_acc",
                       f"internal product {internal} needs "
                       f"{internal.bits_needed()} bits > "
                       f"int{self.assume.width('requant')} (acc_bits "
                       f"contract of quantize_multiplier violated)")
        out = internal.shr(sh)
        sat = None
        if out_clip is not None:
            sat = self._sat_class(out, *out_clip)
            out = out.clip(*out_clip)
        return self._site(f"{name}.out", "requant_out", out, 64, sat=sat)

    def fine(self, name: str, rq: Requant, acc: Interval) -> Interval:
        """Matvec epilogue: requant then the ±FINE_CLIP int32 clamp that
        keeps later sums of two fine values inside int32."""
        fc = self.assume.fine_clip
        out = self.requant(name, rq, acc)
        sat = self._sat_class(out, -fc - 1, fc)
        out = out.clip(-fc - 1, fc)
        return self._site(f"{name}.fine", "fine_clip", out,
                          self.assume.width("fine"), sat=sat)

    def lut(self, name: str, v: Interval, m: int, sh: int,
            table: np.ndarray) -> Interval:
        """Index ``(v * m + (idx0 << sh)) >> sh`` clamped into the real
        table; the returned interval is the exact min/max of the table
        slice the clamped index range can reach."""
        if len(table) != self.assume.lut_size:
            self._find("q-lut-bounds", name,
                       f"table has {len(table)} entries, expected "
                       f"{self.assume.lut_size}")
        idx_acc = v.mul(Interval.const(m)).add(
            Interval.const(_LUT_IDX0 << sh))
        self._site(f"{name}.idx_acc", "lut_index", idx_acc, 64)
        idx = self.shr(f"{name}.idx_shift", idx_acc, sh, 64,
                       arith_ok=True, record=False)
        sat = self._sat_class(idx, 0, self.assume.lut_size - 1)
        idx = idx.clip(0, self.assume.lut_size - 1)
        self.sites.append(Site(f"{name}.idx", "lut_clamp", 64, idx, sat=sat))
        if idx.hi > len(table) - 1 or idx.lo < 0:
            self._find("q-lut-bounds", f"{name}.idx",
                       f"clamped index range {idx} escapes the "
                       f"{len(table)}-entry table")
            idx = idx.clip(0, len(table) - 1)
        sl = np.asarray(table)[idx.lo:idx.hi + 1]
        return Interval(int(sl.min()), int(sl.max()))

    def add(self, name: str, a: Interval, b: Interval, bits: int) -> Interval:
        return self._site(name, "add", a.add(b), bits)

    def sub(self, name: str, a: Interval, b: Interval, bits: int) -> Interval:
        return self._site(name, "sub", a.sub(b), bits)

    def mul(self, name: str, a: Interval, b: Interval, bits: int) -> Interval:
        return self._site(name, "mul", a.mul(b), bits)

    def neg(self, name: str, v: Interval, bits: int) -> Interval:
        if bits == 16 and v.contains(I16_MIN):
            self._find("q-int16-neg", name,
                       f"negating {v} can produce {-I16_MIN}, which "
                       f"overflows int16 (INT16_MIN negation hazard)")
        return self._site(name, "neg", v.neg(), bits)

    def shr(self, name: str, v: Interval, n: int, bits: int,
            arith_ok: bool, record: bool = True) -> Interval:
        if not 0 <= n <= 63:
            self._find("q-shift-neg", name,
                       f"shift amount {n} outside [0, 63]")
            n = min(max(n, 0), 63)
        if v.lo < 0 and not arith_ok:
            self._find("q-shift-neg", name,
                       f"right shift of possibly-negative {v} outside the "
                       f"documented arithmetic-shift primitives")
        out = v.shr(n)
        if record:
            self._site(name, "asr", out, bits)
        return out

    def clip(self, name: str, v: Interval, lo: int, hi: int,
             bits: int) -> Interval:
        sat = self._sat_class(v, lo, hi)
        return self._site(name, "clip", v.clip(lo, hi), bits, sat=sat)

    def store16(self, name: str, v: Interval) -> Interval:
        """The single int16 store-rounding: sat16 then the state slot."""
        sat = self._sat_class(v, I16_MIN, I16_MAX)
        return self._site(name, "sat16_store", v.clip(I16_MIN, I16_MAX),
                          self.assume.width("state"), sat=sat)


def analyze_image(img: DeployImage, assume: Assumptions | None = None,
                  plan=None, name: str = "image") -> dict[str, Any]:
    """Abstractly execute one full step + head of the integer program
    packed in ``img`` and return the target record for the report.

    ``plan`` injection exists for the mutation fixtures (tampered
    requants); production callers let ``plan_from_image`` derive it,
    which is exactly what the qvm and ``emit_c`` execute.
    """
    assume = assume or Assumptions()
    p = plan if plan is not None else plan_from_image(img)
    m = Machine(assume)
    x = m._site("x", "input", assume.x, 16)
    h = m._site("h", "state", assume.h, assume.width("state"))
    wide = assume.width("wide")

    # -- recurrence: pre-activations ------------------------------------
    if p.low_rank:
        t1 = m.fine("w2", p.rq["w2"], m.matvec("w2", p.w["W2"].T, x))
        wx = m.fine("w1", p.rq["w1"], m.matvec("w1", p.w["W1"], t1))
        t2 = m.fine("u2", p.rq["u2"], m.matvec("u2", p.w["U2"].T, h))
        uh = m.fine("u1", p.rq["u1"], m.matvec("u1", p.w["U1"], t2))
    else:
        wx = m.fine("w", p.rq["w"], m.matvec("w", p.w["W"], x))
        uh = m.fine("u", p.rq["u"], m.matvec("u", p.w["U"], h))
    # C: `pre[i] = fg_fine(aw, ...) + fg_fine(au, ...)` — an int32 sum
    pre = m.add("pre", wx, uh, assume.width("fine"))

    # -- activations -----------------------------------------------------
    bz = m.const_table("const.bz_q", p.bz_q, 32)
    bh = m.const_table("const.bh_q", p.bh_q, 32)
    # C: `fg_lut(FG_SIG_LUT, pre[i] + FG_READ32(FG_BZ_Q, i))` — the sum
    # is computed in int before the call
    z_in = m.add("act.z_in", pre, bz, assume.width("fine"))
    h_in = m.add("act.ht_in", pre, bh, assume.width("fine"))
    z = m.lut("act.z", z_in, p.lut_m, p.lut_sh, p.sig_lut)
    ht = m.lut("act.ht", h_in, p.lut_m, p.lut_sh, p.tanh_lut)

    # -- gate combine, single int16 store-rounding -----------------------
    one_minus_z = m.sub("gate.one_minus_z", Interval.const(Q15_ONE), z, 32)
    g2 = m.add("gate.g2",
               m.mul("gate.zeta_term", Interval.const(p.zeta_q),
                     one_minus_z, wide),
               Interval.const(p.nu2_q), wide)
    g2ht = m.mul("gate.g2ht", g2, ht, wide)
    a_f = m.requant("gate", p.rq_gate, g2ht)
    zh = m.mul("gate.zh", z, h, wide)
    h_f = m.add("gate.hf", a_f, zh, wide)
    h_f = m.clip("gate.hf_clip", h_f, -(1 << 31), (1 << 31) - 1, wide)
    h_store = m.requant("hstore", p.rq_hstore, h_f)
    h_new = m.store16("h_next", h_store)

    # -- head -------------------------------------------------------------
    acc = m.matvec("head", p.w["head_w"].T, h)
    # C: `(int32_t)(acc >> FG_LOGIT_SH) + FG_READ32(FG_HEADB_Q, c)` —
    # the narrowing cast happens BEFORE the bias add, so the shifted
    # accumulator must itself fit int32
    shifted = m.shr("head.shift", acc, p.logit_sh,
                    assume.width("logits"), arith_ok=True)
    hb = m.const_table("const.headb_q", p.headb_q, 32)
    m.add("head.logits", shifted, hb, assume.width("logits"))

    # the int16 store saturation closes the h -> h' loop: the abstract
    # post-state re-establishes the assumed pre-state invariant
    state_closed = h_new.lo >= assume.h.lo and h_new.hi <= assume.h.hi
    if not state_closed:
        m._find("q-acc-width", "h_next",
                f"post-step state {h_new} escapes the assumed state "
                f"interval {assume.h} — loop invariant broken")

    sat_reach = sorted(s.name for s in m.sites if s.sat == "reachable")
    sat_dead = sorted(s.name for s in m.sites if s.sat == "dead")
    return {
        "name": name,
        "bits": int(img.bits),
        "low_rank": bool(p.low_rank),
        "arch": {"d": p.d, "H": p.H, "C": p.C,
                 "rank_w": p.rank_w, "rank_u": p.rank_u},
        "checks": sorted(QLINT_CHECKS),
        "n_sites": len(m.sites),
        "sites": [s.to_dict() for s in m.sites],
        "saturation": {"reachable": sat_reach, "dead": sat_dead},
        "state_closed": state_closed,
        "findings": [f.to_dict() for f in m.findings],
        "proved_overflow_free": not m.findings,
    }


def reference_targets(seeds: tuple[int, ...] = (0,), *,
                      device: str = "cuda") -> list[dict[str, Any]]:
    """The gate's default subjects: the reference Q15 and Q7
    ``ModelArtifact``s of :func:`repro_torch.deploy.goldens.\
build_reference_artifact` (init from a CPU ``torch.Generator`` seeded
    each seed, PTQ on ``device``), lowered to images and proven end to
    end."""
    from repro_torch.deploy.goldens import build_reference_artifact
    from repro_torch.deploy.image import build_image
    targets = []
    for seed in seeds:
        for bits, label in ((15, "q15"), (7, "q7")):
            art = build_reference_artifact(seed=seed, bits=bits,
                                           device=device)
            img = build_image(art)
            targets.append(analyze_image(
                img, name=f"reference-{label}-s{seed}"))
    return targets
