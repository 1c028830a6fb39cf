"""Exact integer interval domain for the Q15 abstract interpreter, ported
from the reference ``repro.analysis.intervals``.

The analysis domain is closed integer intervals ``[lo, hi]`` over
arbitrary-precision Python ints: abstract values themselves can never
overflow, so the interpreter *computes* the true reachable range of every
accumulator and then *checks* it against the declared storage width of the
concrete program (int16 state, int32 fine intermediates, int64 matvec
accumulators — the contract shared by ``repro_torch.deploy.qvm`` and the C twin
``repro_torch.deploy.emit_c`` emits).

Every transfer function below is the exact image of the corresponding
concrete integer operation over a box:

* ``add``/``sub``/``neg``/``mul`` — standard interval arithmetic (the
  four-corner product for ``mul``);
* ``shr`` — *arithmetic* right shift (floor division by a power of two),
  the semantics both NumPy and the generated C implement; it is monotone,
  so the image of a box is the box of the images;
* ``clip`` — saturation, the image of ``np.clip`` / the C clamp idiom.

Monotone unary maps (requantization, LUT index affine) are applied at the
two endpoints by callers — exact for the same reason.  Nothing here
widens: the qvm step program is loop-free per tick and the single loop
(h -> h') is closed by the int16 store saturation, so a fixed point is
reached in one pass.
"""
from __future__ import annotations

import dataclasses

#: Named signed storage widths of the concrete program.
WIDTH_RANGE = {
    8: (-(1 << 7), (1 << 7) - 1),
    16: (-(1 << 15), (1 << 15) - 1),
    32: (-(1 << 31), (1 << 31) - 1),
    64: (-(1 << 63), (1 << 63) - 1),
}


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval ``[lo, hi]`` (exact Python ints)."""
    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    # -- constructors ----------------------------------------------------
    @staticmethod
    def const(v: int) -> "Interval":
        return Interval(int(v), int(v))

    @staticmethod
    def of_width(bits: int) -> "Interval":
        """The full range of a signed ``bits``-wide integer."""
        lo, hi = WIDTH_RANGE[bits]
        return Interval(lo, hi)

    # -- arithmetic ------------------------------------------------------
    def add(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def sub(self, other: "Interval") -> "Interval":
        return Interval(self.lo - other.hi, self.hi - other.lo)

    def neg(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def mul(self, other: "Interval") -> "Interval":
        c = (self.lo * other.lo, self.lo * other.hi,
             self.hi * other.lo, self.hi * other.hi)
        return Interval(min(c), max(c))

    def shr(self, n: int) -> "Interval":
        """Arithmetic right shift (floor; Python ``>>`` on negatives is
        already the arithmetic shift NumPy and the C engines use)."""
        if n < 0:
            raise ValueError(f"negative shift amount {n}")
        return Interval(self.lo >> n, self.hi >> n)

    def shl(self, n: int) -> "Interval":
        if n < 0:
            raise ValueError(f"negative shift amount {n}")
        return Interval(self.lo << n, self.hi << n)

    def clip(self, lo: int, hi: int) -> "Interval":
        """Saturating clamp — the image of ``np.clip(v, lo, hi)``."""
        return Interval(min(max(self.lo, lo), hi), min(max(self.hi, lo), hi))

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    # -- queries ---------------------------------------------------------
    def abs_max(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    def contains(self, v: int) -> bool:
        return self.lo <= v <= self.hi

    def fits(self, bits: int) -> bool:
        """True iff every value in the interval is representable as a
        signed ``bits``-wide integer."""
        lo, hi = WIDTH_RANGE[bits]
        return lo <= self.lo and self.hi <= hi

    def bits_needed(self) -> int:
        """Minimum signed width (in bits) that holds the whole interval:
        the proven bound the report records per instruction."""
        b = 1
        while not (-(1 << (b - 1)) <= self.lo and self.hi <= (1 << (b - 1)) - 1):
            b += 1
        return b

    def exceeds(self, lo: int, hi: int) -> bool:
        """True iff some value in the interval lies outside ``[lo, hi]``
        (i.e. a clamp to that range is *reachable*, not dead)."""
        return self.lo < lo or self.hi > hi

    def __repr__(self) -> str:  # compact in reports/messages
        return f"[{self.lo}, {self.hi}]"
