"""LUT activations (paper Sec. III-E, Appendix C).

256-entry tables over [-8, +8], each entry sampled at the *center* of its
bucket (the (i + 0.5) offset).  Inputs outside the domain saturate (sigmoid,
tanh) or follow a linear tail (silu, gelu, softplus).  The tables are
generated in float64 numpy and cast to float32, exactly as the reference
``repro.core.lut.make_lut`` does, so they are bitwise equal to the
reference's tables.

:func:`lut_eval` is the torch evaluator with both modes of the reference:
``"nearest"`` (the deployed Appendix-C runtime) and ``"lerp"`` (Sec.
III-E's interpolation between bucket centres).  It is the plain version of
the CUDA kernel ``csrc/lut_act.cu`` (:mod:`repro_torch.kernels.lut_act`).
The batched and scalar runtimes keep their own nearest-bucket copies
(``kernels/fastgrnn_cell/qstep.py``, ``core/qruntime.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LUT_SIZE = 256
INPUT_MIN = -8.0
INPUT_MAX = 8.0
BUCKET_WIDTH = (INPUT_MAX - INPUT_MIN) / LUT_SIZE
LUT_INPUT_SCALE = 1.0 / BUCKET_WIDTH

MODES = ("nearest", "lerp")


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


_GENERATORS = {
    "sigmoid": _np_sigmoid,
    "tanh": np.tanh,
    "silu": lambda x: x * _np_sigmoid(x),
    "gelu": lambda x: 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                               * (x + 0.044715 * x**3))),
    "softplus": lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0),
}

#: Unbounded functions (~x above the domain, ~0 below): outside [lo, hi]
#: :func:`lut_eval` returns x or 0 instead of a table end.
_LINEAR_TAILS = {"silu", "gelu", "softplus"}


def make_lut(fn: str, size: int = LUT_SIZE, lo: float = INPUT_MIN,
             hi: float = INPUT_MAX) -> torch.Tensor:
    """Bucket-center table (Appendix C) as a (size,) float32 CPU tensor."""
    bw = (hi - lo) / size
    centers = lo + (np.arange(size) + 0.5) * bw
    return torch.from_numpy(_GENERATORS[fn](centers).astype(np.float32))


def lut_constants(size: int, lo: float, hi: float) -> tuple[float, float,
                                                            float, float]:
    """``(lo, hi, bw, 1/bw)`` as the exact values of the float32 numbers the
    reference computes with: ``bw = (hi - lo) / size`` and ``1 / bw`` in
    float64, each rounded to float32 where it meets the float32 input."""
    bw = (hi - lo) / size
    return tuple(float(np.float32(v)) for v in (lo, hi, bw, 1.0 / bw))


def lut_eval(table: torch.Tensor, x: torch.Tensor, *, lo: float = INPUT_MIN,
             hi: float = INPUT_MAX, mode: str = "nearest",
             linear_tail: bool = False) -> torch.Tensor:
    """Elementwise LUT activation of ``x`` (any shape, float32 or bfloat16;
    the result has ``x``'s dtype), on ``x``'s device.

    - ``x <= lo`` -> ``table[0]`` (linear tail: 0);
      ``x >= hi`` -> ``table[-1]`` (linear tail: x);
    - else ``"nearest"``: ``table[int((x - lo) * (1/bw))]``, the index
      truncated toward zero and clamped; ``"lerp"``: with ``pos = (x - lo)
      / bw - 0.5``, ``i0 = clamp(floor(pos))``, ``i1 = clamp(i0 + 1)`` and
      ``f = clamp(pos - i0, 0, 1)``: ``(1 - f) * table[i0] + f * table[i1]``.

    Special values: NaN gives ``table[0]`` in ``"nearest"`` (its index
    converts to 0 after the clamp; the tail tests are false) and NaN in
    ``"lerp"`` (the clamp of ``f`` passes NaN through); +-inf take the
    tails.  Every constant is a float32 0-dim tensor on ``x``'s device:
    on CUDA, PyTorch computes ``a / b`` with ``b`` a CPU scalar as ``a *
    (1/b)``, which is not ``(x - lo) / bw`` for every ``bw``."""
    if mode not in MODES:
        raise ValueError(f"unknown LUT mode {mode!r}")
    size = table.shape[0]
    dev = x.device
    table = table.to(dev, torch.float32)
    c_lo, c_hi, c_bw, c_inv = (torch.tensor(v, dtype=torch.float32,
                                            device=dev)
                               for v in lut_constants(size, lo, hi))
    xf = x.to(torch.float32)
    if mode == "nearest":
        idx = ((xf - c_lo) * c_inv).to(torch.int32).clamp(0, size - 1)
        y = table[idx.long()]
    else:
        pos = (xf - c_lo) / c_bw - 0.5
        i0 = torch.floor(pos).to(torch.int32).clamp(0, size - 1)
        i1 = (i0 + 1).clamp(0, size - 1)
        frac = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)
        y = (1.0 - frac) * table[i0.long()] + frac * table[i1.long()]
    above, below = xf >= c_hi, xf <= c_lo
    if linear_tail:
        y = torch.where(above, xf, torch.where(below, 0.0, y))
    else:
        y = torch.where(above, table[size - 1], torch.where(below, table[0], y))
    return y.to(x.dtype)


def lut_sigmoid(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    return lut_eval(make_lut("sigmoid"), x, mode=mode)


def lut_tanh(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    return lut_eval(make_lut("tanh"), x, mode=mode)


@dataclasses.dataclass(frozen=True)
class LUTActivations:
    """A set of generated tables with an evaluator: ``acts("tanh", x)``."""
    size: int = LUT_SIZE
    lo: float = INPUT_MIN
    hi: float = INPUT_MAX
    mode: str = "nearest"  # "nearest" (Appendix C) | "lerp" (Sec. III-E)

    def table(self, fn: str) -> torch.Tensor:
        return make_lut(fn, self.size, self.lo, self.hi)

    def __call__(self, fn: str, x: torch.Tensor) -> torch.Tensor:
        return lut_eval(self.table(fn), x, lo=self.lo, hi=self.hi,
                        mode=self.mode, linear_tail=fn in _LINEAR_TAILS)


def make_lut_q15(fn: str, size: int = LUT_SIZE, lo: float = INPUT_MIN,
                 hi: float = INPUT_MAX) -> torch.Tensor:
    """Bucket-center table quantized to int16 Q15 (value = q / 32767), the
    storage format of the pure-integer deployment path.  Only for
    functions bounded by [-1, 1]."""
    if fn in _LINEAR_TAILS:
        raise ValueError(f"{fn!r} is unbounded; Q15 unit-scale LUT needs "
                         "|f|<=1")
    f = make_lut(fn, size, lo, hi).numpy().astype(np.float64)
    return torch.from_numpy(
        np.clip(np.round(f * 32767.0), -32768, 32767).astype(np.int16))


def flash_bytes(n_tables: int = 2, size: int = LUT_SIZE,
                itemsize: int = 4) -> int:
    """Paper: 'The two tables together occupy 2 KB of Flash'."""
    return n_tables * size * itemsize


def max_abs_error(fn: str, mode: str = "nearest", n: int = 100_000) -> float:
    """Worst-case LUT error over the domain against the float64 function."""
    xs = np.linspace(INPUT_MIN, INPUT_MAX, n).astype(np.float32)
    ref = _GENERATORS[fn](xs.astype(np.float64))
    got = lut_eval(make_lut(fn), torch.from_numpy(xs), mode=mode).numpy()
    return float(np.max(np.abs(got - ref)))
