"""Least times of the port's kernels at one call's shapes: the larger of
the operations the algorithm needs over the peak rate and the bytes of
its inputs and outputs, each read or written once, over the HBM rate.
Frozen copies: a later change to the program's own cost code does not
move this yardstick."""
from __future__ import annotations

import functools

from . import peaks


@functools.lru_cache(maxsize=None)
def ssd_least_ops(h: int, g: int, s: int, p: int, n: int) -> tuple:
    """The SSD scan's least operations for h heads (head dim p) over g
    groups of B and C (state size n) and s tokens (a frozen copy of
    ``chip_smoke.ssd_least_work``).  Its y and final state do not depend
    on the chunk length, so this is the chunked algorithm at the length
    that needs the least time (length 1 is the recurrence).  Per chunk of
    k rows: C B^T over its lower triangle once per group (n multiply-adds
    an entry); per head M x over the triangle (p an entry), C H and the
    state sums (n p a row each), and in float32 four operations per M
    entry (its difference, exp and two multiplies) and n p for the
    state's decay.  bfloat16 inputs put every product on the tensor cores
    at 2 FLOP a multiply-add: C B^T as it is (a product of two bfloat16
    values is exact in float32), M x, C H and the state sums as three
    exact bfloat16 parts of their float32 operand (6 FLOP).  The two units
    issue side by side, so the time is the larger of theirs.  Returns
    (seconds, chunk length, float32 instructions, tensor-core FLOP)."""
    best = None
    for q in range(1, s + 1):
        nfull, rest = divmod(s, q)
        tri = nfull * (q * (q + 1) // 2) + rest * (rest + 1) // 2
        nck = nfull + (1 if rest else 0)
        cb, mx, ch = g * tri * n, h * tri * p, 2 * h * s * n * p
        fp32 = h * (4 * tri + nck * n * p)
        flop = 2 * cb + 6 * (mx + ch)
        sec = max(fp32 / peaks.FP32_OPS_PER_S, flop / peaks.BF16_FLOP_PER_S)
        if best is None or sec < best[0]:
            best = (sec, q, fp32, flop)
    return best


def ssd_bytes(h: int, g: int, s: int, p: int, n: int, *, in_bytes=2) -> int:
    """x (s, h, p) and y in the input dtype, dt (s, h) and the A ramp (h)
    in float32, B and C (s, g, n) in the input dtype, the final state (h,
    n, p) float32."""
    return (2 * s * h * p * in_bytes + s * h * 4 + h * 4
            + 2 * s * g * n * in_bytes + h * n * p * 4)


def ssd_least_s(h: int, g: int, s: int, p: int, n: int) -> float:
    """K6's least time for one call over one sequence of s tokens."""
    return max(ssd_least_ops(h, g, s, p, n)[0],
               ssd_bytes(h, g, s, p, n) / peaks.HBM_BYTES_PER_S)


def q15_matmul_bytes(m: int, k: int, n: int, w_bytes: int = 2) -> int:
    """x (m, k) float32, the integer weights (k, n), the scale, out (m,
    n) float32."""
    return m * k * 4 + k * n * w_bytes + 4 + m * n * 4


def q15_matmul_least_s(m: int, k: int, n: int, w_bytes: int = 2) -> float:
    """K5's least time: 2 m k n FLOP on the bfloat16 tensor cores, or its
    bytes, whichever is longer."""
    return max(2 * m * k * n / peaks.BF16_FLOP_PER_S,
               q15_matmul_bytes(m, k, n, w_bytes) / peaks.HBM_BYTES_PER_S)
