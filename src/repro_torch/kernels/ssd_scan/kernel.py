"""Wrapper of the hand-written CUDA SSD scan, and its plain version.

:class:`SSDScan` (``csrc/ssd_scan.cu``) replaces
``repro/kernels/ssd_scan/kernel.py::_ssd_kernel`` (the Pallas TPU kernel
behind ``ssd_scan_heads``): the Mamba-2 chunked scan of one (batch, head)
per program, in the reference's per-head layout: x (BH, S, P), dt (BH, S,
1) and A (BH, 1) float32, B and C (BH, S, N), float32 or bfloat16 -> y
(BH, S, P) in x's dtype and the final state (BH, N, P) float32, from a
zero state.  :func:`plain` computes the same function chunk by chunk in
PyTorch; the two differ only in the order of the float32 sums, so they
are held to a tolerance (the reference's 1e-4), not bitwise.

On the card one call enqueues three kernels, in order: P1 the chunk
states, parallel over (head, chunk, tile of N x P), which also writes each
chunk's cumsum (in :func:`chunk_cumsum`'s order) to a scratch; P2 the
pass over the chunks that carries the state; P3 the outputs, parallel
over (head, chunk, 64-row tile, tile of P).  With bfloat16 inputs every
product runs on the tensor cores with float32 sums (C B^T as it is, the
float32 operands M, H and B * w as three exact bfloat16 parts each); with
float32 inputs the phases use one FMA per multiply-add.  The wrapper
allocates the float32 scratch (the cumsums, (BH, S), and the chunk
states, (BH, ceil(S / chunk), N, P)); :meth:`SSDScan.plan` reports each
phase's grid and shared memory.  The function is bound by its
multiply-adds, in bfloat16 on the tensor cores just above its bytes (see
the source).

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernels or raises.  There is no fallback from one to the
other.  On ``meta`` tensors (a dry-run's stand-ins: shapes and dtypes, no
storage) it runs the plain version's ops too, so that a tracer counts the
scan's FLOPs and bytes; nothing is computed and no kernel runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import refuse_grad

KERNEL = "ssd_scan"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128               # the kernel's largest N

_P = ctypes.c_void_p
_I = ctypes.c_int
# ssd_scan_launch(x, dt, A, B, C, y, state, cs, hc, dtype, BH, S, P, N, Q,
# stream): cs (BH, S) and hc (BH, ceil(S / Q), N, P) are float32 scratch
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P,     # x dt A B C y state
             _P, _P,                         # cs hc (scratch)
             _I, _I, _I, _I, _I, _I, _P]     # dtype BH S P N Q stream
PHASES = ("P1 chunk state", "P2 state pass", "P3 chunk output")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ssd_scan_launch.argtypes = _ARGTYPES
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_plan.argtypes = [_I, _I, _I, _I, _I, _I,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.ssd_scan_plan.restype = _I
    lib.ssd_scan_error_string.argtypes = [_I]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def chunk_cumsum(dA: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over dim 1, added left to right in float32, one
    position at a time: the kernel's order, so the decays agree bit for bit
    on every device (``torch.cumsum`` sums in float64 on the CPU and in
    another float32 order on the card, and at a chunk's |cs| of a few
    hundred one float32 ulp of cs is a few 1e-5 of every decay)."""
    if dA.device.type == "meta":
        return torch.cumsum(dA, dim=1)       # a shape: there are no values
    cs = torch.empty_like(dA)
    run = torch.zeros_like(dA[:, 0])
    for i in range(dA.shape[1]):
        run = run + dA[:, i]
        cs[:, i] = run
    return cs


def plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          B: torch.Tensor, C: torch.Tensor, *, chunk: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version on x's device, ``_ssd_kernel``'s function
    for every (batch, head) at once, chunk by chunk in order; the ragged
    last chunk is simply shorter (no padding).  Products and sums in
    float32, the cumsum in the kernel's order (:func:`chunk_cumsum`), y
    rounded to x's dtype once.  On the card it needs
    TF32 off for matmuls (``torch.backends.cuda.matmul.allow_tf32``, off
    by default)."""
    bh, s, p = x.shape
    n = B.shape[2]
    a = A.reshape(bh, 1).float()
    state = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        q = sl.stop - c0
        xq = x[:, sl].float()                          # (bh, q, P)
        dtq = dt[:, sl, 0].float()                     # (bh, q)
        bq, cq = B[:, sl].float(), C[:, sl].float()    # (bh, q, N)
        cs = chunk_cumsum(dtq * a)
        # the decay L[i, j] = exp(cs_i - cs_j) for i >= j, clamped before
        # the exp where i < j (cs_i - cs_j > 0 there and would overflow)
        li = cs[:, :, None] - cs[:, None, :]
        mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        ldec = torch.exp(torch.where(mask, li, torch.full_like(li, -1e30)))
        scores = cq @ bq.transpose(1, 2)
        m = scores * ldec * dtq[:, None, :]
        y_diag = m @ xq
        y_off = torch.exp(cs)[:, :, None] * (cq @ state)
        y[:, sl] = (y_diag + y_off).to(x.dtype)
        w = torch.exp(cs[:, -1:] - cs) * dtq
        state = (torch.exp(cs[:, -1])[:, None, None] * state
                 + (bq * w[:, :, None]).transpose(1, 2) @ xq)
    return y, state


class SSDScan:
    """``scan(x, dt, A, B, C, chunk=...)`` in the per-head layout above,
    all on one device -> ``(y, state)``.  ``launches`` counts kernel
    launches of every instance, and only those: the CPU plain path does
    not count."""

    launches = 0
    _lib = None

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        refuse_grad(KERNEL, x, dt, A, B, C)
        if x.dtype not in _DTYPES or x.ndim != 3:
            raise TypeError(f"x must be (BH, S, P) float32 or bfloat16, got "
                            f"{x.dtype} {tuple(x.shape)}")
        bh, s, p = x.shape
        if B.dtype != x.dtype or C.dtype != x.dtype:
            raise TypeError(f"B and C must have x's dtype {x.dtype}, got "
                            f"{B.dtype} and {C.dtype}")
        if B.ndim != 3 or B.shape[:2] != (bh, s) or C.shape != B.shape:
            raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} "
                             f"must both be (BH, S, N) = ({bh}, {s}, N)")
        n = B.shape[2]
        if dt.dtype != torch.float32 or tuple(dt.shape) != (bh, s, 1):
            raise TypeError(f"dt must be ({bh}, {s}, 1) float32, got "
                            f"{dt.dtype} {tuple(dt.shape)}")
        if A.dtype != torch.float32 or tuple(A.shape) != (bh, 1):
            raise TypeError(f"A must be ({bh}, 1) float32, got {A.dtype} "
                            f"{tuple(A.shape)}")
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if not x.device == dt.device == A.device == B.device == C.device:
            raise ValueError("x, dt, A, B and C must lie on one device")
        if x.device.type in ("cpu", "meta"):
            return plain(x, dt, A, B, C, chunk=chunk)
        if x.device.type != "cuda":
            raise ValueError(f"x is on {x.device}: cpu or cuda")
        if not 1 <= n <= MAX_STATE:
            raise ValueError(f"state size N={n}: the kernel takes 1..."
                             f"{MAX_STATE}")
        if SSDScan._lib is None:
            SSDScan._lib = _bind(_build.load(KERNEL))
        x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
        y = torch.empty_like(x)
        f32 = dict(dtype=torch.float32, device=x.device)
        state = torch.empty((bh, n, p), **f32)
        cs = torch.empty((bh, s), **f32)
        hc = torch.empty((bh, -(-s // chunk), n, p), **f32)
        err = self._lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), cs.data_ptr(),
            hc.data_ptr(), _DTYPES[x.dtype], bh, s, p, n, chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            msg = self._lib.ssd_scan_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed ({err}): {msg}")
        if bh:
            SSDScan.launches += 1
        return y, state

    def plan(self, dtype: torch.dtype, bh: int, s: int, p: int, n: int, *,
             chunk: int) -> list[dict]:
        """What a launch at these sizes runs on the current card, one dict
        per phase (:data:`PHASES`): ``blocks``, ``threads`` a block,
        ``smem`` bytes of shared memory a block and ``per_sm``, the blocks
        an SM holds at once.  Launches nothing; needs the card (the
        occupancy is the card's answer)."""
        if dtype not in _DTYPES:
            raise TypeError(f"plan: dtype {dtype}: float32 or bfloat16")
        if not torch.cuda.is_available():
            raise RuntimeError("plan: the occupancy comes from a CUDA card, "
                               "and there is none")
        if SSDScan._lib is None:
            SSDScan._lib = _bind(_build.load(KERNEL))
        out = (ctypes.c_int * 12)()
        err = self._lib.ssd_scan_plan(_DTYPES[dtype], bh, s, p, n, chunk, out)
        if err != 0:
            msg = self._lib.ssd_scan_error_string(err).decode()
            raise ValueError(f"plan: the kernel does not take bh={bh}, s={s}, "
                             f"p={p}, n={n}, chunk={chunk} ({msg})")
        return [dict(phase=name, blocks=out[4 * k], threads=out[4 * k + 1],
                     smem=out[4 * k + 2], per_sm=out[4 * k + 3])
                for k, name in enumerate(PHASES)]
