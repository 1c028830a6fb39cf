"""Wrapper of the hand-written CUDA step kernel (``csrc/q15_step.cu``).

It replaces ``repro/kernels/fastgrnn_cell/kernel.py::_q15_step_kernel``
(the Pallas TPU kernel built by ``make_fastgrnn_step(mxu=False)``): one
masked Q15 FastGRNN step for S streams, bitwise equal to the plain
``qstep.step_batched``.

The kernel is bound by HBM bytes: per stream-step it reads x (12 B) and h
(64 B) and the mask byte and writes a fresh h (64 B), about 18.5 MB per
step at S = 131,072, so about 5.5 us at 3.35 TB/s.  It holds the
dequantized weights and both LUTs in shared memory, so they are never
re-read from HBM per row.  It writes a new output tensor rather than
updating h in place: the streaming engine keys a row cache on the identity
of the h tensor (``StreamingEngine.prefetch_h``).

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from . import qstep

KERNEL = "q15_step"

# bits of the kernel's store-enable mask, in qstep.STORE_NAMES order
_STORE_BITS = {"pre": 1, "z": 2, "h_tilde": 4, "h": 8}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,   # h x mask out S H D lr RW RU
             _P, _P, _P, _P, _F, _F, _F, _F,           # wa wb ua ub + scales
             _P, _P, _P, _P, _F, _F,                   # b_z b_h luts zeta nu
             _I, _F, _F, _F, _F,                       # store bits + scales
             _P]                                       # stream


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.q15_step_launch.argtypes = _ARGTYPES
    lib.q15_step_launch.restype = _I
    lib.q15_step_error_string.argtypes = [_I]
    lib.q15_step_error_string.restype = ctypes.c_char_p
    return lib


class FastGRNNStep:
    """The batched single-step callable ``step(h, x, mask) -> h_new``
    (h: (S, H) f32, x: (S, d) f32, mask: (S,) bool, all contiguous, on
    this step's device).  ``launches`` counts kernel launches, and only
    those: the CPU plain path does not count."""

    def __init__(self, sw: "qstep.StepWeights", device="cuda"):
        self.sw = sw
        self.device = resolve_device(device)
        self.launches = 0
        self._arrs = sw.arrays(self.device)
        if self.device.type != "cuda":
            return
        self._lib = _bind(_build.load(KERNEL))
        names = qstep.LOW_RANK_NAMES if sw.low_rank else ("W", None, "U", None)
        self._wq = [None if n is None else sw.q[n].to(self.device).contiguous()
                    for n in names]
        self._wscale = [0.0 if n is None else sw.scales[n] for n in names]
        store = 0
        self._sscale = []
        for n in ("pre", "z", "h_tilde", "h"):
            s = sw.store_scale(n)
            if s is not None:
                store |= _STORE_BITS[n]
            self._sscale.append(0.0 if s is None else s)
        self._store = store

    def _check(self, h, x, mask) -> None:
        H, d = self.sw.hidden_dim, self.sw.input_dim
        for name, t, dtype in (("h", h, torch.float32), ("x", x, torch.float32),
                               ("mask", mask, torch.bool)):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, step built for "
                                 f"{self.device}")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        S = h.shape[0]
        if h.shape != (S, H) or x.shape != (S, d) or mask.shape != (S,):
            raise ValueError(f"shapes h {tuple(h.shape)}, x {tuple(x.shape)}, "
                             f"mask {tuple(mask.shape)}; want ({S}, {H}), "
                             f"({S}, {d}), ({S},)")

    def plain(self, h, x, mask) -> torch.Tensor:
        """The plain PyTorch version on this step's device (no launch)."""
        h_new = qstep.step_batched(self._arrs, self.sw, h, x)
        return torch.where(mask[:, None], h_new, h)

    def __call__(self, h: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        self._check(h, x, mask)
        if h.device.type == "cpu":
            return self.plain(h, x, mask)
        out = torch.empty_like(h)
        S = h.shape[0]
        sw = self.sw
        rw, ru = sw.ranks
        a = self._arrs
        ptr = lambda t: None if t is None else t.data_ptr()
        err = self._lib.q15_step_launch(
            h.data_ptr(), x.data_ptr(), mask.data_ptr(), out.data_ptr(),
            S, sw.hidden_dim, sw.input_dim, int(sw.low_rank), rw, ru,
            *[ptr(t) for t in self._wq], *self._wscale,
            a["b_z"].data_ptr(), a["b_h"].data_ptr(),
            a["sig_lut"].data_ptr(), a["tanh_lut"].data_ptr(),
            sw.zeta, sw.nu, self._store, *self._sscale,
            torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            msg = self._lib.q15_step_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed ({err}): {msg}")
        self.launches += 1
        return out


def make_fastgrnn_step(sw: "qstep.StepWeights", *, device="cuda",
                       mxu: bool = False) -> FastGRNNStep:
    """Build the batched single-step callable for ``sw`` on ``device``
    (weights uploaded and the kernel built once, here).  ``mxu=True``, the
    reference's tensor-core layout, is not ported yet (ROADMAP B2)."""
    if mxu:
        raise NotImplementedError(
            "mxu=True (the dense 128-lane tensor-core step, reference "
            "_q15_step_kernel_mxu) is not ported yet: ROADMAP B2")
    return FastGRNNStep(sw, device)
