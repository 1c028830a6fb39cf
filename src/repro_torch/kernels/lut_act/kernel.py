"""Wrapper of the hand-written CUDA LUT-activation kernel.

:class:`LUTAct` (``csrc/lut_act.cu``) replaces
``repro/kernels/lut_act/kernel.py::_lut_kernel`` (the Pallas TPU kernel
behind ``lut_act_2d``): an elementwise 256-entry LUT activation, float32 or
bfloat16 in and out, nearest or bucket-centre lerp, saturating or linear
tails, bitwise equal to its plain version ``core.lut.lut_eval``.  The
kernel is bound by HBM bytes (x read once, y written once); the table sits
in shared memory.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import lut
from repro_torch.kernels import _build
from repro_torch.kernels.guard import refuse_grad

KERNEL = "lut_act"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, ctypes.c_int64, _I,        # x out n dtype
             _P, _I, _F, _F, _F, _F,            # table size lo hi bw 1/bw
             _I, _I, _P]                        # lerp linear_tail stream


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lut_act_launch.argtypes = _ARGTYPES
    lib.lut_act_launch.restype = _I
    lib.lut_act_error_string.argtypes = [_I]
    lib.lut_act_error_string.restype = ctypes.c_char_p
    return lib


class LUTAct:
    """``act(x, fn, mode=..., lo=..., hi=...)``: the LUT activation of
    ``fn`` over a float32 or bfloat16 tensor, on ``x``'s device, in
    ``x``'s dtype and shape.  Every instance shares one table cache, keyed
    by (fn, lo, hi, device), so each table is generated and uploaded once.
    ``launches`` counts kernel launches of every instance, and only those:
    the CPU plain path does not count."""

    launches = 0
    _lib = None
    _tables: dict = {}

    @classmethod
    def table(cls, fn: str, lo: float, hi: float,
              device: torch.device) -> torch.Tensor:
        key = (fn, lo, hi, torch.device(device))
        if key not in cls._tables:
            cls._tables[key] = lut.make_lut(fn, lut.LUT_SIZE, lo, hi).to(
                device)
        return cls._tables[key]

    def plain(self, x: torch.Tensor, fn: str, *, mode: str = "nearest",
              lo: float = lut.INPUT_MIN, hi: float = lut.INPUT_MAX
              ) -> torch.Tensor:
        """The plain PyTorch version on ``x``'s device (no launch)."""
        return lut.lut_eval(self.table(fn, lo, hi, x.device), x, lo=lo,
                            hi=hi, mode=mode,
                            linear_tail=fn in lut._LINEAR_TAILS)

    def __call__(self, x: torch.Tensor, fn: str, *, mode: str = "nearest",
                 lo: float = lut.INPUT_MIN, hi: float = lut.INPUT_MAX
                 ) -> torch.Tensor:
        refuse_grad(KERNEL, x)
        if x.dtype not in _DTYPES:
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        if mode not in lut.MODES:
            raise ValueError(f"unknown LUT mode {mode!r}")
        if x.device.type == "cpu":
            return self.plain(x, fn, mode=mode, lo=lo, hi=hi)
        if x.device.type != "cuda":
            raise ValueError(f"x is on {x.device}: cpu or cuda")
        if LUTAct._lib is None:
            LUTAct._lib = _bind(_build.load(KERNEL))
        x = x.contiguous()
        out = torch.empty_like(x)
        table = self.table(fn, lo, hi, x.device)
        c_lo, c_hi, c_bw, c_inv = lut.lut_constants(table.shape[0], lo, hi)
        err = self._lib.lut_act_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
            table.data_ptr(), table.shape[0], c_lo, c_hi, c_bw, c_inv,
            int(mode == "lerp"), int(fn in lut._LINEAR_TAILS),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            msg = self._lib.lut_act_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed ({err}): {msg}")
        LUTAct.launches += 1
        return out
