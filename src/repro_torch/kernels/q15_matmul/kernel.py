"""Wrapper of the hand-written CUDA quantized matmul.

:class:`Q15Matmul` (``csrc/q15_matmul.cu``) replaces
``repro/kernels/q15_matmul/kernel.py::_mm_kernel`` (the Pallas TPU kernel
behind ``q15_matmul_padded``): ``(M, K) x (K, N)`` with int8/int16
weights cast to bfloat16 inside the kernel, x rounded to bfloat16, float32
accumulation and the per-tensor scale applied once at the end.  Its plain
version :func:`plain` computes the same float32 products of the same
bfloat16 values; the two differ only in the order and rounding of the
float32 additions (the kernel's run on the tensor cores).  At the LM
engine's decode head (M <= 8 rows against a (1536, 151936) integer head)
the kernel reads every weight once, and HBM bytes bound the function for
int16 and int8 alike (see the source).  :meth:`Q15Matmul.plan` says which
of the kernel's variants a launch runs.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "q15_matmul"

_W_BITS = {torch.int8: 8, torch.int16: 16}
LOADS = ("16-byte", "8-byte", "scalar")   # how a lane reads a row of w
_OUT = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _I, _P, _P, _I,     # x w w_bits scale out out_dtype
             _I, _I, _I, _P]             # M K N stream


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.q15_matmul_launch.argtypes = _ARGTYPES
    lib.q15_matmul_launch.restype = _I
    lib.q15_matmul_plan.argtypes = [_P, _I, _P, _I, _I]   # w w_bits out M N
    lib.q15_matmul_plan.restype = _I
    lib.q15_matmul_error_string.argtypes = [_I]
    lib.q15_matmul_error_string.restype = ctypes.c_char_p
    return lib


def plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version on x's device: ``(bf16(x) @ bf16(wq)) *
    scale`` as a float32 product, cast to ``out_dtype``.  On the card it
    needs TF32 off for matmuls (``torch.backends.cuda.matmul.allow_tf32``,
    off by default)."""
    xb = x.to(torch.bfloat16).float()
    wb = wq.to(torch.bfloat16).float()
    return ((xb @ wb) * scale).to(out_dtype)


class Q15Matmul:
    """``mm(x, wq, scale, out_dtype=...)``: x (M, K) float32, wq (K, N)
    int8/int16, scale a 0-dim float32 tensor, all on one device -> (M, N)
    in ``out_dtype`` (float32 or bfloat16).  ``launches`` counts kernel
    launches of every instance, and only those: the CPU plain path does
    not count."""

    launches = 0
    _lib = None

    def __call__(self, x: torch.Tensor, wq: torch.Tensor,
                 scale: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if x.dtype != torch.float32 or x.ndim != 2:
            raise TypeError(f"x must be (M, K) float32, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if wq.dtype not in _W_BITS or wq.ndim != 2:
            raise TypeError(f"wq must be (K, N) int8/int16, got {wq.dtype} "
                            f"{tuple(wq.shape)}")
        if wq.shape[0] != x.shape[1]:
            raise ValueError(f"x {tuple(x.shape)} @ wq {tuple(wq.shape)}: "
                             "inner sizes differ")
        if scale.dtype != torch.float32 or scale.numel() != 1:
            raise TypeError("scale must be one float32 value")
        if out_dtype not in _OUT:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                            f"{out_dtype}")
        if not x.device == wq.device == scale.device:
            raise ValueError(f"x, wq and scale lie on {x.device}, "
                             f"{wq.device}, {scale.device}: one device")
        if x.device.type == "cpu":
            return plain(x, wq, scale, out_dtype=out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"x is on {x.device}: cpu or cuda")
        if Q15Matmul._lib is None:
            Q15Matmul._lib = _bind(_build.load(KERNEL))
        x, wq, scale = x.contiguous(), wq.contiguous(), scale.contiguous()
        (m, k), n = x.shape, wq.shape[1]
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        err = self._lib.q15_matmul_launch(
            x.data_ptr(), wq.data_ptr(), _W_BITS[wq.dtype], scale.data_ptr(),
            out.data_ptr(), _OUT[out_dtype], m, k, n,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            msg = self._lib.q15_matmul_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed ({err}): {msg}")
        if m and n:
            Q15Matmul.launches += 1
        return out

    def plan(self, wq: torch.Tensor, m: int) -> tuple[str, int]:
        """The kernel a launch on the CUDA tensor ``wq`` with ``m`` rows of
        x runs: how it loads the weights (``LOADS``) and how many column
        tiles a warp takes (1 or 2).  The wrapper's outputs come from
        ``torch.empty``, so they are aligned.  Launches nothing."""
        if wq.device.type != "cuda" or wq.dtype not in _W_BITS or \
                not wq.is_contiguous():
            raise ValueError("plan: wq must be a contiguous int8/int16 CUDA "
                             "tensor")
        if self._lib is None:
            Q15Matmul._lib = _bind(_build.load(KERNEL))
        code = self._lib.q15_matmul_plan(wq.data_ptr(), _W_BITS[wq.dtype],
                                         256, m, wq.shape[1])
        if code < 0:
            raise ValueError(f"plan: the kernel does not take m={m}, "
                             f"wq {tuple(wq.shape)}")
        return LOADS[code // 4], code % 4
