"""Wrappers of the hand-written CUDA step kernels.

* :class:`FastGRNNStep` (``csrc/q15_step.cu``) replaces
  ``repro/kernels/fastgrnn_cell/kernel.py::_q15_step_kernel`` (the Pallas
  TPU kernel built by ``make_fastgrnn_step(mxu=False)``): one masked Q15
  FastGRNN step for S streams with int16 weights dequantized on use,
  bitwise equal to the plain ``qstep.step_batched``.  At the paper's width
  (H = 16, d = 3; low rank r_w = 2, r_u = 8, or full rank) with h and the
  output 16-byte aligned it runs an instantiation with every size fixed at
  compile time: the row lives in registers (no stack frame), the weights
  are read from shared memory as float4 broadcasts, and a persistent grid
  (two blocks an SM) walks over tiles of 256 rows that one thread copies
  in and out with bulk asynchronous copies, the next tile's in flight
  while the block computes this one.  Every other width or alignment runs
  the runtime-size kernel.  :meth:`FastGRNNStep.plan` reports which, with
  the grid and the kernel's registers and local memory.  The sums keep the
  plain version's order, every multiply and add is its own round-to-
  nearest instruction, and the LUT bucket is the same, so both kernels
  stay bitwise.
* :class:`DenseStep` (``csrc/q15_step_dense.cu``) replaces
  ``_q15_step_kernel_mxu`` (``make_fastgrnn_step(mxu=True)``): the same
  step against pre-multiplied effective float32 W and U and without
  activation storage, bitwise equal to the plain ``qstep.step_dense``.  At
  the paper's width (H = 16, d = 3, either rank) with h and the output
  16-byte aligned it runs K1's full-rank cell on K1's tiled persistent
  pipeline (``csrc/step_tiles.cuh``, shared by both step kernels); every
  other width or alignment runs its runtime-size kernel.
  :meth:`DenseStep.plan` reports which, as :meth:`FastGRNNStep.plan` does.
* :class:`WindowScan` (``csrc/fastgrnn_window.cu``) replaces
  ``_cell_kernel`` (``fastgrnn_window``): the fused FP32 scan over a whole
  (T, B, d) window from h = 0, writing the final h and the (T, B, H)
  trajectory, bitwise equal to the plain ``qstep.window_scan``.  It is
  bound by fp32 instructions (no FMA) about as much as by its HBM bytes
  (x in, the trajectory out); see the source.

Both step kernels are bound by HBM bytes: per stream-step they read x (12 B)
and h (64 B) and the mask byte and write a fresh h (64 B), about 18.5 MB
per step at S = 131,072, so about 5.5 us at 3.35 TB/s.  They hold the
weights and both LUTs in shared memory, so these are never re-read from
HBM per row.  They write a new output tensor rather than updating h in
place: the streaming engine keys a row cache on the identity of the h
tensor (``StreamingEngine.prefetch_h``).

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.guard import refuse_grad
from . import qstep

KERNEL = "q15_step"
DENSE_KERNEL = "q15_step_dense"
WINDOW_KERNEL = "fastgrnn_window"

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


_DENSE_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I,        # h x mask out S H D
                   _P, _P, _P, _P, _P, _P, _F, _F,    # w u b_z b_h luts zeta nu
                   _P]                                # stream


_WINDOW_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I,   # x traj h T B H D
                    _P, _P, _P, _P,               # w u b_z b_h (device)
                    _P, _P, _P, _P,               # the same on the host
                    _P, _P, _F, _F,               # luts zeta nu
                    _P]                           # stream


# what q15_step_plan and q15_step_dense_plan write, in their order
PLAN_KEYS = ("fixed", "blocks", "threads", "tile_rows", "smem", "per_sm",
             "local_bytes", "regs")
_PLAN_ARGTYPES = [_I] * 6 + [_P, _P, ctypes.POINTER(_I)]   # ... h out plan
_DENSE_PLAN_ARGTYPES = [_I] * 3 + [_P, _P, ctypes.POINTER(_I)]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.q15_step_launch.argtypes = _ARGTYPES
    lib.q15_step_launch.restype = _I
    lib.q15_step_plan.argtypes = _PLAN_ARGTYPES
    lib.q15_step_plan.restype = _I
    lib.q15_step_error_string.argtypes = [_I]
    lib.q15_step_error_string.restype = ctypes.c_char_p
    return lib


def _bind_dense(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.q15_step_dense_launch.argtypes = _DENSE_ARGTYPES
    lib.q15_step_dense_launch.restype = _I
    lib.q15_step_dense_plan.argtypes = _DENSE_PLAN_ARGTYPES
    lib.q15_step_dense_plan.restype = _I
    lib.q15_step_dense_error_string.argtypes = [_I]
    lib.q15_step_dense_error_string.restype = ctypes.c_char_p
    return lib


def _bind_window(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fastgrnn_window_launch.argtypes = _WINDOW_ARGTYPES
    lib.fastgrnn_window_launch.restype = _I
    lib.fastgrnn_window_fixed.argtypes = [_I, _I, _P, _P]
    lib.fastgrnn_window_fixed.restype = _I
    lib.fastgrnn_window_error_string.argtypes = [_I]
    lib.fastgrnn_window_error_string.restype = ctypes.c_char_p
    return lib


def _plan(step, kernel: str, S: int, *args) -> dict:
    """The answer of ``<kernel>_plan`` (:data:`PLAN_KEYS`) for S rows and
    the rest of its arguments; raises on a CPU step (the occupancy and the
    attributes are the card's answer)."""
    if step.device.type != "cuda":
        raise RuntimeError(f"plan: the kernel's plan comes from a CUDA "
                           f"card; this step is built for {step.device}")
    vals = (_I * len(PLAN_KEYS))()
    err = getattr(step._lib, f"{kernel}_plan")(S, *args, vals)
    if err != 0:
        msg = getattr(step._lib, f"{kernel}_error_string")(err).decode()
        raise ValueError(f"plan: the kernel does not take S={S} at this "
                         f"width ({msg})")
    return dict(zip(PLAN_KEYS, vals))


def _check(step, h, x, mask) -> None:
    """The contract both kernels take: contiguous float32 (S, H) h, (S, d)
    x and bool (S,) mask, all on the step's device."""
    H, d = step.sw.hidden_dim, step.sw.input_dim
    for name, t, dtype in (("h", h, torch.float32), ("x", x, torch.float32),
                           ("mask", mask, torch.bool)):
        if t.device != step.device:
            raise ValueError(f"{name} is on {t.device}, step built for "
                             f"{step.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S = h.shape[0]
    if h.shape != (S, H) or x.shape != (S, d) or mask.shape != (S,):
        raise ValueError(f"shapes h {tuple(h.shape)}, x {tuple(x.shape)}, "
                         f"mask {tuple(mask.shape)}; want ({S}, {H}), "
                         f"({S}, {d}), ({S},)")


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

    def plain(self, h, x, mask) -> torch.Tensor:
        """The plain PyTorch version on this step's device (no launch)."""
        h_new = qstep.step_batched(self._arrs, self.sw, h, x)
        return torch.where(mask[:, None], h_new, h)

    def plan(self, S: int, h: torch.Tensor, out: torch.Tensor) -> dict:
        """What a launch of S rows reading ``h`` and writing ``out`` runs on
        the current card (:data:`PLAN_KEYS`): the fixed-width code or not,
        blocks, threads a block, rows a tile, shared memory bytes, resident
        blocks an SM, and the chosen kernel's local memory (bytes a thread)
        and registers a thread.  Launches nothing; needs the card (the
        occupancy and the attributes are the card's answer)."""
        sw = self.sw
        rw, ru = sw.ranks
        return _plan(self, KERNEL, S, sw.hidden_dim, sw.input_dim,
                     int(sw.low_rank), rw, ru, h.data_ptr(), out.data_ptr())

    def fixed_width(self, h: torch.Tensor, out: torch.Tensor) -> bool:
        """Whether a launch reading ``h`` and writing ``out`` runs the
        kernel's instantiation with the sizes fixed at compile time (the
        paper's width, h and out 16-byte aligned)."""
        return bool(self.plan(h.shape[0], h, out)["fixed"])

    def __call__(self, h: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        refuse_grad(KERNEL, h, x, mask)
        _check(self, h, x, mask)
        if h.device.type == "cpu":
            return self.plain(h, x, mask)
        return self._launch(h, x, mask, torch.empty_like(h))

    def _launch(self, h, x, mask, out) -> torch.Tensor:
        """Launch the kernel into ``out`` (checked inputs on the card)."""
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


class DenseStep:
    """The dense-layout batched step ``step(h, x, mask) -> h_new``: the
    same contract as :class:`FastGRNNStep` (and the same ``launches``
    counter and ``plain``), computed against the pre-multiplied effective
    float32 W and U (``qstep.dense_weights``) with no activation storage,
    as the reference's dense layout does."""

    def __init__(self, sw: "qstep.StepWeights", device="cuda"):
        self.sw = sw
        self.device = resolve_device(device)
        self.launches = 0
        self._arrs = qstep.dense_arrays(sw, self.device)
        if self.device.type == "cuda":
            self._lib = _bind_dense(_build.load(DENSE_KERNEL))

    def plain(self, h, x, mask) -> torch.Tensor:
        """The plain PyTorch version on this step's device (no launch)."""
        return qstep.step_dense(self._arrs, h, x, mask)

    def plan(self, S: int, h: torch.Tensor, out: torch.Tensor) -> dict:
        """What a launch of S rows reading ``h`` and writing ``out`` runs on
        the current card, as :meth:`FastGRNNStep.plan` reports it.  Launches
        nothing; needs the card."""
        return _plan(self, DENSE_KERNEL, S, self.sw.hidden_dim,
                     self.sw.input_dim, h.data_ptr(), out.data_ptr())

    def fixed_width(self, h: torch.Tensor, out: torch.Tensor) -> bool:
        """Whether a launch reading ``h`` and writing ``out`` runs the
        kernel's instantiation with the sizes fixed at compile time (the
        paper's width, h and out 16-byte aligned)."""
        return bool(self.plan(h.shape[0], h, out)["fixed"])

    def __call__(self, h: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        refuse_grad(DENSE_KERNEL, h, x, mask)
        _check(self, h, x, mask)
        if h.device.type == "cpu":
            return self.plain(h, x, mask)
        return self._launch(h, x, mask, torch.empty_like(h))

    def _launch(self, h, x, mask, out) -> torch.Tensor:
        """Launch the kernel into ``out`` (checked inputs on the card)."""
        a = self._arrs
        err = self._lib.q15_step_dense_launch(
            h.data_ptr(), x.data_ptr(), mask.data_ptr(), out.data_ptr(),
            h.shape[0], self.sw.hidden_dim, self.sw.input_dim,
            a["W"].data_ptr(), a["U"].data_ptr(), a["b_z"].data_ptr(),
            a["b_h"].data_ptr(), a["sig_lut"].data_ptr(),
            a["tanh_lut"].data_ptr(), a["zeta"], a["nu"],
            torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            msg = self._lib.q15_step_dense_error_string(err).decode()
            raise RuntimeError(f"{DENSE_KERNEL} launch failed ({err}): {msg}")
        self.launches += 1
        return out


def make_fastgrnn_step(sw: "qstep.StepWeights", *, device="cuda",
                       mxu: bool = False) -> FastGRNNStep | DenseStep:
    """Build the batched single-step callable for ``sw`` on ``device``
    (weights uploaded and the kernel built once, here): the Q15 step with
    weights dequantized on use, or with ``mxu=True`` the reference's dense
    layout (:class:`DenseStep`)."""
    return (DenseStep if mxu else FastGRNNStep)(sw, device)


class WindowScan:
    """The fused window scan ``scan(xs) -> (h, traj)`` for one float
    parameter dict (numpy or tensor leaves): xs (T, B, d) float32 on this
    scan's device -> final h (B, H) and trajectory (T, B, H), from h = 0.
    ``launches`` counts kernel launches of every instance, and only those:
    the CPU plain path does not count."""

    launches = 0

    def __init__(self, params: dict, device="cuda"):
        self.device = resolve_device(device)
        self._host = qstep.window_arrays(params, "cpu")
        self._arrs = {k: v.to(self.device) if isinstance(v, torch.Tensor)
                      else v for k, v in self._host.items()}
        self.hidden_dim, self.input_dim = self._host["W"].shape
        if self.device.type == "cuda":
            self._lib = _bind_window(_build.load(WINDOW_KERNEL))

    def plain(self, xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain PyTorch version on this scan's device (no launch)."""
        return qstep.window_scan(self._arrs, xs)

    def fixed_width(self, traj: torch.Tensor, h: torch.Tensor) -> bool:
        """Whether a launch writing these tensors runs the kernel's
        instantiation with the sizes fixed at compile time (the paper's
        width)."""
        return bool(self._lib.fastgrnn_window_fixed(
            self.hidden_dim, self.input_dim, traj.data_ptr(), h.data_ptr()))

    def __call__(self, xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        refuse_grad(WINDOW_KERNEL, xs)
        if xs.device != self.device:
            raise ValueError(f"xs is on {xs.device}, scan built for "
                             f"{self.device}")
        if xs.dtype != torch.float32:
            raise TypeError(f"xs must be torch.float32, got {xs.dtype}")
        if xs.dim() != 3 or xs.shape[2] != self.input_dim:
            raise ValueError(f"xs must be (T, B, {self.input_dim}), got "
                             f"{tuple(xs.shape)}")
        if not xs.is_contiguous():
            raise ValueError("xs must be contiguous")
        if xs.device.type == "cpu":
            return self.plain(xs)
        T, B, _ = xs.shape
        H = self.hidden_dim
        traj = torch.empty((T, B, H), dtype=torch.float32, device=xs.device)
        h = torch.empty((B, H), dtype=torch.float32, device=xs.device)
        a, c = self._arrs, self._host
        err = self._lib.fastgrnn_window_launch(
            xs.data_ptr(), traj.data_ptr(), h.data_ptr(), T, B, H,
            self.input_dim, a["W"].data_ptr(), a["U"].data_ptr(),
            a["b_z"].data_ptr(), a["b_h"].data_ptr(), c["W"].data_ptr(),
            c["U"].data_ptr(), c["b_z"].data_ptr(), c["b_h"].data_ptr(),
            a["sig_lut"].data_ptr(), a["tanh_lut"].data_ptr(), a["zeta"],
            a["nu"], torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            msg = self._lib.fastgrnn_window_error_string(err).decode()
            raise RuntimeError(f"{WINDOW_KERNEL} launch failed ({err}): {msg}")
        WindowScan.launches += 1
        return h, traj
