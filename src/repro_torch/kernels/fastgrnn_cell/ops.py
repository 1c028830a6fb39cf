"""Entry points of the FastGRNN cell kernels:

* :func:`fastgrnn_window_kernel` — the fused FP32 full-window scan (the
  evaluation batch path and the third execution path of the paper's
  Table VI agreement);
* ``Q15StreamStep`` — the batched single-step path for multi-stream
  streaming inference (``serve/streaming.py``): one Q15 FastGRNN step for
  thousands of independent hidden states at once.

The window scan runs :func:`qstep.window_scan` on ``device="cpu"`` and the
CUDA kernel ``csrc/fastgrnn_window.cu`` on ``"cuda"`` (the default), with
no padding to the TPU's (8, 128) tiles.

The device decides the path: ``device="cpu"`` runs the plain torch
``qstep.step_batched`` (bit-exact, what the tests use), ``device="cuda"``
(the default) runs the hand-written CUDA kernel through
:class:`~repro_torch.kernels.fastgrnn_cell.kernel.FastGRNNStep`.  Both are
bitwise equal to the scalar ``core/qruntime.QRuntime``.  ``mxu=True``
selects the reference's dense layout instead
(:class:`~repro_torch.kernels.fastgrnn_cell.kernel.DenseStep`: plain
``qstep.step_dense`` on the CPU, ``csrc/q15_step_dense.cu`` on the card),
which is within 1e-6 of the Q15 step per step and stores no activation in
Q15.  Asking for CUDA without a card raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.roofline import FP32_FLOP_PER_S, HBM_BYTES_PER_S
from repro_torch.obs.transfers import TransferLedger
from . import qstep
from .kernel import WindowScan, make_fastgrnn_step

#: H100 SXM data-sheet peaks used by :meth:`Q15StreamStep.roofline`: HBM3
#: bandwidth and the float32 rate of the CUDA cores (the step kernel runs
#: no tensor-core instruction), from the port's one home of them.
H100_HBM_BYTES_PER_S = HBM_BYTES_PER_S
H100_FP32_FLOPS = FP32_FLOP_PER_S


_NP = {torch.float32: np.float32, torch.bool: np.bool_}


def fastgrnn_window_kernel(params: dict, xs, *, device="cuda"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """xs: (T, B, d) -> (h_final (B, H), traj (T, B, H)) on ``device``: the
    LUT-activated (nearest, as the deployed C engine) FP32 cell over a
    whole window from h = 0, against the effective W and U of ``params``
    (a float parameter dict, numpy or tensor leaves).  On ``cuda`` it
    launches the kernel or raises; ``cpu`` runs the plain version."""
    scan = WindowScan(params, device)
    if not isinstance(xs, torch.Tensor):
        xs = torch.from_numpy(np.ascontiguousarray(xs, np.float32))
    return scan(xs.to(scan.device, torch.float32).contiguous())


def _as_tensor(a, dtype) -> torch.Tensor:
    """CPU tensor view of a numpy array / tensor (no copy when possible)."""
    if isinstance(a, torch.Tensor):
        return a.to("cpu", dtype)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=_NP[dtype]))


class Q15StreamStep:
    """Batched single-step FastGRNN over Q15 weights: the hot path of the
    streaming engine.  ``step(h, x, active)`` advances every slot whose
    ``active`` flag is set by one sample; ``head_logits`` maps any subset of
    slot states to classifier logits (emission time only, host-side).

    On ``cuda`` the hidden-state table lives on the card (``*_device``
    methods, :meth:`step_resident`); only x and the active mask cross
    host-to-device each tick, and ``step``/``step_rows`` (host state
    tables) raise.  Every crossing is booked in ``self.transfers``."""

    def __init__(self, qp_or_sw, *, act_scales=None, naive_acts=False,
                 device="cuda", mxu: bool = False):
        self.device = resolve_device(device)
        if isinstance(qp_or_sw, qstep.StepWeights):
            self.sw = qp_or_sw
        else:
            self.sw = qstep.StepWeights.from_quantized(
                qp_or_sw, act_scales=act_scales, naive_acts=naive_acts)
        self.mxu = bool(mxu)
        # builds the CUDA kernel now on a card, so a build failure
        # surfaces here
        self.kernel = make_fastgrnn_step(self.sw, device=self.device, mxu=mxu)
        self.transfers = TransferLedger()
        self._host_arrs = self.sw.arrays("cpu")
        # Numeric-health seam (repro_torch.obs.numerics): when an engine sets
        # this to a mutable dict, the CPU path's gathered step tallies
        # LUT-saturation / pre-range events into it from intermediates it
        # materializes anyway (zero extra float work, byte-identical output).
        self.numeric_events = None
        self._staged = None    # CUDA event after the last x/mask h2d copy
        self._x_pin = self._m_pin = self._x_host = None

    # -- state management ---------------------------------------------------
    @property
    def hidden_dim(self) -> int:
        return self.sw.hidden_dim

    @property
    def input_dim(self) -> int:
        return self.sw.input_dim

    def init_state(self, n_slots: int) -> torch.Tensor:
        return torch.zeros((n_slots, self.sw.hidden_dim), dtype=torch.float32)

    def reset(self, h: torch.Tensor, mask) -> torch.Tensor:
        """Zero the hidden state of every host slot whose mask bit is set."""
        m = _as_tensor(mask, torch.bool)
        return torch.where(m[:, None], torch.zeros((), dtype=torch.float32), h)

    def head_logits(self, h) -> torch.Tensor:
        """Classifier logits for host slot states, (S, H) -> (S, C), via the
        fixed-order f32 head matvec on the CPU (bit-identical to
        ``qruntime.run_window``)."""
        return qstep.logits_batched(self._host_arrs, self.sw,
                                    _as_tensor(h, torch.float32))

    # -- device-resident state (cuda) ----------------------------------------
    @property
    def supports_device_state(self) -> bool:
        return self.device.type == "cuda"

    def init_state_device(self, n_slots: int) -> torch.Tensor:
        """Zero-initialized (S, H) resident state, created on the card (no
        host upload to account)."""
        return torch.zeros((n_slots, self.sw.hidden_dim), dtype=torch.float32,
                           device=self.device)

    def to_device(self, h) -> torch.Tensor:
        """Upload a host (S, H) state table (booked as h-state h2d)."""
        h = _as_tensor(h, torch.float32)
        self.transfers.h2d(h.numel() * 4, state=True)
        return h.to(self.device)

    def to_host(self, h_dev: torch.Tensor) -> np.ndarray:
        """Download the full resident table (snapshot/debug path)."""
        out = h_dev.cpu().numpy()
        self.transfers.d2h(out.nbytes, state=True)
        return out

    def rows_to_host(self, h_dev: torch.Tensor, rows) -> np.ndarray:
        """Pull only ``rows`` of the resident state to host (emission, taps,
        snapshots): a (k, H) d2h instead of the full table."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=h_dev.device)
        out = h_dev.index_select(0, idx).cpu().numpy()
        self.transfers.d2h(out.nbytes, state=True)
        return out

    def set_rows_device(self, h_dev: torch.Tensor, rows, values) -> torch.Tensor:
        """Patch ``rows`` of the resident state with host values (migration
        restore): a (k, H) h2d.  Returns a new tensor; ``h_dev`` is left
        as it was, so identity-keyed row caches stay valid."""
        values = _as_tensor(values, torch.float32)
        self.transfers.h2d(values.numel() * 4, state=True)
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=h_dev.device)
        return h_dev.index_copy(0, idx, values.to(h_dev.device))

    def reset_device(self, h_dev: torch.Tensor, mask) -> torch.Tensor:
        """Device-side :meth:`reset`: only the (S,) mask crosses h2d."""
        m = _as_tensor(mask, torch.bool)
        self.transfers.h2d(m.numel())
        m = m.to(h_dev.device)
        return torch.where(m[:, None], torch.zeros((), device=h_dev.device),
                           h_dev)

    def concat_device(self, parts) -> torch.Tensor:
        """Device-side concat of per-shard h views (no boundary crossing)."""
        return torch.cat(list(parts), dim=0)

    def staging_buffer(self, n_slots: int) -> np.ndarray:
        """The (S, d) float32 host buffer the engine gathers x into.  On
        ``cuda`` it is a numpy view of pinned memory that
        :meth:`step_resident` copies from asynchronously; the owner must
        call :meth:`wait_staged` before writing it again."""
        shape = (n_slots, self.sw.input_dim)
        if self.device.type != "cuda":
            return np.zeros(shape, np.float32)
        self._x_pin = torch.zeros(shape, dtype=torch.float32).pin_memory()
        self._m_pin = torch.zeros(n_slots, dtype=torch.bool).pin_memory()
        self._x_host = self._x_pin.numpy()
        return self._x_host

    def wait_staged(self) -> None:
        """Block until the last :meth:`step_resident` h2d copies are done,
        so the pinned staging buffers may be overwritten."""
        if self._staged is not None:
            self._staged.synchronize()
            self._staged = None

    def step_resident(self, h_dev: torch.Tensor, x: np.ndarray,
                      active: np.ndarray) -> torch.Tensor:
        """One masked batched step over the resident state.  Returns the NEW
        device tensor immediately (the launch is asynchronous); ``h_dev`` is
        not modified.  Only x and the active mask cross h2d; h never
        touches the host.  ``x`` may be the pinned :meth:`staging_buffer`
        (then copied without a host copy) or any host array.  On the CPU
        the same call steps a CPU state table synchronously."""
        n = x.shape[0]
        if self.device.type == "cpu":
            return self.kernel(h_dev, _as_tensor(x, torch.float32),
                               _as_tensor(active, torch.bool))
        self.wait_staged()
        if self._x_pin is None or self._x_pin.shape[0] != n:
            self.staging_buffer(n)
        if x is not self._x_host:
            self._x_host[:] = x
        self._m_pin.numpy()[:] = active
        self.transfers.h2d(self._x_host.nbytes + n)
        x_dev = self._x_pin.to(self.device, non_blocking=True)
        m_dev = self._m_pin.to(self.device, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record(torch.cuda.current_stream(self.device))
        return self.kernel(h_dev, x_dev, m_dev)

    def roofline(self, stream_steps_per_sec: float) -> dict:
        """Achieved-vs-peak for the batched single step against the H100 SXM
        data sheet (HBM 3.35 TB/s, fp32 non-tensor 67 TFLOP/s), at a
        measured aggregate stream-step rate.  Counts the operations this
        layout runs for the real (H, d) cell (the dense layout multiplies
        by the pre-multiplied H x d and H x H matrices whatever the ranks)
        and the HBM bytes per stream-step (x and mask in, h in and out;
        weights and LUTs stay in shared memory)."""
        sw = self.sw
        H, d = sw.hidden_dim, sw.input_dim
        if self.mxu:
            mm = 2 * (d * H + H * H)
        elif sw.low_rank:
            rw, ru = sw.ranks
            mm = 2 * (d * rw + H * rw + H * ru + H * ru)
        else:
            mm = 2 * H * (d + H)
        flops = mm + 10 * H                  # + gate combine and LUT indexing
        bytes_per_step = 4 * (d + 2 * H) + 1
        rate = float(stream_steps_per_sec)
        return {
            "device": str(self.device),
            "mxu": self.mxu,
            "model_flops_per_stream_step": int(flops),
            "hbm_bytes_per_stream_step": int(bytes_per_step),
            "stream_steps_per_sec": rate,
            "achieved_gflops": flops * rate / 1e9,
            "peak_fraction": flops * rate / H100_FP32_FLOPS,
            "hbm_fraction": bytes_per_step * rate / H100_HBM_BYTES_PER_S,
            "memory_bound_stream_steps_per_sec":
                H100_HBM_BYTES_PER_S / bytes_per_step,
            "peak_flops": H100_FP32_FLOPS,
            "hbm_bw_bytes_per_sec": H100_HBM_BYTES_PER_S,
        }

    # -- one tick (host state, cpu) -------------------------------------------
    def _host_only(self, what: str) -> None:
        if self.device.type != "cpu":
            raise RuntimeError(
                f"Q15StreamStep.{what} steps a host state table and runs on "
                f"the cpu only; on {self.device} keep h on the card "
                "(init_state_device / to_device), advance it with "
                "step_resident and pull rows with rows_to_host")

    def step(self, h, x, active) -> torch.Tensor:
        """h: (S, H) f32, x: (S, d) f32, active: (S,) bool, host arrays ->
        h_new (S, H) as a CPU tensor.  Slots with ``active=False`` keep
        their hidden state bit for bit.  CPU only: on ``cuda`` the state
        stays on the card (:meth:`step_resident`)."""
        self._host_only("step")
        h = _as_tensor(h, torch.float32).contiguous()
        x = _as_tensor(x, torch.float32).contiguous()
        m = _as_tensor(active, torch.bool).contiguous()
        return self.kernel(h, x, m)

    def step_rows(self, h, x, active, rows=None) -> torch.Tensor:
        """Slot-program adapter for ``serve/scheduler.SlotScheduler``
        consumers: advance exactly the slots listed in ``rows`` (the
        precomputed ``np.nonzero(active)[0]``; derived here if omitted).

        Only those rows are computed — the step is row-independent, so
        the gathered computation is bit-identical to the masked full-batch
        step while skipping idle slots.  CPU only, like :meth:`step`."""
        self._host_only("step_rows")
        if rows is None:
            rows = np.nonzero(np.asarray(active))[0]
        h = _as_tensor(h, torch.float32)
        if len(rows) == 0:
            return h
        idx = torch.from_numpy(np.asarray(rows, np.int64))
        x = _as_tensor(x, torch.float32)
        h = h.clone()
        if self.mxu:
            self.tally_numeric_events(h, x, rows)
            h[idx] = self.kernel(h[idx], x[idx],
                                 torch.ones(len(idx), dtype=torch.bool))
        else:
            h[idx] = qstep.step_batched(self._host_arrs, self.sw, h[idx],
                                        x[idx], events=self.numeric_events)
        return h

    def tally_numeric_events(self, h, x, rows) -> None:
        """Numeric-health tallies for rows stepped elsewhere (a CUDA kernel
        or the dense layout): recompute their Q15 step on the host plain
        path purely to observe its intermediates, discarding the result.
        The step's output is never modified, so monitored and unmonitored
        runs stay byte-identical."""
        if self.numeric_events is None or rows is None or len(rows) == 0:
            return
        idx = torch.from_numpy(np.asarray(rows, np.int64))
        qstep.step_batched(self._host_arrs, self.sw,
                           _as_tensor(h, torch.float32)[idx],
                           _as_tensor(x, torch.float32)[idx],
                           events=self.numeric_events)
