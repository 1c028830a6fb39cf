"""Oracles: the FP32 cell over a full window (for the window scan) and the
scalar loop (for the batched Q15 single step)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import fastgrnn as fg
from repro_torch.core.lut import lut_sigmoid, lut_tanh
from repro_torch.core.qruntime import QRuntime, _matvec


def fastgrnn_window_ref(params, xs, *, lut: bool = True,
                        mode: str = "nearest"):
    """xs: (T, B, d) -> final hidden (B, H) + trajectory (T, B, H): the
    cell of ``core/fastgrnn.py`` with the LUT activations of
    ``core/lut.py`` (``lut=False``: torch's sigmoid/tanh), on the device of
    its inputs."""
    kw = {}
    if lut:
        kw = {"sigma": lambda v: lut_sigmoid(v, mode),
              "tanh": lambda v: lut_tanh(v, mode)}
    return fg.run_sequence(params, xs, return_trajectory=True, **kw)


def q15_step_batched_ref(qp, h, x, *, act_scales=None, naive_acts=False):
    """One ``core/qruntime.QRuntime.step`` call per stream row.  h: (S, H),
    x: (S, d) -> (h_new (S, H), logits (S, C)) as numpy float32.  This is
    the paper's C-equivalent reference, so the plain step and the CUDA
    kernel must match it bit for bit."""
    rt = QRuntime(qp, act_scales=act_scales, naive_acts=naive_acts)
    h = np.asarray(h, np.float32)
    x = np.asarray(x, np.float32)
    h_new = np.stack([rt.step(h[b], x[b]) for b in range(h.shape[0])])
    logits = np.stack([
        rt._store("logits", _matvec(rt._w["head_w"].T, h_new[b]) + rt._head_b)
        for b in range(h.shape[0])])
    return h_new, logits
