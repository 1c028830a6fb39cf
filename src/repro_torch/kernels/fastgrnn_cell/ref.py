"""Scalar-loop oracle for the batched Q15 single step."""
from __future__ import annotations

import numpy as np

from repro_torch.core.qruntime import QRuntime, _matvec


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
