"""End-to-end L-S-Q pipeline orchestration (paper Fig. 1), a torch copy of
the reference ``repro.core.pipeline``:

  float training -> low-rank -> IHT sparsity (cubic ramp + frozen finetune)
  -> per-tensor Q15 PTQ + activation calibration -> deterministic qruntime.

Training is eager PyTorch autograd over :mod:`repro_torch.core.fastgrnn`
on ``device`` (``"cuda"`` by default; a ``cuda`` device raises when no
card is present).  Keep TF32 off for the cell's float32 matmuls on the
card (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default).  Adam follows the reference's formula leaf by leaf (bias
corrections in float32 from a float32 step count, ``p - lr * mhat /
(sqrt(vhat) + eps)``), not ``torch.optim.Adam``'s.  Batches are drawn with
numpy exactly as the reference draws them, so both packages see the same
batches in the same order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.pytree import tree_map
from . import compression as comp
from . import fastgrnn as fg
from . import quantization as q
from .qruntime import QRuntime


@dataclasses.dataclass
class TrainResult:
    params: dict[str, Any]
    history: list[dict[str, float]]
    masks: dict[str, Any] | None = None
    # host seconds of each optimizer step, the loss read back included
    step_seconds: list[float] = dataclasses.field(default_factory=list)


def _adam_init(params):
    dev = next(iter(params.values())).device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def _adam_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    tf = t.to(torch.float32)
    bc1, bc2 = 1 - b1 ** tf, 1 - b2 ** tf

    def upd(p, m_, v_):
        mhat = m_ / bc1
        vhat = v_ / bc2
        return p - lr * mhat / (torch.sqrt(vhat) + eps)
    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}


def _value_and_grad(params, xs, ys):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = fg.loss_fn(leaves, xs, ys)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params, opt, xs, ys, *, lr: float = 1e-3, masks=None):
    """One Adam step on the cross-entropy of a (T, B, d) batch, masked
    after the update when ``masks`` is given (IHT).  Returns ``(params,
    opt, loss)``."""
    loss, grads = _value_and_grad(params, xs, ys)
    with torch.no_grad():
        params, opt = _adam_update(params, grads, opt, lr=lr)
        if masks is not None:
            params = comp.apply_masks(params, masks)
    return params, opt, loss


def train_fastgrnn(
    cfg: fg.FastGRNNConfig,
    train_windows: np.ndarray,          # (N, T, d)
    train_labels: np.ndarray,
    *,
    epochs: int = 100,
    batch_size: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    iht: comp.IHTConfig | None = None,
    eval_fn=None,
    eval_every: int = 10,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Adam training with optional in-loop IHT (paper Sec. IV-B protocol).
    The initial parameters come from a CPU ``torch.Generator`` seeded
    ``seed`` (the same start on every device); the training set goes to
    the device once and each batch is gathered there."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), fg.init_params(
        cfg, torch.Generator().manual_seed(seed)))
    opt = _adam_init(params)

    # time-major (T, N, d), resident on the device
    xs_all = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(train_windows, np.float32), (1, 0, 2))))
    xs_all = xs_all.to(dev)
    ys_all = torch.from_numpy(np.asarray(train_labels, np.int64)).to(dev)
    n = len(train_labels)
    history: list[dict[str, float]] = []
    seconds: list[float] = []
    masks = None

    for epoch in range(epochs):
        rng = np.random.default_rng(seed * 1000 + epoch)
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        if iht is not None:
            # recompute masks THROUGH epoch == ramp_epochs so the frozen
            # mask is at the full target sparsity (paper: 'reaching the
            # target sparsity at epoch 50 and remaining frozen')
            if epoch <= iht.ramp_epochs or masks is None:
                s_e = comp.sparsity_at_epoch(iht, epoch)
                masks = comp.compute_masks(params, iht, s_e)
            params = comp.apply_masks(params, masks)
        for i in range(0, n - batch_size + 1, batch_size):
            t0 = time.perf_counter()
            j = order[i:i + batch_size]
            params, opt, loss = train_step(params, opt, xs_all[:, j],
                                           ys_all[j], lr=lr, masks=masks)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
        rec = {"epoch": epoch, "loss": float(np.mean(losses))}
        if eval_fn is not None and (epoch % eval_every == 0 or epoch == epochs - 1):
            rec.update(eval_fn(params))
        history.append(rec)
    return TrainResult(params=params, history=history, masks=masks,
                       step_seconds=seconds)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def predict_fp32(params, windows: np.ndarray, batch: int = 512,
                 sigma=torch.sigmoid, tanh=torch.tanh, *,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Argmax of the float cell over (N, T, d) windows, ``batch`` at a time
    on ``device``.  ``sigma``/``tanh`` are injectable (e.g. the LUT
    activations of :mod:`repro_torch.kernels.lut_act.ops`)."""
    dev = resolve_device(device)
    p = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
         for k, v in params.items()}
    outs = []
    with torch.no_grad():
        for i in range(0, len(windows), batch):
            xs = torch.from_numpy(np.ascontiguousarray(np.transpose(
                np.asarray(windows[i:i + batch], np.float32), (1, 0, 2))))
            logits = fg.forward_window(p, xs.to(dev), sigma=sigma, tanh=tanh)
            outs.append(logits.argmax(-1).cpu().numpy())
    return np.concatenate(outs).astype(np.int32)


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int = 6) -> float:
    return float(np.mean(per_class_f1(y_true, y_pred, n_classes)))


def per_class_f1(y_true, y_pred, n_classes: int = 6) -> list[float]:
    out = []
    for c in range(n_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        denom = 2 * tp + fp + fn
        out.append(float(2 * tp / denom) if denom > 0 else 0.0)
    return out


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(y_true == y_pred))


# ---------------------------------------------------------------------------
# Deployment (compression passes -> ModelArtifact -> QRuntime)
# ---------------------------------------------------------------------------

def deploy(params, calib_windows: np.ndarray, *,
           quant: q.QuantConfig = q.QuantConfig(),
           quantize_activations: bool = False,
           naive_activations: bool = False,
           device: str | torch.device = "cuda") -> QRuntime:
    """Quantize weights (on ``device``), run the 5-minibatch calibration
    pass, return the deterministic integer runtime (the 'deployed'
    model), through the :mod:`repro_torch.compress` passes."""
    from repro_torch.compress import (CalibrateActivations, ModelArtifact,
                                      QuantizePTQ)
    art = QuantizePTQ.from_config(quant, device=device).apply(
        ModelArtifact.from_params(params))
    if naive_activations:
        return QRuntime.from_artifact(art, naive_acts=True)
    if quantize_activations:
        art = CalibrateActivations(
            windows=np.asarray(calib_windows, np.float32),
            headroom=quant.headroom, scope="storage").apply(art)
        return QRuntime.from_artifact(art, quantized_acts=True)
    # deployed config: Q15 weights + FP32 acts through LUT
    return QRuntime.from_artifact(art)


def agreement(pred_a: np.ndarray, pred_b: np.ndarray) -> float:
    return float(np.mean(pred_a == pred_b))
