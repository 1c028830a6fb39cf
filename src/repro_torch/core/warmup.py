"""Recurrent warm-up latency characterization (paper Sec. VI-A, Fig. 8).

For each window, find the first step t* at which the per-step prediction
equals the final-window prediction AND remains stable for every subsequent
step.  The paper reports, over 100 random test windows: median 74 samples
(1.48 s at 50 Hz), IQR 40-86, worst case 125 (2.50 s).

The harness is generic over any "streaming classifier" that exposes a
per-step prediction trajectory (numpy only): the window scan's trajectories
through the classifier head, or the streaming engine's tapped ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WarmupStats:
    median_samples: float
    iqr_lo: float
    iqr_hi: float
    worst_case: int
    mean: float
    n_windows: int
    sample_rate_hz: float = 50.0

    @property
    def median_seconds(self) -> float:
        return self.median_samples / self.sample_rate_hz

    @property
    def worst_seconds(self) -> float:
        return self.worst_case / self.sample_rate_hz

    def row(self) -> str:
        return (f"median {self.median_samples:.0f} samples "
                f"({self.median_seconds:.2f} s), IQR {self.iqr_lo:.0f}-{self.iqr_hi:.0f}, "
                f"worst {self.worst_case} ({self.worst_seconds:.2f} s) "
                f"over {self.n_windows} windows")


def stabilization_step(step_preds: np.ndarray) -> int:
    """First step t* such that pred[t] == pred[-1] for all t >= t*.

    Returns a 1-based sample count (paper reports 'samples', t*=1 means the
    prediction was stable from the first sample).
    """
    final = step_preds[-1]
    mismatch = np.nonzero(step_preds != final)[0]
    if mismatch.size == 0:
        return 1
    return int(mismatch[-1]) + 2  # first stable index (0-based +1), 1-based +1


def characterize(per_step_predictions: np.ndarray, sample_rate_hz: float = 50.0) -> WarmupStats:
    """per_step_predictions: (N_windows, T) int predictions per step."""
    t_star = np.array([stabilization_step(p) for p in per_step_predictions])
    return WarmupStats(
        median_samples=float(np.median(t_star)),
        iqr_lo=float(np.percentile(t_star, 25)),
        iqr_hi=float(np.percentile(t_star, 75)),
        worst_case=int(np.max(t_star)),
        mean=float(np.mean(t_star)),
        n_windows=len(t_star),
        sample_rate_hz=sample_rate_hz,
    )


def trajectory_predictions(params, windows, head_fn, run_fn) -> np.ndarray:
    """Generic helper: run_fn(params, window)->(T,H) traj; head_fn->logits."""
    out = []
    for w in windows:
        traj = run_fn(params, w)
        logits = head_fn(params, traj)          # (T, C)
        out.append(np.argmax(np.asarray(logits), axis=-1))
    return np.stack(out)
