"""HAPT (Human Activities and Postural Transitions) data pipeline.

A numpy-only copy of the reference package's ``repro.data.hapt``: the same
generator gives the same windows bit for bit.  This module provides:

  1. ``load_real(path)`` — loader for the canonical HAPT raw layout
     (``Train/X_train.txt`` etc.), used automatically if files exist;
  2. ``generate_synthetic(...)`` — a structured synthetic generator with the
     paper's exact geometry: tri-axial 50 Hz acceleration, 128-sample
     windows, six basic classes, subject-disjoint train/val/test splits of
     7352 / 1515 / 3399 windows.

The synthetic signal model per class (units: g, +-2 g range as in the
paper's live-sensor config):

  * static classes (SITTING, STANDING, LAYING): a fixed gravity orientation
    per class with small per-subject orientation jitter + sensor noise;
  * dynamic classes (WALKING, UPSTAIRS, DOWNSTAIRS): gravity + gait
    fundamental (1.4-2.2 Hz, per-subject cadence) with class-specific
    harmonic mix, vertical-axis asymmetry for stairs (UP: stronger first
    harmonic; DOWN: impact spikes - the class the literature finds hardest);
  * all classes: AR(1) sensor noise + slow baseline drift.

Subject-disjointness: 30 synthetic subjects with per-subject cadence,
orientation offset and noise level; subjects 1-21 train, 22-25 val,
26-30 test (matching HAPT's protocol shape).
"""
from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np


CLASSES = ("WALKING", "UPSTAIRS", "DOWNSTAIRS", "SITTING", "STANDING", "LAYING")
N_CLASSES = 6
WINDOW = 128
RATE_HZ = 50.0
SPLIT_WINDOWS = {"train": 7352, "val": 1515, "test": 3399}
SPLIT_SUBJECTS = {"train": range(1, 22), "val": range(22, 26), "test": range(26, 31)}

_GRAVITY = {
    # unit gravity direction in device frame per class (waist-mounted phone)
    "WALKING": (0.05, -0.10, 1.00),
    "UPSTAIRS": (0.18, -0.05, 0.98),
    "DOWNSTAIRS": (-0.15, 0.08, 0.98),
    "SITTING": (0.55, 0.10, 0.82),
    "STANDING": (0.02, -0.02, 1.00),
    "LAYING": (0.98, 0.05, -0.12),
}
_DYNAMIC = {"WALKING": 0.24, "UPSTAIRS": 0.20, "DOWNSTAIRS": 0.30}


@dataclasses.dataclass
class HAPTSplit:
    windows: np.ndarray    # (N, 128, 3) float32
    labels: np.ndarray     # (N,) int32
    subjects: np.ndarray   # (N,) int32


def _subject_traits(subject: int) -> dict:
    rng = np.random.default_rng(10_000 + subject)
    return {
        "cadence_hz": float(rng.uniform(1.4, 2.2)),
        "orient_jitter": rng.normal(0, 0.06, size=3),
        "noise": float(rng.uniform(0.015, 0.04)),
        "amp": float(rng.uniform(0.8, 1.25)),
    }


def _window_for(cls: str, traits: dict, rng: np.random.Generator) -> np.ndarray:
    t = np.arange(WINDOW) / RATE_HZ
    g = np.asarray(_GRAVITY[cls]) + traits["orient_jitter"]
    g = g / np.linalg.norm(g)
    sig = np.tile(g, (WINDOW, 1)).astype(np.float64)

    if cls in _DYNAMIC:
        f = traits["cadence_hz"] * rng.uniform(0.92, 1.08)
        phase = rng.uniform(0, 2 * np.pi)
        amp = _DYNAMIC[cls] * traits["amp"]
        fund = np.sin(2 * np.pi * f * t + phase)
        h2 = np.sin(2 * np.pi * 2 * f * t + 2.1 * phase)
        if cls == "WALKING":
            mix = amp * (fund + 0.35 * h2)
            lateral = 0.4 * amp * np.sin(2 * np.pi * 0.5 * f * t + phase)
        elif cls == "UPSTAIRS":
            mix = amp * (0.8 * fund + 0.6 * h2)          # lift-dominated
            lateral = 0.25 * amp * np.sin(2 * np.pi * 0.5 * f * t)
        else:  # DOWNSTAIRS: impact spikes, broader band -> hardest class
            impact = np.clip(np.sin(2 * np.pi * f * t + phase), 0.55, None) - 0.55
            mix = amp * (0.6 * fund + 0.5 * h2 + 2.2 * impact)
            lateral = 0.35 * amp * np.sin(2 * np.pi * 0.5 * f * t + 0.7)
        sig[:, 2] += mix
        sig[:, 0] += 0.45 * mix + 0.3 * lateral
        sig[:, 1] += lateral
    elif cls == "SITTING":
        # slow postural sway distinguishes SITTING from STANDING
        sig += 0.02 * np.sin(2 * np.pi * 0.25 * t + rng.uniform(0, 6.28))[:, None]

    # AR(1) sensor noise + slow drift
    e = rng.normal(0, traits["noise"], size=(WINDOW, 3))
    for i in range(1, WINDOW):
        e[i] += 0.5 * e[i - 1]
    drift = rng.normal(0, 0.01, size=3) * (t / t[-1])[:, None]
    return (sig + e + drift).astype(np.float32)


def generate_synthetic(split: str, seed: int = 0, n: int | None = None) -> HAPTSplit:
    n = n if n is not None else SPLIT_WINDOWS[split]
    subjects = list(SPLIT_SUBJECTS[split])
    # crc32, not hash(): str hashing is randomized per process
    # (PYTHONHASHSEED), which made the "synthetic HAPT" a different dataset
    # on every run — every accuracy threshold downstream was a coin flip
    rng = np.random.default_rng(seed * 7919 + zlib.crc32(split.encode()) % 100_000)
    xs = np.empty((n, WINDOW, 3), np.float32)
    ys = np.empty((n,), np.int32)
    subj = np.empty((n,), np.int32)
    traits = {s: _subject_traits(s) for s in subjects}
    for i in range(n):
        s = subjects[i % len(subjects)]
        c = int(rng.integers(0, N_CLASSES))
        xs[i] = _window_for(CLASSES[c], traits[s], rng)
        ys[i] = c
        subj[i] = s
    return HAPTSplit(windows=xs, labels=ys, subjects=subj)


def load_real(root: str, split: str) -> HAPTSplit | None:
    """Load the canonical HAPT raw-data layout if present, else None."""
    sub = {"train": "Train", "val": "Train", "test": "Test"}[split]
    xp = os.path.join(root, sub, f"X_{sub.lower()}.txt")
    if not os.path.exists(xp):
        return None
    X = np.loadtxt(xp, dtype=np.float32)
    y = np.loadtxt(os.path.join(root, sub, f"y_{sub.lower()}.txt"), dtype=np.int32) - 1
    s = np.loadtxt(os.path.join(root, sub, f"subject_id_{sub.lower()}.txt"), dtype=np.int32)
    keep = y < N_CLASSES  # six basic activities only (paper Sec. VI-D)
    X, y, s = X[keep], y[keep], s[keep]
    # the canonical features file is 561-dim; raw windows live elsewhere —
    # reshape only if raw (N,384); otherwise refuse and fall back.
    if X.shape[1] == WINDOW * 3:
        X = X.reshape(-1, WINDOW, 3)
        return HAPTSplit(X, y, s)
    return None


def load(split: str, seed: int = 0, root: str | None = None, n: int | None = None) -> HAPTSplit:
    """The real split under ``root`` (or ``$HAPT_ROOT``) when present, else
    the synthetic one."""
    root = root or os.environ.get("HAPT_ROOT")
    real = load_real(root, split) if root and os.path.isdir(root) else None
    return real if real is not None else generate_synthetic(split, seed, n)


def batches(split: HAPTSplit, batch_size: int, seed: int, time_major: bool = True):
    """Shuffled epoch iterator -> (xs (T,B,3) or (B,T,3), labels (B,))."""
    idx = np.random.default_rng(seed).permutation(len(split.labels))
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        j = idx[i:i + batch_size]
        xs = split.windows[j]
        if time_major:
            xs = np.transpose(xs, (1, 0, 2))
        yield xs, split.labels[j]
