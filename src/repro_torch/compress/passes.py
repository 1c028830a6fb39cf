"""Composable compression passes over :class:`~repro_torch.compress.artifact.ModelArtifact`,
a torch copy of the reference ``repro.compress.passes``.

Each pass implements the :class:`Pass` protocol — ``name``, pure and
deterministic ``apply(artifact) -> artifact`` — and appends one provenance
record (its config plus the metrics it achieved) to the artifact.  The
paper's L-S-Q recipe maps onto:

    LowRankFactor -> IHTSparsify -> QuantizePTQ -> CalibrateActivations
                  -> PackLUT

Purity rules every pass follows (they make double-run => byte-identical
artifact possible):

  * no wall-clock, RNG, or host state in the output or the provenance;
  * calibration data is part of the pass *config* (an explicit array or a
    deterministic ``"hapt:<split>:<n>"`` spec), never ambient state;
  * all math routes through the port's ``core.compression``,
    ``core.quantization.quantize_params`` and ``core.qruntime.calibrate``.

For the same input params every pass writes the bytes the reference's
pass writes.  ``IHTSparsify`` and ``QuantizePTQ`` run on ``device``
(``"cuda"`` by default) and give the same bytes on the card as on the
CPU; the device is where a pass runs, not what it computes, so it is kept
out of the provenance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import quantization as q
from repro_torch.core.lut import make_lut, make_lut_q15
from repro_torch.device import resolve_device
from .artifact import ModelArtifact, jsonify, tensor_digest

# Weight-width aliases: the paper speaks in fixed-point formats (Q15/Q7),
# the storage speaks in integer widths (int16/int8).  Accept both.
BITS_ALIASES = {15: 16, 16: 16, 7: 8, 8: 8}


def _device_field():
    """A pass's ``device``: where it computes, left out of its config."""
    return dataclasses.field(default="cuda", metadata={"provenance": False})


@runtime_checkable
class Pass(Protocol):
    """One compression stage: pure, deterministic artifact -> artifact."""
    name: str

    def apply(self, artifact: ModelArtifact) -> ModelArtifact: ...

    def config(self) -> dict[str, Any]: ...


@dataclasses.dataclass(frozen=True)
class _ConfigPass:
    """Shared ``config()``: every dataclass field but ``device``, with
    arrays collapsed to a content digest so provenance stays JSON-small yet
    still pins the exact inputs a pass saw."""

    def config(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if not f.metadata.get("provenance", True):
                continue
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                out[f.name] = {"ndarray_sha": tensor_digest(v),
                               "shape": list(v.shape)}
            elif callable(v) and not isinstance(v, type):
                out[f.name] = getattr(v, "__name__", "callable")
            else:
                out[f.name] = jsonify(v)
        return out

    def _record(self, art: ModelArtifact,
                metrics: dict[str, Any]) -> ModelArtifact:
        return art.with_record({"pass": self.name, "config": self.config(),
                                "metrics": metrics})


# ---------------------------------------------------------------------------
# L: low-rank factorization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LowRankFactor(_ConfigPass):
    """Paper Sec. III-B: factor dense W (H, d) / U (H, H) into thin pairs
    ``W1 @ W2^T`` / ``U1 @ U2^T`` by truncated SVD (numpy float64, as the
    reference), matching the factored evaluation order of every runtime
    (``W1 (W2^T x)``).  A checkpoint that trained factored from the start
    passes through untouched."""
    rank_w: int = 2
    rank_u: int = 8
    name: str = dataclasses.field(default="low_rank", init=False)

    @staticmethod
    def _factor(w: np.ndarray, rank: int) -> tuple[np.ndarray, np.ndarray, float]:
        u, s, vt = np.linalg.svd(np.asarray(w, np.float64),
                                 full_matrices=False)
        r = min(rank, s.shape[0])
        a = (u[:, :r] * s[:r]).astype(np.float32)       # (H, r)
        b = vt[:r].T.astype(np.float32)                 # (d, r)
        err = float(np.linalg.norm(w - a @ b.T) / max(np.linalg.norm(w), 1e-30))
        return a, b, err

    def apply(self, art: ModelArtifact) -> ModelArtifact:
        p = dict(art.params)
        if "W1" in p:
            return self._record(art, {"skipped": "already factored"})
        before = int(sum(v.size for v in p.values()))
        w1, w2, err_w = self._factor(p.pop("W"), self.rank_w)
        u1, u2, err_u = self._factor(p.pop("U"), self.rank_u)
        p.update(W1=w1, W2=w2, U1=u1, U2=u2)
        after = int(sum(v.size for v in p.values()))
        metrics = {"rank_w": int(w1.shape[1]), "rank_u": int(u1.shape[1]),
                   "rel_err_W": err_w, "rel_err_U": err_u,
                   "param_count": {"before": before, "after": after}}
        meta = {**art.meta, "low_rank": True,
                "rank_w": int(w1.shape[1]), "rank_u": int(u1.shape[1])}
        return self._record(art.replace(params=p, meta=meta), metrics)


# ---------------------------------------------------------------------------
# S: IHT sparsification (one-shot top-k projection of a trained checkpoint)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IHTSparsify(_ConfigPass):
    """Paper Sec. III-C's hard-thresholding projection, applied post-hoc:
    keep the top-k magnitude entries of every sparsifiable tensor, zero
    the rest, and record the masks + achieved per-tensor sparsity.  (The
    in-training cubic ramp stays in ``core/pipeline.train_fastgrnn``; a
    trained-with-IHT checkpoint flows through this pass as the final
    frozen-mask projection, which is idempotent on it.)  The masks are
    computed on ``device``."""
    sparsity: float = 0.5
    leaves: tuple[str, ...] = ("W", "U", "W1", "W2", "U1", "U2")
    device: str = _device_field()
    name: str = dataclasses.field(default="iht_sparsify", init=False)

    def apply(self, art: ModelArtifact) -> ModelArtifact:
        if not 0.0 <= self.sparsity < 1.0:
            raise ValueError(f"sparsity must be in [0, 1): {self.sparsity}")
        cfg = comp.IHTConfig(target_sparsity=self.sparsity,
                             leaf_filter=lambda n: n in self.leaves)
        dev = resolve_device(self.device)
        on_dev = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                  for k, v in art.params.items()}
        masks = comp.compute_masks(on_dev, cfg, self.sparsity)
        params = {k: v.cpu().numpy()
                  for k, v in comp.apply_masks(on_dev, masks).items()}
        np_masks = {k: m.cpu().numpy() for k, m in masks.items()
                    if k in self.leaves}
        achieved = {k: 1.0 - float(np.count_nonzero(params[k]))
                    / max(int(params[k].size), 1) for k in sorted(np_masks)}
        overall = comp.sparsity_of(params, leaf_filter=lambda n: n in self.leaves)
        return self._record(
            art.replace(params=params, masks={**art.masks, **np_masks}),
            {"target_sparsity": self.sparsity,
             "achieved_sparsity": float(overall),
             "per_tensor_sparsity": achieved})


# ---------------------------------------------------------------------------
# Q: per-tensor symmetric PTQ (Q15 / Q7)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizePTQ(_ConfigPass):
    """Paper Sec. III-D / Appendix B: per-tensor symmetric post-training
    quantization on ``device``.  ``bits`` accepts the fixed-point name
    (15 -> Q15 int16, 7 -> Q7 int8) or the storage width (16/8).  Routes
    through ``core.quantization.quantize_params``, bitwise the reference's
    on the CPU and on the card."""
    bits: int = 15
    float_leaves: tuple[str, ...] = q.QuantConfig.float_leaves
    device: str = _device_field()
    name: str = dataclasses.field(default="quantize_ptq", init=False)

    @classmethod
    def from_config(cls, cfg: q.QuantConfig,
                    device: str | torch.device = "cuda") -> "QuantizePTQ":
        return cls(bits=cfg.bits, float_leaves=cfg.float_leaves,
                   device=device)

    def storage_bits(self) -> int:
        if self.bits not in BITS_ALIASES:
            raise ValueError(f"bits must be one of {sorted(BITS_ALIASES)} "
                             f"(Q15/int16 or Q7/int8): {self.bits}")
        return BITS_ALIASES[self.bits]

    def apply(self, art: ModelArtifact) -> ModelArtifact:
        if not art.params:
            raise ValueError("QuantizePTQ needs float params on the artifact")
        bits = self.storage_bits()
        cfg = q.QuantConfig(bits=bits, float_leaves=tuple(self.float_leaves))
        qp = q.quantize_params(art.params, cfg,
                               device=resolve_device(self.device))
        metrics = {
            "bits": bits, "q_format": "Q15" if bits == 16 else "Q7",
            "scales": {k: float(np.float32(v))
                       for k, v in sorted(qp.scales.items())},
            "weight_bytes": qp.nbytes(),
            "float_leaves": sorted(qp.fp),
        }
        meta = {**art.meta, "bits": bits}
        return self._record(art.replace(qp=qp, meta=meta), metrics)


# ---------------------------------------------------------------------------
# Activation calibration (deploy scales and/or Table V storage scales)
# ---------------------------------------------------------------------------

def resolve_windows(windows: Any) -> np.ndarray:
    """Calibration data as an explicit (N, T, d) array or a deterministic
    ``"hapt:<split>:<n>"`` spec (the synthetic HAPT loader is crc32-seeded,
    so a spec is as reproducible as an inline array)."""
    if isinstance(windows, str):
        parts = windows.split(":")
        if len(parts) != 3 or parts[0] != "hapt":
            raise ValueError(
                f"windows spec must be 'hapt:<split>:<n>': {windows!r}")
        from repro_torch.data import hapt
        return hapt.load(parts[1], n=int(parts[2])).windows
    return np.asarray(windows, np.float32)


@dataclasses.dataclass(frozen=True)
class CalibrateActivations(_ConfigPass):
    """Paper Sec. III-D: max-abs calibration with headroom over N windows,
    through the scalar ``core.qruntime.calibrate`` (host numpy).

    ``scope="deploy"`` records every scale the fixed-point export needs
    into ``artifact.act_scales``; ``scope="storage"`` records the Table V
    activation-storage scales into ``artifact.storage_scales``."""
    windows: Any = "hapt:train:5"
    headroom: float = 0.10
    scope: str = "deploy"                   # "deploy" | "storage"
    name: str = dataclasses.field(default="calibrate_activations", init=False)

    def apply(self, art: ModelArtifact) -> ModelArtifact:
        if self.scope not in ("deploy", "storage"):
            raise ValueError(f"scope must be deploy|storage: {self.scope}")
        if art.qp is None:
            raise ValueError("CalibrateActivations runs after QuantizePTQ "
                             "(it calibrates the quantized model's runtime)")
        from repro_torch.core.qruntime import QRuntime, calibrate
        w = resolve_windows(self.windows)
        scales = calibrate(QRuntime(art.qp), w, headroom=self.headroom,
                           deploy=(self.scope == "deploy"))
        scales = {k: float(v) for k, v in scales.items()}
        field = "act_scales" if self.scope == "deploy" else "storage_scales"
        metrics = {"scope": self.scope, "n_windows": int(w.shape[0]),
                   "headroom": self.headroom,
                   "scales": dict(sorted(scales.items()))}
        return self._record(art.replace(**{field: scales}), metrics)


# ---------------------------------------------------------------------------
# LUT packing (Appendix C)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackLUT(_ConfigPass):
    """Attach the 256-entry activation LUTs to the artifact (numpy): the
    f32 pair (the paper's 2 KB flash cost, float engine) and the int16 Q15
    pair (1 KB, integer engine)."""
    kinds: tuple[str, ...] = ("sigmoid", "tanh")
    name: str = dataclasses.field(default="pack_lut", init=False)

    def apply(self, art: ModelArtifact) -> ModelArtifact:
        luts = dict(art.luts)
        for kind in self.kinds:
            luts[f"{kind}_f32"] = make_lut(kind).numpy()
            luts[f"{kind}_q15"] = make_lut_q15(kind).numpy()
        nbytes = int(sum(v.nbytes for v in luts.values()))
        return self._record(art.replace(luts=luts),
                            {"entries_per_table": int(luts[
                                f"{self.kinds[0]}_f32"].shape[0]),
                             "lut_bytes": nbytes})
