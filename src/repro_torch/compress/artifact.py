"""`ModelArtifact` — the one handoff object of the compression pipeline,
ported from the reference ``repro.compress.artifact``.

An artifact carries the float parameters, masks, quantized parameters,
activation scales, LUTs and per-pass provenance of one model, so every
consumer (``core/qruntime.QRuntime.from_artifact``,
``serve/streaming.StreamingEngine.from_artifact``) takes one object.

Serialization is a deterministic, versioned binary format (``.fgar``):

  +--------+-----------------------------------------------------------+
  | magic  | ``FGAR``, u16 artifact version, u32 header length         |
  | header | canonical JSON (sorted keys, compact separators): meta,   |
  |        | per-tensor manifest, quantizer scales, activation scales, |
  |        | full per-pass provenance                                  |
  | payload| raw little-endian tensor bytes, manifest order            |
  +--------+-----------------------------------------------------------+

Determinism contract (gated in CI and ``tests/test_compress.py``):

  * save -> load -> save is byte-identical;
  * the bytes are identical to the reference package's for the same
    contents, in both directions (an artifact written by either package
    loads in the other and re-serialises to the same bytes).

``size_report()`` is the deployed-footprint audit: per-tensor dense bytes
at the artifact's weight width (2 B/entry at Q15, 1 B/entry at Q7) plus a
CSR-style packed estimate for sparsified tensors (values + column indices
+ row pointers), the accounting behind the paper's 566-byte figure.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from typing import Any

import numpy as np

import torch

from repro_torch.core.quantization import QuantizedParams

MAGIC = b"FGAR"
ARTIFACT_VERSION = 1

_PREAMBLE = struct.Struct("<4sHI")      # magic, version, header length

# Tensor groups, serialized in this fixed order (names sorted inside each):
_GROUPS = ("params", "masks", "q", "fp", "luts")

# Canonical on-disk dtypes per group (params/fp are f32 by construction;
# masks keep their bool-ness through a round-trip via the |b1 tag; q keeps
# its quantized width; luts are i2 or f4).
_DTYPE_TAGS = {"<f4": np.dtype("<f4"), "<i2": np.dtype("<i2"),
               "<i1": np.dtype("<i1"), "|u1": np.dtype("u1"),
               "|b1": np.dtype(bool)}


def jsonify(obj: Any) -> Any:
    """Recursively convert numpy scalars/arrays into JSON-safe values.

    Floats go through ``float(np.float32(...))`` ONLY at the caller's
    discretion — here we preserve the exact binary64 value so provenance
    round-trips bit-for-bit through ``json.dumps``/``loads``.
    """
    if isinstance(obj, dict):
        return {str(k): jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return jsonify(obj.tolist())
    return obj


def _numpy(a) -> np.ndarray:
    """Host numpy view of a CPU tensor or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _canonical_json(obj: Any) -> bytes:
    return json.dumps(jsonify(obj), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _dtype_tag(a: np.ndarray) -> str:
    kind = np.asarray(a).dtype
    if kind == np.bool_:
        return "|b1"
    if kind == np.uint8:
        return "|u1"
    if kind == np.int8:
        return "<i1"
    if kind == np.int16:
        return "<i2"
    return "<f4"


def tensor_digest(a: np.ndarray) -> str:
    """Short content digest for provenance records (never for security)."""
    t = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha256(t.tobytes()).hexdigest()[:16]


@dataclasses.dataclass
class ModelArtifact:
    """Versioned, serializable carrier of one model through the pipeline.

    Fields fill in as the reference package's compression passes run:
    ``params``/``masks`` after the float stages, ``qp`` after PTQ,
    ``act_scales`` (deploy calibration) and/or ``storage_scales`` (Table V
    activation-storage calibration), ``luts`` after LUT packing.
    ``provenance`` appends one record per pass: ``{"pass", "config",
    "metrics"}``.  ``params``/``masks``/``luts`` hold numpy arrays; ``qp``
    holds the port's :class:`QuantizedParams` (CPU tensors).
    """
    version: int = ARTIFACT_VERSION
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    params: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    masks: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    qp: QuantizedParams | None = None
    act_scales: dict[str, float] = dataclasses.field(default_factory=dict)
    storage_scales: dict[str, float] = dataclasses.field(default_factory=dict)
    luts: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    provenance: list[dict[str, Any]] = dataclasses.field(default_factory=list)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_params(cls, params: dict[str, Any],
                    meta: dict[str, Any] | None = None) -> "ModelArtifact":
        """Wrap a float parameter dict (torch or numpy leaves) as the
        pipeline's input artifact.  Leaves are canonicalized to float32
        numpy; scalars become 0-d arrays.  Architecture metadata (d, H, C,
        ranks) is inferred from the FastGRNN tensor names when present."""
        p = {k: _numpy(v).astype(np.float32) for k, v in params.items()}
        m = dict(meta or {})
        m.setdefault("format", "fastgrnn" if "b_z" in p else "generic")
        if "b_z" in p:
            low_rank = "W1" in p
            m.setdefault("low_rank", low_rank)
            m.setdefault("H", int(p["b_z"].shape[0]))
            m.setdefault("d", int(p["W2"].shape[0] if low_rank
                                  else p["W"].shape[1]))
            m.setdefault("C", int(p["head_b"].shape[0]))
            m.setdefault("rank_w", int(p["W1"].shape[1]) if low_rank else 0)
            m.setdefault("rank_u", int(p["U1"].shape[1]) if "U1" in p else 0)
        art = cls(meta=m, params=p)
        return art.with_record({
            "pass": "source",
            "config": {},
            "metrics": {"param_count": int(sum(v.size for v in p.values())),
                        "params_sha": {k: tensor_digest(v)
                                       for k, v in sorted(p.items())}},
        })

    # -- functional updates ----------------------------------------------
    def replace(self, **kw: Any) -> "ModelArtifact":
        return dataclasses.replace(self, **kw)

    def with_record(self, record: dict[str, Any]) -> "ModelArtifact":
        return self.replace(provenance=[*self.provenance, jsonify(record)])

    # -- introspection ----------------------------------------------------
    @property
    def bits(self) -> int | None:
        """Quantized weight width (16 -> Q15 int16, 8 -> Q7 int8)."""
        if self.qp is not None:
            return self.qp.bits
        return self.meta.get("bits")

    def passes_applied(self) -> list[str]:
        return [r["pass"] for r in self.provenance]

    # -- runtime consumption (one gate shared by every consumer) ----------
    def require_qp(self) -> QuantizedParams:
        if self.qp is None:
            raise ValueError("artifact carries no quantized params — run a "
                             "QuantizePTQ pass first")
        return self.qp

    def runtime_scales(self, quantized_acts: bool = False
                       ) -> dict[str, float] | None:
        """Activation-storage scales for a runtime consumer.  The deployed
        configuration (paper Table V winning row) keeps activations in
        FP32 through the LUTs, so the *deploy* calibration scales
        (``act_scales`` — export-compiler scales for x/pre/h/logits) are
        deliberately never returned here.  ``quantized_acts=True`` selects
        the calibrated-Q15-activation counterfactual, which requires a
        ``CalibrateActivations(scope="storage")`` pass."""
        if not quantized_acts:
            return None
        if not self.storage_scales:
            raise ValueError(
                "quantized_acts=True needs artifact.storage_scales "
                "(CalibrateActivations(scope='storage'))")
        return dict(self.storage_scales)

    def sha256(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()

    # -- serialization ----------------------------------------------------
    def _tensor_groups(self) -> dict[str, dict[str, np.ndarray]]:
        g: dict[str, dict[str, np.ndarray]] = {
            "params": self.params, "masks": self.masks, "luts": self.luts,
            "q": {}, "fp": {}}
        if self.qp is not None:
            g["q"] = {k: _numpy(v) for k, v in self.qp.q.items()}
            g["fp"] = {k: _numpy(v).astype(np.float32)
                       for k, v in self.qp.fp.items()}
        return g

    def to_bytes(self) -> bytes:
        groups = self._tensor_groups()
        manifest, payload = [], []
        for group in _GROUPS:
            for name in sorted(groups[group]):
                a = np.asarray(groups[group][name])
                tag = _dtype_tag(a)
                t = np.ascontiguousarray(a.astype(_DTYPE_TAGS[tag],
                                                  copy=False))
                manifest.append({"group": group, "name": name, "dtype": tag,
                                 "shape": [int(s) for s in a.shape]})
                payload.append(t.tobytes())
        header = {
            "artifact_version": self.version,
            "meta": self.meta,
            "act_scales": {k: float(v) for k, v in self.act_scales.items()},
            "storage_scales": {k: float(v)
                               for k, v in self.storage_scales.items()},
            "q_bits": None if self.qp is None else int(self.qp.bits),
            "q_scales": (None if self.qp is None else
                         {k: float(np.float32(v))
                          for k, v in self.qp.scales.items()}),
            "provenance": self.provenance,
            "tensors": manifest,
        }
        hj = _canonical_json(header)
        return (_PREAMBLE.pack(MAGIC, self.version, len(hj)) + hj
                + b"".join(payload))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "ModelArtifact":
        magic, ver, hlen = _PREAMBLE.unpack_from(blob, 0)
        if magic != MAGIC:
            raise ValueError(f"bad artifact magic {magic!r}")
        if ver != ARTIFACT_VERSION:
            raise ValueError(f"unsupported artifact version {ver}")
        off = _PREAMBLE.size
        header = json.loads(blob[off:off + hlen].decode("utf-8"))
        off += hlen
        groups: dict[str, dict[str, np.ndarray]] = {g: {} for g in _GROUPS}
        for ent in header["tensors"]:
            dt = _DTYPE_TAGS[ent["dtype"]]
            n = int(np.prod(ent["shape"])) if ent["shape"] else 1
            a = np.frombuffer(blob, dt, count=n, offset=off)
            off += a.nbytes
            groups[ent["group"]][ent["name"]] = \
                a.reshape(ent["shape"]).copy()
        if off != len(blob):
            raise ValueError(f"trailing artifact bytes: {len(blob) - off}")
        qp = None
        if header["q_bits"] is not None:
            qp = QuantizedParams(
                q={k: torch.from_numpy(v) for k, v in groups["q"].items()},
                scales=dict(header["q_scales"]),
                fp={k: torch.from_numpy(v) for k, v in groups["fp"].items()},
                bits=int(header["q_bits"]))
        return cls(version=ver, meta=header["meta"], params=groups["params"],
                   masks=groups["masks"], qp=qp,
                   act_scales=dict(header["act_scales"]),
                   storage_scales=dict(header["storage_scales"]),
                   luts=groups["luts"], provenance=header["provenance"])

    def save(self, path: str) -> bytes:
        blob = self.to_bytes()
        with open(path, "wb") as f:
            f.write(blob)
        return blob

    @classmethod
    def load(cls, path: str) -> "ModelArtifact":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- deployed-footprint audit ----------------------------------------
    def size_report(self) -> dict[str, Any]:
        """Deployed weight-footprint accounting at the artifact's true
        weight width (Q7 counts 1 B/entry even though the wire image cells
        stay int16) with a CSR-style packed alternative for sparse tensors:
        ``nnz * itemsize`` values + ``nnz`` column indices (u8 when the row
        width allows, else u16) + ``rows + 1`` u16 row pointers.  The
        per-tensor ``packing`` picks whichever is smaller — the honest
        version of the paper's 566-byte claim under IHT sparsity."""
        report: dict[str, Any] = {
            "artifact_version": self.version,
            "passes": self.passes_applied(),
            "meta": jsonify(self.meta),
        }
        if self.qp is None:
            total = int(sum(v.size for v in self.params.values())) * 4
            report["bits"] = 32
            report["weight_bytes_dense"] = total
            report["weight_bytes_packed"] = total
            report["tensors"] = [
                {"name": k, "shape": list(v.shape), "bytes": int(v.size) * 4}
                for k, v in sorted(self.params.items())]
            return report
        bits = self.qp.bits
        itemsize = 2 if bits == 16 else 1
        tensors = []
        dense_total = packed_total = nnz_total = n_total = 0
        for name in self.qp.tensor_order():
            t = _numpy(self.qp.q[name])
            rows, cols = (t.shape if t.ndim == 2 else (1, t.size))
            n, nnz = int(t.size), int(np.count_nonzero(t))
            dense = n * itemsize
            idx_b = 1 if cols <= 256 else 2
            csr = nnz * itemsize + nnz * idx_b + (rows + 1) * 2
            packing = "csr" if csr < dense else "dense"
            packed = min(csr, dense)
            tensors.append({
                "name": name, "shape": [int(s) for s in t.shape],
                "dtype": f"int{8 * itemsize}",
                "scale": float(np.float32(self.qp.scales[name])),
                "nnz": nnz, "sparsity": 1.0 - nnz / max(n, 1),
                "dense_bytes": dense, "csr_bytes": csr,
                "packing": packing, "packed_bytes": packed,
            })
            dense_total += dense
            packed_total += packed
            nnz_total += nnz
            n_total += n
        fp_bytes = int(sum(_numpy(v).size
                           for v in self.qp.fp.values())) * 4
        scale_bytes = 4 * len(self.qp.scales)
        act_bytes = 4 * (len(self.act_scales) + len(self.storage_scales))
        lut_bytes = int(sum(np.asarray(v).nbytes
                            for v in self.luts.values()))
        report.update({
            "bits": bits,
            "q_format": "Q15" if bits == 16 else "Q7",
            "tensors": tensors,
            "weight_bytes_dense": dense_total,
            "weight_bytes_packed": packed_total,
            "weight_sparsity": 1.0 - nnz_total / max(n_total, 1),
            "const_bytes": fp_bytes + scale_bytes + act_bytes,
            "lut_bytes": lut_bytes,
            "total_bytes_packed": packed_total + fp_bytes + scale_bytes
                                  + act_bytes + lut_bytes,
            "paper_weight_budget_bytes": 566,
            "within_paper_weight_budget": packed_total <= 566,
        })
        return report

    def summary(self) -> str:
        stages = " -> ".join(self.passes_applied()) or "(empty)"
        size = (f"{self.size_report()['weight_bytes_packed']} B packed"
                if self.qp is not None else
                f"{sum(v.size for v in self.params.values())} f32 params")
        return (f"ModelArtifact v{self.version} [{stages}] "
                f"bits={self.bits} {size}")
