"""`Pipeline` — deterministic composition of compression passes (reference
``repro.compress.pipeline``).

A pipeline is an ordered tuple of :class:`~repro_torch.compress.passes.Pass`
objects run left to right over one
:class:`~repro_torch.compress.artifact.ModelArtifact`; every pass appends
its own provenance record, so the finished artifact carries the full
recipe that produced it.  ``pipeline_from_config`` builds one from a
JSON-able config (the ``python -m repro_torch.compress`` CLI input), and
``default_deploy_pipeline`` is the paper's [IHT ->] PTQ -> deploy
calibration -> LUT recipe.  ``device`` is where the passes that compute on
tensors (``IHTSparsify``, ``QuantizePTQ``) run; it changes no byte.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from .artifact import ModelArtifact
from .passes import (CalibrateActivations, IHTSparsify, LowRankFactor,
                     PackLUT, Pass, QuantizePTQ)

PASS_REGISTRY: dict[str, type] = {
    "low_rank": LowRankFactor,
    "iht_sparsify": IHTSparsify,
    "quantize_ptq": QuantizePTQ,
    "calibrate_activations": CalibrateActivations,
    "pack_lut": PackLUT,
}


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Ordered, pure composition of passes (one artifact in, one out)."""
    passes: tuple[Pass, ...]
    name: str = "compress"

    def __post_init__(self):
        object.__setattr__(self, "passes", tuple(self.passes))

    def run(self, artifact: ModelArtifact) -> ModelArtifact:
        for p in self.passes:
            artifact = p.apply(artifact)
        return artifact

    def describe(self) -> list[dict[str, Any]]:
        return [{"pass": p.name, "config": p.config()} for p in self.passes]


def pipeline_from_config(cfg: Iterable[dict[str, Any]] | dict[str, Any],
                         name: str = "compress",
                         device: str = "cuda") -> Pipeline:
    """Build a pipeline from a JSON config: either a list of pass specs
    ``[{"pass": "quantize_ptq", "bits": 15}, ...]`` or a dict with a
    ``"passes"`` key holding that list.  Unknown pass names or kwargs fail
    loudly.  Passes that take a ``device`` get ``device`` unless their
    spec names one."""
    if isinstance(cfg, dict):
        name = cfg.get("name", name)
        cfg = cfg["passes"]
    passes = []
    for spec in cfg:
        spec = dict(spec)
        kind = spec.pop("pass")
        cls = PASS_REGISTRY.get(kind)
        if cls is None:
            raise ValueError(f"unknown pass {kind!r} "
                             f"(known: {sorted(PASS_REGISTRY)})")
        for k in ("leaves", "float_leaves", "kinds"):
            if k in spec and isinstance(spec[k], list):
                spec[k] = tuple(spec[k])
        if any(f.name == "device" for f in dataclasses.fields(cls)):
            spec.setdefault("device", device)
        passes.append(cls(**spec))
    return Pipeline(passes=tuple(passes), name=name)


def default_deploy_pipeline(bits: int = 15,
                            calib: Any = "hapt:train:5",
                            headroom: float = 0.10,
                            sparsity: float | None = None,
                            device: str = "cuda") -> Pipeline:
    """The paper's deployment recipe: [IHT ->] PTQ -> deploy calibration ->
    LUT pack.  ``bits=15`` is the Q15 export; ``bits=7`` the Q7 path."""
    passes: list[Pass] = []
    if sparsity:
        passes.append(IHTSparsify(sparsity=sparsity, device=device))
    passes += [
        QuantizePTQ(bits=bits, device=device),
        CalibrateActivations(windows=calib, headroom=headroom,
                             scope="deploy"),
        PackLUT(),
    ]
    return Pipeline(passes=tuple(passes),
                    name=f"deploy-q{'15' if bits in (15, 16) else '7'}")


def compress(params: dict[str, Any], pipeline: Pipeline) -> ModelArtifact:
    """One-call convenience: wrap a float checkpoint and run a pipeline."""
    return pipeline.run(ModelArtifact.from_params(params))
