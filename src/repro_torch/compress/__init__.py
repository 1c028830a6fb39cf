"""repro_torch.compress — composable compression passes + the `ModelArtifact`
(reference ``repro.compress``).

The paper's spine (low-rank -> IHT sparsity -> per-tensor PTQ ->
activation calibration -> deploy) as a sequence of pure, deterministic
passes over one versioned, serializable artifact:

  * :mod:`.artifact` — :class:`ModelArtifact`, the handoff object every
    runtime consumes, with per-pass provenance and the ``.fgar`` format
    (byte-compatible with the reference's both ways);
  * :mod:`.passes`   — the :class:`Pass` protocol and ``LowRankFactor``,
    ``IHTSparsify``, ``QuantizePTQ`` (Q15 and Q7),
    ``CalibrateActivations`` (deploy / storage scopes), ``PackLUT``;
  * :mod:`.pipeline` — :class:`Pipeline` composition, a JSON config
    loader, and the paper's ``default_deploy_pipeline``;
  * :mod:`.tree`     — pytree PTQ for LM serving.

CLI: ``python -m repro_torch.compress --preset q15-deploy --out model.fgar``
(see ``python -m repro_torch.compress --help``).
"""
from .artifact import ARTIFACT_VERSION, ModelArtifact
from .passes import (BITS_ALIASES, CalibrateActivations, IHTSparsify,
                     LowRankFactor, PackLUT, Pass, QuantizePTQ,
                     resolve_windows)
from .pipeline import (PASS_REGISTRY, Pipeline, compress,
                       default_deploy_pipeline, pipeline_from_config)
from .tree import dequantize_tree, quantize_tree, tree_size_report

__all__ = [
    "ARTIFACT_VERSION", "ModelArtifact",
    "BITS_ALIASES", "Pass", "LowRankFactor", "IHTSparsify", "QuantizePTQ",
    "CalibrateActivations", "PackLUT", "resolve_windows",
    "PASS_REGISTRY", "Pipeline", "compress", "default_deploy_pipeline",
    "pipeline_from_config",
    "quantize_tree", "dequantize_tree", "tree_size_report",
]
