"""The compression pipeline's handoff object, :class:`ModelArtifact`."""
from .artifact import ARTIFACT_VERSION, ModelArtifact

__all__ = ["ARTIFACT_VERSION", "ModelArtifact"]
