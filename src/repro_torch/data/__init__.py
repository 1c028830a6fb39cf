"""Numpy-only data pipelines (synthetic HAPT windows)."""
