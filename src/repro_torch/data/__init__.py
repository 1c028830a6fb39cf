"""Numpy-only data pipelines: synthetic HAPT windows (``hapt``) and the
seekable LM token stream (``tokens``)."""
