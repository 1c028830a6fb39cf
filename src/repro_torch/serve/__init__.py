"""Serving: the slot scheduler and the multi-stream streaming engine."""
