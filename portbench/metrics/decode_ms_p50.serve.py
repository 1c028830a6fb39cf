"""Median of the engine's ``lm.decode`` spans in the window (ms): one
slotted decode step over every slot, ending in the sampled tokens' copy
to the host."""
import statistics


def read(rec):
    spans = rec.get("spans", {}).get("lm.decode")
    return statistics.median(spans) if spans else None
