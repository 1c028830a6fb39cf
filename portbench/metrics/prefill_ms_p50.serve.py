"""Median of the engine's ``lm.prefill`` spans in the window (ms): each
span is one request's prefill into its slot, from the call to the
sampled first token's copy to the host, so it holds the device work."""
import statistics


def read(rec):
    spans = rec.get("spans", {}).get("lm.prefill")
    return statistics.median(spans) if spans else None
