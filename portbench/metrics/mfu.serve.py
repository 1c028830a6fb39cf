"""Model FLOPs (every prefill and decode tick at the shapes served,
``portbench.counts.model``) over the seconds of the window after the
profiler stopped, as a share of the card's bfloat16 peak (%)."""
from portbench.counts import peaks


def read(rec):
    part = rec.get("untraced")
    if rec.get("kind") != "serve" or not part or not part["model_flops"]:
        return None
    return 100.0 * part["model_flops"] / part["wall_s"] \
        / peaks.BF16_FLOP_PER_S
