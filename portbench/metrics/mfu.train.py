"""Model FLOPs of the window's training steps after the profiler stopped
(forward and backward, ``portbench.counts.model.train_step_flops``;
recomputation not counted) over their seconds, as a share of the card's
bfloat16 peak (%)."""
from portbench.counts import peaks


def read(rec):
    part = rec.get("untraced")
    if rec.get("kind") != "train" or not part or not part["model_flops"]:
        return None
    return 100.0 * part["model_flops"] / part["wall_s"] \
        / peaks.BF16_FLOP_PER_S
