"""``torch.cuda.max_memory_allocated()`` over the training window, after
a reset at its start (GiB)."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("memory_peak_bytes"):
        return None
    return rec["memory_peak_bytes"] / 2**30
