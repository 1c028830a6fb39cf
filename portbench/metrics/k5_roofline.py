"""K5 (``csrc/q15_matmul.cu``, the Q15 head) against its roofline in the
traced part of the window (%): the least time of every call, one row a
prefill and ``max_slots`` rows a decode tick over the (d_model, vocab)
int16 head (``portbench.counts.kernels.q15_matmul_least_s``), over the
device time of the trace's K5 kernels."""
from portbench.counts import kernels


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    busy = sum(b - a for n, a, b in tr["device_events"]
               if "q15_matmul_kernel" in n) / 1e9
    if busy <= 0:
        return None
    cfg = rec["cfg"]
    k, n = cfg.d_model, cfg.vocab_size
    least = (len(tr["prefill_lengths"]) * kernels.q15_matmul_least_s(1, k, n)
             + tr["decode_ticks"]
             * kernels.q15_matmul_least_s(rec["max_slots"], k, n))
    return 100.0 * least / busy
