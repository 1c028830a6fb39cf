"""K6 (``csrc/ssd_scan.cu``, its three phases) against its roofline in
the traced part of the window (%): the least time of every call, one a
mamba layer a prefill at the prompt's length
(``portbench.counts.kernels.ssd_least_s``), over the device time of the
trace's K6 kernels."""
from portbench.counts import kernels


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("prefill_lengths"):
        return None
    busy = sum(b - a for n, a, b in tr["device_events"]
               if "ssd_scan_p" in n) / 1e9
    if busy <= 0:
        return None
    cfg = rec["cfg"]
    h, p = 2 * cfg.d_model // cfg.mamba_headdim, cfg.mamba_headdim
    least = cfg.num_layers * sum(
        kernels.ssd_least_s(h, cfg.mamba_groups, s, p, cfg.ssm_state)
        for s in tr["prefill_lengths"])
    return 100.0 * least / busy
