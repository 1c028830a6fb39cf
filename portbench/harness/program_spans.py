"""Per-layer readings from the program's own spans (the engine's flight
ring, ``repro_torch.obs.Tracer.flight()``'s full view), for a traced
serving run whose driver hands them over as ``rec["program"]``:

* ``spans``: the window's flight records (``seq``, ``phase``, ``t0_us``,
  ``dur_us``, ``parent``, ``req``, ``n``);
* ``clock``: the tracer's ``clock()``, ``(perf_counter_ns, time_ns)``
  at one instant; a record's Unix start is ``clock[1] + t0_us * 1000``;
* ``traced_ns``: the profiler's window on ``perf_counter_ns``.

A program whose tracer lacks these fields (no ``parent``, no ``clock()``)
gives no ``rec["program"]``, and every reader here returns None.
"""
from __future__ import annotations

import statistics

from portbench.harness.devtrace import union

LAYER_SPANS = ("model.mamba", "model.attn")


def _spans(rec):
    prog = rec.get("program") or {}
    spans = prog.get("spans")
    if not spans or any("parent" not in s for s in spans):
        return None
    return spans


def forward_ms_p50(rec, under: str):
    """Median of the ``lm.forward`` spans whose enclosing span is
    ``under`` (``lm.prefill`` or ``lm.decode``), in ms."""
    spans = _spans(rec)
    if spans is None:
        return None
    phase = {s["seq"]: s["phase"] for s in spans}
    durs = [s["dur_us"] / 1e3 for s in spans if s["phase"] == "lm.forward"
            and phase.get(s["parent"]) == under]
    return statistics.median(durs) if durs else None


def idle_in_layers_share(rec):
    """Of the device's idle time in the traced window (the window less
    the union of the trace's device intervals), the share that lies
    inside the host's per-layer spans (``LAYER_SPANS``), on the trace's
    clock (%)."""
    spans = _spans(rec)
    prog = rec.get("program") or {}
    tr = rec.get("trace") or {}
    if spans is None or "clock" not in prog or "traced_ns" not in prog \
            or not tr.get("device_events"):
        return None
    perf0, unix0 = prog["clock"]
    lo, hi = (unix0 + t - perf0 for t in prog["traced_ns"])
    idle = _complement(union(tr["device_events"]), lo, hi)
    layers = union([(s["phase"], unix0 + s["t0_us"] * 1e3,
                     unix0 + (s["t0_us"] + s["dur_us"]) * 1e3)
                    for s in spans if s["phase"] in LAYER_SPANS])
    total = sum(b - a for a, b in idle)
    if total <= 0 or not layers:
        return None
    return 100.0 * _overlap(idle, layers) / total


def _complement(busy, lo, hi) -> list:
    """``[lo, hi]`` less the sorted, disjoint intervals ``busy``."""
    out, end = [], lo
    for a, b in busy:
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
