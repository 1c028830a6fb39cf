"""1 - the union of the trace's device intervals over the traced part of
a serving window's wall time (%)."""
from portbench.harness.devtrace import busy_ns


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or not tr or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - busy_ns(tr["device_events"]) / 1e9 / tr["wall_s"])
