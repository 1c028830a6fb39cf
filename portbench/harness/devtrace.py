"""The device trace of a traced run: ``torch.profiler`` over the device's
activity alone, read once into plain lists.

``busy`` is the length of the union of the device's intervals (kernels,
copies, memsets; the way ``chip_smoke.busy_us`` takes it), over the
traced window's host wall time.  Only the device's activity is recorded,
which leaves a host-paced loop near its own pace (recording the host's
operations as well slowed the serving loop and the training step by
1.6-3.5 times on an H100).  The breakdown names the device operations
that took most time and the longest stretches in which the device was
idle, each by what the host was doing at its middle: the outermost and
the innermost of the host intervals that the caller hands
:meth:`DeviceTrace.read` on ``time.perf_counter_ns``.  A marker launched
on the idle device as the trace opens puts them on the trace's clock.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.wall_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        # a CPU run has no device: its host is traced, and read as idle
        self.prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                            else [ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0_ns = self._mark_ns = time.perf_counter_ns()
        if cuda:    # the first device operation of the trace
            torch.ones(1, device=self.device)
        return self

    def __exit__(self, *exc):
        """The traced window ends once the device has finished its work,
        before the profiler stops (which takes seconds)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1_ns = time.perf_counter_ns()
        self.wall_s = (self.t1_ns - self.t0_ns) / 1e9
        self.prof.__exit__(*exc)
        return False

    def read(self, host):
        """Read the stopped profiler's events (after the window: reading
        takes seconds).  ``host``: the host's intervals ``(name,
        start_ns, end_ns)`` on ``perf_counter_ns``, which name the idle
        gaps."""
        dev = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
        shift = (min(a for _, a, _ in dev) - self._mark_ns) if dev else 0
        self.device_events = dev
        self.host_events = [(n, a + shift, b + shift) for n, a, b in host]
        self.prof = None

    def busy_s(self) -> float:
        return busy_ns(self.device_events) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for name, a, b in self.device_events:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": self._gaps(top)}

    def _gaps(self, top: int) -> list:
        if not self.host_events:
            return []
        lo = min(a for _, a, _ in self.host_events)
        hi = max(b for _, _, b in self.host_events)
        gaps, end = [], lo
        for a, b in union(self.device_events):
            if a > end:
                gaps.append((end, min(a, hi)))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        names = [n for n, _, _ in self.host_events]
        st = np.array([a for _, a, _ in self.host_events], np.int64)
        en = np.array([b for _, _, b in self.host_events], np.int64)
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            idx = np.nonzero((st <= mid) & (en >= mid))[0]
            if not len(idx):
                out.append(["idle host", (b - a) / 1e9])
                continue
            span = lambda i: en[i] - st[i]
            outer, inner = max(idx, key=span), min(idx, key=span)
            label = names[outer] if outer == inner \
                else f"{names[outer]}/{names[inner]}"
            out.append([label, (b - a) / 1e9])
        return out


def union(events):
    """The union of ``(name, start, end)`` intervals, in order."""
    out = []
    for a, b in sorted((a, b) for _, a, b in events):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(events) -> int:
    return sum(b - a for a, b in union(events))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"
