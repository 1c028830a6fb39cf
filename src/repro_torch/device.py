"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import time

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Canonical ``torch.device`` for ``device``.  Only ``cpu`` and ``cuda``
    devices are accepted, and a CUDA device raises when no card is
    present: an entry point asked to run on the card never carries on on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cpu or cuda)")
    return dev


def clock_pair() -> tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` at one instant: the host's span
    counter against Unix time, the clock ``torch.profiler`` stamps the
    device's events with.  Of eight back-to-back counter / Unix /
    counter triples, the tightest, its Unix time set against the middle
    of its two counter reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1], best[2]
