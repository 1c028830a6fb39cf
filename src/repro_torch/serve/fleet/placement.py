"""Shard -> device placement for the fleet.

Every shard runs on the device named in ``config.stream.device``:

* ``cuda`` (no index) — round-robin over the ``torch.cuda.device_count()``
  cards;
* a device with an index (``cuda:1``) — every shard on that one card;
* ``cpu`` — every shard on the CPU (the plain versions).

Unlike the reference (``repro.serve.fleet.placement``), nothing falls back
to process-local shards: a fleet asked for the card without one raises
(:func:`repro_torch.device.resolve_device`).  Co-located shards form one
device group, whose fused tick makes ONE kernel launch
(``fleet.engine``): on one card, every shard is in one group.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

def shard_devices(n_shards: int, device="cuda") -> list[torch.device]:
    """Per-shard device assignment for ``n_shards`` shards asked to run on
    ``device``."""
    dev = resolve_device(device)
    if dev.type == "cpu" or torch.device(device).index is not None:
        return [dev] * n_shards
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_shards)]


def device_groups(devices: list[torch.device]
                  ) -> list[tuple[torch.device, list[int]]]:
    """Group shard indices by device, preserving shard order — the fleet's
    fused tick makes ONE kernel launch per group and issues every group's
    launch before waiting on any (``fleet.engine._step_fused``)."""
    groups: dict[torch.device, list[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)
    return list(groups.items())
