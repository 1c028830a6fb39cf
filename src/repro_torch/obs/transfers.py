"""Host<->device transfer accounting for the device-resident serving path.

The fleet's "zero steady-state copies of h" claim (device-resident async
ticks) must be a *measured invariant*, not a comment: every
``Q15StreamStep`` owns a :class:`TransferLedger` and books the bytes it
moves across the host/device boundary — per-tick ``x``/mask staging
(``h2d``), hidden-state uploads/downloads (``h2d``/``d2h`` with
``state=True``), and emission/tap/snapshot row pulls.  The ledger is a
handful of plain int adds, cheap enough to stay always-on (no
Observability bundle required), and tests/benchmarks read it through
``stats()["transfers"]``:

* a steady-state tick on the CUDA device-resident path books **zero**
  ``h_h2d_bytes``/``h_d2h_bytes`` (gated by ``chip_smoke.py``);
* the CPU path crosses no boundary and books nothing.

Byte counts are *logical* transfer volume: what crosses PCIe between the
host and the card.
"""
from __future__ import annotations

#: Ledger/snapshot keys, in canonical order: total staged bytes each way,
#: plus the hidden-state-only sub-accounts the zero-copy gate reads.
TRANSFER_KEYS = ("h2d_bytes", "d2h_bytes", "h_h2d_bytes", "h_d2h_bytes")


class TransferLedger:
    """Monotonic host<->device byte counters (one per kernel instance)."""

    __slots__ = TRANSFER_KEYS

    def __init__(self) -> None:
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h_h2d_bytes = 0
        self.h_d2h_bytes = 0

    def h2d(self, nbytes: int, *, state: bool = False) -> None:
        """Book a host->device transfer; ``state=True`` marks hidden-state
        bytes (the zero-copy invariant's sub-account)."""
        self.h2d_bytes += nbytes
        if state:
            self.h_h2d_bytes += nbytes

    def d2h(self, nbytes: int, *, state: bool = False) -> None:
        self.d2h_bytes += nbytes
        if state:
            self.h_d2h_bytes += nbytes

    def snapshot(self) -> dict[str, int]:
        return {k: getattr(self, k) for k in TRANSFER_KEYS}


def sum_transfers(snapshots) -> dict[str, int]:
    """Fold ledger snapshots (dicts) into one total — the fleet's
    ``stats()["transfers"]`` roll-up across shard + group kernels."""
    tot = dict.fromkeys(TRANSFER_KEYS, 0)
    for snap in snapshots:
        for k in TRANSFER_KEYS:
            tot[k] += snap[k]
    return tot
