"""Straggler detection and mitigation hooks (a copy of the reference
``repro.train.straggler``, pure Python).

In a synchronous SPMD job a single slow host gates every step.  The
monitor tracks per-step wall time as an EWMA + variance; a step slower
than ``ewma + k * sigma`` (and over an absolute floor) is flagged.
Mitigations wired into the trainer:

  * ``on_straggler`` callback — production deployments map this to host
    cordoning / pod eviction / re-slicing;
  * deadline-based step skip: if a step exceeds ``hard_deadline_s`` the
    trainer treats it as a fault -> checkpoint-restart path (the same
    machinery that covers node failure, so one tested path covers both);
  * the data pipeline is stateless/seekable (data/tokens.py), so a
    restarted or re-sliced job resumes from (step, shard) with no replay.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.1          # EWMA coefficient
    k_sigma: float = 4.0        # flag threshold in std devs
    min_samples: int = 8
    abs_floor_s: float = 0.05   # ignore jitter below this
    hard_deadline_factor: float = 10.0

    _ewma: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: int = 0

    def observe(self, dt_s: float) -> dict:
        """Record one step time.  Returns {straggler, hard_fault, ewma}."""
        self._n += 1
        if self._n == 1:
            self._ewma, self._var = dt_s, 0.0
            return {"straggler": False, "hard_fault": False, "ewma": dt_s}
        # judge against PRE-update stats — otherwise an outlier inflates
        # its own threshold and never gets flagged
        sigma = self._var ** 0.5
        slow = (self._n > self.min_samples
                and dt_s > self._ewma + self.k_sigma * sigma
                and dt_s > self._ewma + self.abs_floor_s)
        hard = (self._n > self.min_samples
                and dt_s > self.hard_deadline_factor * max(self._ewma, 1e-6))
        delta = dt_s - self._ewma
        self._ewma += self.alpha * delta
        self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        if slow:
            self.flagged += 1
        return {"straggler": slow, "hard_fault": hard, "ewma": self._ewma}
