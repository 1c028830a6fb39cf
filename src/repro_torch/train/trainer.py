"""Fault-tolerant training loop (reference ``repro.train.trainer``).

  * deterministic, seekable data (``data/tokens.py``): a restart resumes
    at (step, shard) with zero replay;
  * a checkpoint every N steps and at the end (atomic, see
    ``checkpoint.py``);
  * crash / hard-straggler handling: the step loop runs under a retry
    guard; on failure the trainer restores the last checkpoint and
    continues (``max_restarts`` bounds runaway loops);
  * the straggler EWMA monitor with an ``on_straggler`` callback.

Each step's ``time_s`` runs from the step function's call to a
``torch.cuda.synchronize`` of the parameters' card (on the CPU the call
itself is synchronous), so it holds the step's device work, as the
reference's ``block_until_ready`` makes it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import torch

from repro_torch.pytree import tree_leaves
from . import checkpoint as ckpt
from . import optimizer as opt_mod
from .straggler import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = ckpt.DEFAULT_DIR
    keep_last: int = 3
    max_restarts: int = 3
    log_every: int = 10
    iht_sparsity: float = 0.0        # paper stage S at LM scale
    iht_ramp_steps: int = 0
    adam: opt_mod.AdamConfig = dataclasses.field(
        default_factory=opt_mod.AdamConfig)


def _synchronize(tree) -> None:
    dev = next(tree_leaves(tree)).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _value(v) -> float:
    return float(v.item() if isinstance(v, torch.Tensor) else v)


class Trainer:
    def __init__(self, cfg: TrainerConfig, *, init_params_fn: Callable,
                 step_fn: Callable, batch_fn: Callable[[int], Any],
                 on_straggler: Callable | None = None,
                 fault_hook: Callable[[int], None] | None = None):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics).
        batch_fn(step) -> batch (deterministic!).  fault_hook is a test
        seam: raise inside to simulate a node failure at a given step."""
        self.cfg = cfg
        self.init_params_fn = init_params_fn
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.on_straggler = on_straggler
        self.fault_hook = fault_hook
        self.monitor = StragglerMonitor()
        self.restarts = 0
        self.history: list[dict] = []
        self.state: dict | None = None

    # -- state ------------------------------------------------------------
    def _fresh_state(self):
        params = self.init_params_fn()
        opt_state = opt_mod.init(params, self.cfg.adam)
        return {"params": params, "opt": opt_state}

    def _restore_or_init(self):
        last = ckpt.latest_step(self.cfg.checkpoint_dir)
        self.state = None           # a failed run's state goes first
        state = self._fresh_state()
        if last is None:
            return state, 0
        state = ckpt.restore(self.cfg.checkpoint_dir, last, state)
        return state, int(ckpt.read_metadata(self.cfg.checkpoint_dir, last)
                          .get("next_step", last))

    def _save(self, state, step: int):
        ckpt.save(self.cfg.checkpoint_dir, step, state,
                  metadata={"next_step": step}, keep_last=self.cfg.keep_last)

    # -- loop ---------------------------------------------------------------
    def run(self) -> list[dict]:
        """Train to ``total_steps``; the final state stays in
        ``self.state``.  Returns the history."""
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        while True:
            try:
                state, start = self._restore_or_init()
                self.state = self._run_from(state, start)
                return self.history
            except KeyboardInterrupt:
                raise
            except Exception as e:  # node failure / hard straggler path
                self.restarts += 1
                self.history.append({"event": "restart", "error": str(e),
                                     "restarts": self.restarts})
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}") from e

    def _run_from(self, state, start: int):
        for step in range(start, self.cfg.total_steps):
            if self.fault_hook is not None:
                self.fault_hook(step)
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                                batch)
            _synchronize(params)
            dt = time.perf_counter() - t0
            state = {"params": params, "opt": opt}
            verdict = self.monitor.observe(dt)
            if verdict["straggler"] and self.on_straggler:
                self.on_straggler(step, dt, verdict)
            rec = {"step": step, "time_s": dt,
                   **{k: _value(v) for k, v in metrics.items()}}
            self.history.append(rec)
            if (step + 1) % self.cfg.checkpoint_every == 0 \
                    or step + 1 == self.cfg.total_steps:
                self._save(state, step + 1)
        return state
