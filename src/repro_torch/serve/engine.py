"""Continuous-batching LM serving engine on the shared slot scheduler
(reference ``repro.serve.engine``).

The :class:`~repro_torch.serve.scheduler.SlotScheduler` owns placement
(slot table, pending queue, FIFO admission, recycling, counters); this
module implements its program: per-slot cache rows (K/V for attention
layers, SSM state and conv tail for mamba layers), preallocated output
buffers and batched sampling.  It serves the families the LM assembly
ports (``dense``, ``moe``, ``ssm``, ``hybrid``); every prefill of a mamba
layer runs the SSD scan kernel, and a ``moe`` prefill routes at the
config's capacity factor (it may drop tokens, as the reference's does)
while a decode tick never drops.

* **Continuous batching**: a finished sequence's slot is re-prefilled from
  the pending queue on the next tick.  The cache is a slot table
  (``models.transformer.init_slot_cache``) with a per-slot fill level;
  admission writes one sequence's prefix into its slot
  (``prefill_into_slot``) while the neighbours keep decoding, and every
  tick is one ``decode_step_slotted`` over all slots whatever the
  occupancy.  The port runs eagerly: there is no per-prompt-shape
  compile cache.
* **Preallocated output**: generated tokens land in a fixed (S, max_len)
  int32 host buffer at a per-slot cursor.
* **Quantized serving** (``quant_bits`` 8 or 16):
  ``compress.tree.quantize_tree`` makes the integer tree and its scales on
  the engine's device; the backbone runs over the dequantized (bfloat16)
  weights, and the sampling head runs the integer weights through
  ``kernels.q15_matmul`` (the hand-written kernel on the card, its plain
  version on the CPU).  The (K, V) integer head is laid out once: the
  transposed embedding table for tied configs, ``lm_head.w`` otherwise.
  A stacked leaf is one tensor with one scale, a ``moe`` block's
  ``(L, E, d_in, d_out)`` expert weights included, as in the reference.

The engine runs on ``device`` (default ``"cuda"``; asking for the card
without one raises).  Per-slot host state stays numpy, as in the
reference; a request carries tokens only (the reference's ``extra``
inputs feed the vlm frontend, which is not ported).  Greedy sampling is an argmax; temperature sampling draws from
a ``torch.Generator`` seeded with ``ServeConfig.seed`` on the engine's
device (it cannot match JAX's PRNG).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch.compress.tree import dequantize_tree, quantize_tree
from repro_torch.device import resolve_device
from repro_torch.kernels.q15_matmul.ops import as_scale, q15_matmul
from repro_torch.models import transformer as T
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.pytree import tree_map
from repro_torch.serve.scheduler import HostProgram, SlotScheduler, TickReport


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048             # per-slot KV capacity (prompt + new)
    max_slots: int = 8              # resident batch width (decode batch)
    temperature: float = 0.0        # 0 -> greedy
    eos_id: int = -1                # -1 -> never stop early
    quant_bits: int = 0             # 0 off, 8, 16
    seed: int = 0
    admit_policy: str = "any_free"  # "all_free" = window-boundary baseline


@dataclasses.dataclass
class LMRequest:
    """One queued generation: a prompt and a token budget."""
    request_id: str
    tokens: np.ndarray              # (s,) int32 prompt
    max_new: int                    # total tokens to emit (incl. the first)


@dataclasses.dataclass
class Completion:
    """Event surfaced by :meth:`Engine.tick` when a request leaves a slot."""
    request_id: str
    tokens: np.ndarray              # (n_emitted,) int32
    finished: bool                  # False -> cancelled with partial output


class Engine:
    """Continuous-batching LM engine (prefill-into-slot + slotted decode)."""

    def __init__(self, cfg, params, serve_cfg: ServeConfig | None = None,
                 *, obs: Observability | None = None,
                 device: str | torch.device = "cuda"):
        T.require_ported(cfg)
        self.cfg = cfg
        self.scfg = scfg = serve_cfg or ServeConfig()
        self.device = dev = resolve_device(device)
        # spans lm.prefill / lm.decode / lm.tick, the lm.tick_us histogram
        # and the lm.tokens_generated counter; NULL_OBS keeps every hook a
        # no-op
        self._obs = NULL_OBS if obs is None else obs
        self._tracer = self._obs.tracer
        params = tree_map(lambda t: t.to(dev), params)
        if scfg.quant_bits:
            self.qparams, self.scales = quantize_tree(params,
                                                      scfg.quant_bits)
            self.params = dequantize_tree(self.qparams, self.scales)
            # the (K, V) integer head, laid out once (the tied path would
            # otherwise transpose the whole table every tick)
            self._quant_head = True
            if not cfg.tie_embeddings and "lm_head" in self.qparams:
                self._head_wq = self.qparams["lm_head"]["w"]
                head_scale = self.scales["lm_head"]["w"]
            else:
                self._head_wq = self.qparams["embed"]["table"].T.contiguous()
                head_scale = self.scales["embed"]["table"]
            self._head_scale = as_scale(head_scale, dev)
        else:
            self.params = params
            self.qparams = self.scales = None
            self._quant_head = False
        S = scfg.max_slots
        self.cache = T.init_slot_cache(cfg, S, scfg.max_len,
                                       dtype=cfg.cdtype, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(scfg.seed)
        # --- per-slot host state (preallocated; written in place) -------
        self._out = np.zeros((S, scfg.max_len), np.int32)   # token buffer
        self._emitted = np.zeros(S, np.int64)               # out-buffer cursor
        self._budget = np.zeros(S, np.int64)
        self._eos_done = np.zeros(S, bool)
        self._last = np.zeros((S, 1), np.int32)             # next decode input
        self._results: dict[str, np.ndarray] = {}
        self._rid_counter = itertools.count()
        # telemetry
        self._prefill_count = 0
        self._decode_ticks = 0
        self._tokens_generated = 0
        self.sched = SlotScheduler(S, HostProgram(self),
                                   admit_policy=scfg.admit_policy,
                                   tracer=self._tracer)

    # ------------------------------------------------------------------
    # Request API
    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray, max_new: int, *,
               request_id: str | None = None) -> str:
        """Queue one prompt for ``max_new`` generated tokens (the first is
        sampled at prefill time).  Returns the request id; the sequence
        prefills into a slot as soon as the scheduler places it."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {tokens.shape}")
        if not 1 <= max_new <= self.scfg.max_len:
            raise ValueError(f"max_new must be in [1, {self.scfg.max_len}]")
        if tokens.shape[0] + max_new - 1 > self.scfg.max_len:
            raise ValueError(
                f"prompt ({tokens.shape[0]} tokens) + max_new ({max_new}) "
                f"exceeds max_len={self.scfg.max_len}")
        rid = request_id if request_id is not None \
            else f"r{next(self._rid_counter)}"
        self.sched.submit(rid, LMRequest(rid, tokens, int(max_new)))
        return rid

    def tick(self) -> list[Completion]:
        """One scheduling round: admit+prefill into free slots, one batched
        decode step over all resident sequences, release finished slots."""
        if not self._obs.enabled:
            return self.sched.tick()
        t0 = self._tracer.t()
        events = self.sched.tick()
        dur_ns = self._tracer.rec("lm.tick", t0)
        if self._obs.metrics is not None:
            self._obs.metrics.histogram(
                "lm.tick_us", "LM engine tick latency",
                wallclock=True).observe_ns(dur_ns)
        return events

    def run(self) -> list[Completion]:
        """Tick until every submitted request has completed."""
        events: list[Completion] = []
        while self.sched.has_work():
            events.extend(self.tick())
        return events

    def cancel(self, request_id: str) -> Completion:
        """Withdraw a request.  Resident sequences yield their partial
        tokens; a request still pending yields an empty result; either way
        :meth:`result` works afterwards."""
        ev = self.sched.cancel(request_id)
        if ev is None:                    # pending: nothing was emitted
            self._results[request_id] = np.zeros((0,), np.int32)
            ev = Completion(request_id, self._results[request_id].copy(),
                            False)
        return ev

    def result(self, request_id: str) -> np.ndarray:
        """Generated tokens of a completed/cancelled request (consumes it)."""
        return self._results.pop(request_id)

    def generate(self, tokens: np.ndarray, max_new: int) -> np.ndarray:
        """Run (B, s) prompts to completion and return (B, max_new) tokens
        (continuous batching when B > max_slots; rows that hit ``eos_id``
        early are padded with it)."""
        tokens = np.asarray(tokens, np.int32)
        rids = [self.submit(row, max_new) for row in tokens]
        self.run()
        pad = self.scfg.eos_id if self.scfg.eos_id >= 0 else 0
        out = np.full((tokens.shape[0], max_new), pad, np.int32)
        for i, rid in enumerate(rids):
            row = self.result(rid)
            out[i, :row.shape[0]] = row
        return out

    def stats(self) -> dict[str, Any]:
        sched = self.sched.stats()
        return {
            "max_slots": self.scfg.max_slots,
            "active": sched["active"],
            "pending": sched["pending"],
            "occupancy": sched["occupancy"],
            "peak_active": sched["peak_active"],
            "prefills": self._prefill_count,
            "decode_ticks": self._decode_ticks,
            "tokens_generated": self._tokens_generated,
            "quant_bits": self.scfg.quant_bits,
            "scheduler": sched,
        }

    # ------------------------------------------------------------------
    # SlotProgram hooks (called by the scheduler via HostProgram)
    # ------------------------------------------------------------------
    def _admit_slot(self, slot: int, request_id: str, req: LMRequest,
                    reset: bool) -> None:
        # No reset_cache_slot: prefill overwrites the SSM and conv rows
        # entirely and the K/V rows up to the prompt length, and everything
        # past ``pos`` is masked out, so a recycled slot cannot leak its
        # previous occupant.
        batch = {"tokens": torch.as_tensor(req.tokens[None, :],
                                           device=self.device)}
        # lm.prefill and lm.decode end after sampling, whose copy to the
        # host waits for the device: each span holds the work it queued
        t0 = self._tracer.t()
        out, self.cache = T.prefill_into_slot(
            self.cfg, self.params, self.cache, batch, slot,
            return_hidden=self._quant_head)
        logits = self._head_logits(out) if self._quant_head \
            else out[:, -1, :]
        first = self._sample(logits)[0]
        self._tracer.rec("lm.prefill", t0)
        self._out[slot, 0] = first
        self._emitted[slot] = 1
        self._budget[slot] = req.max_new
        self._last[slot, 0] = first
        self._eos_done[slot] = (self.scfg.eos_id >= 0
                                and first == self.scfg.eos_id)
        self._prefill_count += 1
        self._tokens_generated += 1

    def _advance(self, resident: np.ndarray) -> TickReport:
        need = resident & ~self._eos_done & (self._emitted < self._budget)
        if need.any():
            t0 = self._tracer.t()
            out, self.cache = T.decode_step_slotted(
                self.cfg, self.params, self.cache,
                torch.as_tensor(self._last, device=self.device),
                torch.as_tensor(need, device=self.device),
                return_hidden=self._quant_head)
            logits = self._head_logits(out) if self._quant_head \
                else out[:, 0, :]
            nxt = self._sample(logits)                    # (S,) batched
            self._tracer.rec("lm.decode", t0)
            rows = np.nonzero(need)[0]
            self._out[rows, self._emitted[rows]] = nxt[rows]
            self._emitted[rows] += 1
            self._last[rows, 0] = nxt[rows]
            if self.scfg.eos_id >= 0:
                self._eos_done[rows] |= (nxt[rows] == self.scfg.eos_id)
            self._decode_ticks += 1
            self._tokens_generated += int(rows.size)
            if self._obs.metrics is not None:
                self._obs.metrics.counter(
                    "lm.tokens_generated",
                    "tokens emitted by decode ticks").inc(int(rows.size))
        finished = resident & (self._eos_done
                               | (self._emitted >= self._budget))
        fin_rows = np.nonzero(finished)[0].tolist()
        events = [Completion(self.sched.request_at(s),
                             self._out[s, :self._emitted[s]].copy(), True)
                  for s in fin_rows]
        return TickReport(events=events, finished=fin_rows,
                          advanced=int(need.sum()))

    def _release_slot(self, slot: int, request_id: str,
                      reason: str) -> Completion | None:
        toks = self._out[slot, :self._emitted[slot]].copy()
        self._results[request_id] = toks
        self._emitted[slot] = 0
        self._budget[slot] = 0
        self._eos_done[slot] = False
        if reason == "cancelled":
            return Completion(request_id, toks, False)
        return None

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _head_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The sampling head over the integer weights through
        ``q15_matmul``.  hidden: (n, s, D); uses the last position.
        -> (n, V) float32."""
        return q15_matmul(hidden[:, -1, :].float(), self._head_wq,
                          self._head_scale, out_dtype=torch.float32)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(n, V) -> (n,) int32, greedy or temperature (batched)."""
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32).cpu().numpy()
