"""Driver ``serve_closed_loop``: the LM ``Engine`` under a closed loop of
``clients`` clients, each submitting its next request as soon as its last
one completes.  The slots stay full whatever the engine's speed, so the
tokens per second read its capacity, with no ceiling set by the mix.

The mix gives ``clients``, the engine's ``max_slots`` and ``max_len``, the
prompt and output length distributions (``harness.traffic``), greedy
decoding with no EOS, ``lead_in``, ``sample`` (how many finished requests
the reference checks) and ``trace_ticks`` (the ticks of a traced run's
window under the profiler).  Before the window the loop runs on requests
of its own until ``lead_in`` of them have completed, so every shape the
traffic uses is warm and the window opens on a loop in its steady state.

The times are the engine's own spans (``lm.prefill``, ``lm.decode``).
The scheduler prefills requests in the order they were submitted, so the
n-th ``lm.prefill`` span is the n-th submission's, and the rows of each
``lm.decode`` follow from the requests resident then: every resident row
under its budget advances one token a tick.  Measured over the window:
every token the engine processed (prompt tokens prefilled plus tokens
generated) over its seconds; for each request submitted in it, the time
from when its client was ready to submit it to the end of its prefill,
which copies its first token to the host; the model FLOPs of each prefill
and decode at their shapes.  At the close the clients stop.  Each request
submitted in the window has a minute to finish, and one that does not,
or that returns fewer tokens than it asked for, counts as failed.  Then
the engine is freed and the reference checks a sample of the window's
requests, drawn from the seed, the longest among them: the widest gap by
which a served token's logit lies below the reference's best logit at
its position, over the prompt and the served tokens.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from portbench.counts import model as flops
from portbench.harness import traffic
from portbench.harness.devtrace import DeviceTrace
from portbench.reference import lm as ref

DRAIN_S = 60.0      # how long past the close a window's request may take
SPANS = ("lm.prefill", "lm.decode", "lm.tick", "sched.admit",
         "sched.release")


class _Loop:
    """The clients' requests, in the order they were submitted."""

    def __init__(self, eng):
        self.eng = eng
        self.reqs: list[dict] = []
        self._by_id: dict[str, dict] = {}

    def submit(self, r, phase: str, ready_ns: int) -> None:
        rid = f"{phase}{r.index}"
        rec = {"req": r, "phase": phase, "ready": ready_ns,
               "t_first": None, "out": None}
        self.reqs.append(rec)
        self._by_id[rid] = rec
        self.eng.submit(r.tokens, r.max_new, request_id=rid)

    def tick(self) -> int:
        """One engine tick; -> how many requests it completed."""
        events = self.eng.tick()
        for ev in events:
            self._by_id[ev.request_id]["out"] = self.eng.result(
                ev.request_id)
        return len(events)


def run(ctx) -> dict:
    from repro_torch.obs import Observability, Tracer
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    params = ctx.params
    now = time.perf_counter_ns
    epoch = now()       # the tracer's spans count from its construction
    obs = Observability(tracer=Tracer(capacity=1 << 17))
    eng = Engine(cfg, params, ServeConfig(
        max_len=mix["max_len"], max_slots=mix["max_slots"], temperature=0.0,
        eos_id=-1, quant_bits=ctx.cfg_file["serve"]["quant_bits"], seed=0),
        obs=obs, device=dev)
    loop = _Loop(eng)
    ctx.break_path(eng)
    ctx.marks["engine"] = time.perf_counter() - ctx.t_start

    # lead-in: the loop on requests of its own
    warm = traffic.RequestStream(mix, ctx.seed, cfg.vocab_size, key=1)
    for _ in range(mix["clients"]):
        loop.submit(warm.next(), "lead", now())
    done = 0
    while done < mix["lead_in"]:
        n = loop.tick()
        t = now()
        for _ in range(n):
            loop.submit(warm.next(), "lead", t)
        done += n
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    stream = traffic.RequestStream(mix, ctx.seed, cfg.vocab_size)
    t0 = now()
    setup_s = t0 / 1e9 - ctx.t_start
    ctx.marks["lead_in"] = setup_s
    trace = DeviceTrace(dev).__enter__() if ctx.trace else None
    traced, ticks = None, 0
    while True:
        n = loop.tick()
        t = now()
        for _ in range(n):
            loop.submit(stream.next(), "w", t)
        ticks += 1
        if trace is not None and traced is None \
                and ticks == mix["trace_ticks"]:
            trace.__exit__(None, None, None)
            traced = (trace.t0_ns, trace.t1_ns, now())
        if now() - t0 >= ctx.seconds * 1e9:
            break
    t_end = now()
    window_s = (t_end - t0) / 1e9
    if trace is not None and traced is None:
        trace.__exit__(None, None, None)
        traced = (trace.t0_ns, trace.t1_ns, now())
    window = [r for r in loop.reqs if r["phase"] == "w"]
    while any(r["out"] is None for r in window) \
            and now() - t_end < DRAIN_S * 1e9:
        loop.tick()
    drain_s = (now() - t_end) / 1e9
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    spans = obs.tracer.flight()
    if spans and spans[0]["seq"] != 0:
        raise RuntimeError("the engine's span ring wrapped: raise its "
                           "capacity")
    prefills, decodes = _replay(spans, loop.reqs, epoch)
    inside = lambda ev, a, b: a <= ev[0] <= b
    win_p = [p for p in prefills if inside(p, t0, t_end)]
    win_d = [d for d in decodes if inside(d, t0, t_end)]
    tokens = sum(s + 1 for *_, s in win_p) + sum(len(k) for *_, k in win_d)
    ok = [r for r in window if r["out"] is not None
          and r["out"].shape[0] == r["req"].max_new]
    failed = len(window) - len(ok)
    ttft = [(r["t_first"] - r["ready"]) / 1e6 for r in window
            if r["t_first"] is not None]

    # the program's state goes before the reference runs
    del eng, obs
    loop.eng = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    longest = max(ok, key=lambda r: r["req"].tokens.shape[0]
                  + r["req"].max_new, default=None)
    rest = [r for r in ok if r is not longest]
    sample = ([longest] if longest else []) + stream.sample(
        1, rest, mix["sample"] - 1)
    gap, ctl = _logit_gap(cfg, ctx.cfg_file, params, sample, dev,
                          control=ctx.control)
    limit = ctx.cfg_file["limits"]["serve"]["logit_gap"]
    program_gap = gap
    if ctx.control:                 # the control in the program's place
        gap = ctl

    out = {
        "attempted": len(window), "failed": failed,
        "checks": {"logit_gap": {"value": gap, "limit": limit},
                   "failed_requests": {"value": failed, "limit": 0}},
        "correct": not failed and gap <= limit and len(sample) > 0,
        "memory_peak_bytes": int(memory_peak),
        "end_to_end": {
            "tokens_per_s": tokens / window_s,
            "ttft_ms_p95": float(np.percentile(ttft, 95)) if ttft else None,
            "setup_s": setup_s},
        "notes": {"program_logit_gap": program_gap,
                  "requests": len(window), "sampled": len(sample),
                  "served_tokens_checked": int(sum(
                      r["out"].shape[0] for r in sample)),
                  "window_s": window_s, "tokens": tokens,
                  "prefills": len(win_p), "decode_ticks": len(win_d),
                  "drain_s": drain_s,
                  "ttft_ms_p50": float(np.percentile(ttft, 50))
                  if ttft else None},
    }
    if ctx.trace:
        a, b, c = traced      # the profiler stopped from b to c
        tp = [p for p in win_p if p[0] <= b]
        td = [d for d in win_d if d[0] <= b]
        rest_p = [p for p in win_p if p[0] > b]
        rest_d = [d for d in win_d if d[0] > b]
        host = [(s["phase"], epoch + int(s["t0_us"] * 1e3),
                 epoch + int((s["t0_us"] + s["dur_us"]) * 1e3))
                for s in spans if s["phase"] in SPANS]
        trace.read(host=[h for h in host if a <= h[1] <= b])
        out["rec"] = {
            "cfg": cfg, "kind": "serve", "window_s": window_s,
            "max_slots": mix["max_slots"],
            "untraced": {
                "wall_s": (t_end - c) / 1e9,
                "model_flops": (
                    sum(flops.prefill_flops(cfg, s) for *_, s in rest_p)
                    + sum(flops.decode_flops(cfg, k) for *_, k in rest_d))},
            "spans": {"lm.prefill": [(p[1] - p[0]) / 1e6 for p in win_p],
                      "lm.decode": [(d[1] - d[0]) / 1e6 for d in win_d]},
            "trace": {"device_events": trace.device_events,
                      "wall_s": (b - a) / 1e9,
                      "prefill_lengths": [s for *_, s in tp],
                      "decode_rows": [len(k) for *_, k in td],
                      "decode_ticks": len(td)},
        }
        out["busy_s"] = trace.busy_s()
        out["trace_window_s"] = (b - a) / 1e9
        out["notes"]["traced_ticks"] = min(ticks, mix["trace_ticks"])
        out["breakdown"] = trace.breakdown()
    return out


def _replay(spans, reqs, epoch):
    """The engine's prefills and decodes from its spans: the n-th
    ``lm.prefill`` is the n-th request submitted (the scheduler admits in
    that order); each ``lm.decode`` advances every resident row under its
    budget by one token, and a row leaves in the tick it reaches it.  Sets
    each request's ``t_first``.  ``epoch``: the ``perf_counter_ns`` the
    spans count from.  -> (prefills ``(t0_ns, t1_ns, prompt
    tokens)``, decodes ``(t0_ns, t1_ns, keys of each row)``)."""
    prefills, decodes, resident = [], [], []
    queue = iter(reqs)
    for sp in spans:
        if sp["phase"] not in ("lm.prefill", "lm.decode"):
            continue
        a = epoch + sp["t0_us"] * 1e3
        b = a + sp["dur_us"] * 1e3
        if sp["phase"] == "lm.prefill":
            rec = next(queue, None)
            if rec is None:
                raise RuntimeError("more prefills than requests submitted")
            rec["t_first"] = b
            s = int(rec["req"].tokens.shape[0])
            prefills.append((a, b, s))
            resident.append([rec["req"], 1])
            continue
        rows = [e for e in resident if e[1] < e[0].max_new]
        decodes.append((a, b, [e[0].tokens.shape[0] + e[1] for e in rows]))
        for e in rows:
            e[1] += 1
        resident = [e for e in resident if e[1] < e[0].max_new]
    return prefills, decodes


def _logit_gap(cfg, cfg_file, params, sample, dev, control=None):
    """The widest gap, over the sampled requests' served tokens, between
    the reference's best logit and the served token's, at the served
    token's position: the reference runs once over each prompt with its
    served tokens.  With ``control`` ("fp8"), also the widest gap of the
    tokens that the reference computed in that precision puts first at
    the same positions.  -> (gap, control's gap or None)."""
    d = dataclasses.asdict(cfg)
    W = ref.served_weights(params, cfg_file["serve"]["quant_bits"])
    worst, worst_ctl = 0.0, None
    for r in sample:
        prompt, served = r["req"].tokens, r["out"]
        s, n = prompt.shape[0], served.shape[0]
        toks = torch.as_tensor(np.concatenate([prompt, served[:-1]]),
                               device=dev)
        pos = torch.arange(s - 1, s - 1 + n, device=dev)
        logits = ref.logits_at(W, toks, pos, d)
        best = logits.max(1).values
        got = logits.gather(1, torch.as_tensor(
            served, device=dev).long()[:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
        if control:
            ref.ROUND = ref.ROUNDINGS[control]
            try:
                pick = ref.logits_at(W, toks, pos, d).argmax(1)
            finally:
                ref.ROUND = None
            gap = float((best - logits.gather(1, pick[:, None])[:, 0]).max())
            worst_ctl = max(worst_ctl or 0.0, gap)
        del logits
    del W
    return worst, worst_ctl
