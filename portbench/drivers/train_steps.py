"""Driver ``train_steps``: the port's training step, back to back.

The mix gives ``seq_len`` and ``batch`` (tokens uniform over the
vocabulary, a new batch each step, drawn from the seed on the device),
``check_steps`` (the first steps, which the reference follows) and
``trace_steps`` (the steps of a traced run's window under the profiler).
The configuration's file gives Adam's settings (``train``).

Set-up builds one object, the step of ``models.registry.make_train_step``
with its parameters and float32 Adam state, and drives it through the
``check_steps`` first steps, reading each step's loss, the first
gradient as Adam got it (its first moment after one step over ``1 -
b1``) and the parameters' change after the last; the same object then
runs the window, each step ending in a synchronize.  Measured: tokens
trained over the window's seconds, the peak of allocated memory over the
window, and with ``--trace 1`` the device's idle share over the traced
steps and the model FLOPs of the steps after them over their seconds.
After the window the program's state is freed and the reference
runs the checked steps on the same parameters and batches: each step's
loss, each leaf's first-gradient norm and each leaf's change norm are
compared, the gap of the two norms over the reference's (or the median
leaf's, where that is larger); leaves whose reference gradient is under
a thousandth of the median leaf's are left out of the two leaf checks.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from portbench.counts import model as flops
from portbench.harness.devtrace import DeviceTrace
from portbench.harness.weights import leaves
from portbench.reference import lm as ref


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 1_000_003 + step) % (1 << 63))
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    B, S, V = mix["batch"], mix["seq_len"], cfg.vocab_size
    adam = ctx.cfg_file["train"]
    acfg = opt.AdamConfig(**adam)
    params = ctx.params
    p0 = {k: t.detach().to("cpu", copy=True) for k, t in leaves(params)}
    state = opt.init(params, acfg)
    step = registry.make_train_step(cfg, acfg)
    step = ctx.break_path(step) or step
    ctx.marks["state"] = time.perf_counter() - ctx.t_start
    batches = [batch_at(ctx.seed, i, B, S, V, dev)
               for i in range(mix["check_steps"])]
    losses, g1, change = [], {}, {}
    for i, b in enumerate(batches):
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        if i == 0:
            g1 = {k: float(m.float().norm()) / (1 - acfg.b1)
                  for k, m in leaves(state["m"])}
    change = {k: float((t.detach().float() - p0[k].to(dev).float()).norm())
              for k, t in leaves(params)}
    _sync(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n, t0 = 0, time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.marks["checked_steps"] = setup_s
    trace, traced, spans = None, None, []
    while True:
        if ctx.trace and n == 0:
            trace = DeviceTrace(dev).__enter__()
        a = time.perf_counter_ns()
        params, state, _ = step(params, state,
                                batch_at(ctx.seed, mix["check_steps"] + n,
                                         B, S, V, dev))
        _sync(dev)
        spans.append(("train step", a, time.perf_counter_ns()))
        n += 1
        now = time.perf_counter()
        if trace is not None and traced is None and (
                n == mix["trace_steps"] or now - t0 >= ctx.seconds):
            trace.__exit__(None, None, None)
            traced = (n, time.perf_counter())   # the profiler has stopped
        if now - t0 >= ctx.seconds:
            break
    t_end = time.perf_counter()
    window_s = t_end - t0
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    del params, state, step
    ctx.params = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, seen = _compare(cfg, p0, batches, adam, dev, losses, g1, change,
                            control=ctx.control)
    limits = ctx.cfg_file["limits"]["train"]
    out_checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in checks.items()}
    out = {
        "attempted": n, "failed": 0,
        "checks": out_checks,
        "correct": all(c["value"] <= c["limit"] for c in out_checks.values()),
        "memory_peak_bytes": int(memory_peak),
        "end_to_end": {"train_tokens_per_s": n * B * S / window_s,
                       "setup_s": setup_s},
        "notes": {"steps": n, "window_s": window_s, "losses": losses,
                  **seen},
    }
    if ctx.trace:
        n_traced, t_untraced = traced
        trace.read(host=spans[:n_traced])
        out["rec"] = {
            "cfg": cfg, "kind": "train", "window_s": window_s,
            "untraced": {
                "wall_s": t_end - t_untraced,
                "model_flops": (n - n_traced)
                * flops.train_step_flops(cfg, B, S)},
            "memory_peak_bytes": int(memory_peak),
            "trace": {"device_events": trace.device_events,
                      "wall_s": trace.wall_s}}
        out["busy_s"] = trace.busy_s()
        out["trace_window_s"] = trace.wall_s
        out["breakdown"] = trace.breakdown()
    return out


def _compare(cfg, p0, batches, adam, dev, losses, g1, change,
             control=None) -> dict:
    """The reference over the checked steps against the program's
    readings: the worst relative loss gap, and the worst leaf's gap of
    first-gradient norms and of change norms.  With ``control`` ("fp8"),
    the reference computed in that precision takes the program's
    place."""
    def reference(rounding=None):
        params = ref._unflat({k: t.to(dev) for k, t in p0.items()})
        ref.ROUND = rounding
        try:
            r_losses, r_g1, r_p = ref.train_steps(
                params, [(b["tokens"], b["labels"]) for b in batches],
                dataclasses.asdict(cfg), adam)
        finally:
            ref.ROUND = None
        return (r_losses, {k: float(g.norm()) for k, g in r_g1.items()},
                {k: float((r_p[k].float() - p0[k].to(dev).float()).norm())
                 for k in r_p})

    r_losses, r_gn, r_ch = reference()
    if control:
        losses, g1, change = reference(ref.ROUNDINGS[control])
    med_g = statistics.median(r_gn.values())
    keep = [k for k in r_gn if r_gn[k] >= 1e-3 * med_g]
    med_c = statistics.median(r_ch[k] for k in keep)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    grad = {k: abs(g1[k] - r_gn[k]) / max(r_gn[k], med_g) for k in keep}
    chg = {k: abs(change[k] - r_ch[k]) / max(r_ch[k], med_c) for k in keep}
    worst = {n: "/".join(max(d, key=d.get)) for n, d in
             (("first_grad_gap", grad), ("change_gap", chg))}
    return ({"loss_gap": loss_gap, "first_grad_gap": max(grad.values()),
             "change_gap": max(chg.values())},
            {"worst_leaf": worst, "left_out": ["/".join(k) for k in r_gn
                                               if k not in keep],
             "reference_losses": r_losses})
