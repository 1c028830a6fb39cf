#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 is switched off for matmuls and cuDNN (no matmul or
   convolution runs on this path, so this only pins the setting).
2. build the step kernel (``src/repro_torch/csrc/q15_step.cu``) with nvcc.
3. kernel vs plain on the card: S = 131,072 streams at paper width, low-
   and full-rank, deployed / calibrated / naive activation storage, about a
   third of the rows masked, 128 chained steps.  The kernel must equal the
   plain torch step bitwise every step; the plain step on the card must
   equal the CPU plain step bitwise on 4,096 rows, and the scalar
   ``QRuntime`` must agree bitwise on 64 rows.
4. the main path: ``StreamingEngine.from_artifact`` on ``cuda`` with
   131,072 slots over an artifact (seeded PTQ at ``fastgrnn_har`` width,
   round-tripped through ``.fgar``); 131,072 + 1,024 synthetic-HAPT streams
   (some two windows long, some detached mid-window, the extra ones pending
   until slots free), drained.  Launches must equal advancing ticks,
   sampled streams' events must be bitwise those of the CPU engine and of
   the scalar ``QRuntime``, and no hidden-state byte may go host-to-device.
5. a profiled steady window of the main path (torch.profiler, host and
   device): the step kernel's device time and the device's busy share.
6. time the kernel and the plain step per launch at S = 131,072 (CUDA
   events over launches queued behind a sleep, after warm-up, over input
   sets larger than L2; the host's enqueue cost beside them) and the
   HBM bound.

The last lines are the ``{"kernels": [...]}`` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
S_KERNEL = 131_072        # streams in the kernel-vs-plain phase
STEPS = 128               # chained steps per configuration
CPU_ROWS = 4_096          # rows re-run by the CPU plain step
SCALAR_ROWS = 64          # rows re-run by the scalar QRuntime
SLOTS = 131_072           # engine slots on the main path
EXTRA = 1_024             # streams that wait pending for a free slot
DETACH_TICK = 60          # mid-window detach point
SAMPLED = 256             # streams replayed on the CPU engine
SCALAR_STREAMS = 64       # of those, replayed by the scalar QRuntime
PROFILE_WARM = 10         # untraced ticks before the profiled window
PROFILE_TICKS = 20        # ticks in the profiled steady window
TIMING_SETS = 8           # input sets cycled by the timing phase (> L2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM data sheet, fp32 outside tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def first_diff(a, b) -> str:
    import torch
    ne = (a.view(torch.int32) != b.view(torch.int32)).nonzero()
    r, c = (int(v) for v in ne[0])
    return (f"{ne.shape[0]} values differ, first at row {r} col {c}: "
            f"{float(a[r, c])!r} vs {float(b[r, c])!r}")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def environment(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    nvcc_ver = run([nvcc, "--version"]).splitlines()[-1]
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(f"card (nvidia-smi name, power.limit): {card}")
    print(f"nvcc {nvcc}: {nvcc_ver}")
    print(f"triton: {triton_ver}  ninja: {shutil.which('ninja')}")
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    return card


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build("q15_step")
    dt = time.perf_counter() - t0
    print(f"build: {lib.name} in {dt:.2f} s")
    return dt


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def storage_modes(qp, windows):
    from repro_torch.core.qruntime import QRuntime, calibrate
    scales = calibrate(QRuntime(qp), windows)
    return {"deployed": {}, "calibrated": {"act_scales": scales},
            "naive": {"naive_acts": True}}


def kernel_vs_plain(torch, windows, dev) -> float:
    import numpy as np
    from repro_torch import weights
    from repro_torch.core.qruntime import QRuntime
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell import qstep
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step

    max_err = 0.0
    for low_rank in (True, False):
        qp = quantize_params(weights.random_params(SEED, low_rank=low_rank),
                             QuantConfig())
        for mode, kw in storage_modes(qp, windows[:5]).items():
            t0 = time.perf_counter()
            sw = qstep.StepWeights.from_quantized(qp, **kw)
            k_dev = make_fastgrnn_step(sw, device=dev)
            k_cpu = make_fastgrnn_step(sw, device="cpu")
            rt = QRuntime(qp, **kw)
            H, d = sw.hidden_dim, sw.input_dim
            g = torch.Generator(device=dev).manual_seed(SEED)
            h0 = 0.5 * torch.randn(S_KERNEL, H, generator=g, device=dev)
            h_k = h_p = h0
            h_c = h0[:CPU_ROWS].cpu()
            h_s = h0[:SCALAR_ROWS].cpu().numpy()
            for t in range(STEPS):
                # ~2% of rows get large inputs so the LUT saturation and
                # storage clip paths run too
                big = torch.rand(S_KERNEL, 1, generator=g, device=dev) < 0.02
                x = torch.randn(S_KERNEL, d, generator=g, device=dev) \
                    * torch.where(big, 200.0, 1.0)
                m = torch.rand(S_KERNEL, generator=g, device=dev) >= 1 / 3
                h_k = k_dev(h_k, x, m)
                h_p = k_dev.plain(h_p, x, m)
                if not bits_equal(h_k, h_p):
                    fail(f"kernel != plain ({mode}, low_rank={low_rank}, "
                         f"step {t}): {first_diff(h_k, h_p)}")
                max_err = max(max_err, float((h_k - h_p).abs().max()))
                xc, mc = x[:CPU_ROWS].cpu(), m[:CPU_ROWS].cpu()
                h_c = k_cpu(h_c, xc, mc)
                if not bits_equal(h_p[:CPU_ROWS].cpu(), h_c):
                    fail(f"plain cuda != plain cpu ({mode}, low_rank="
                         f"{low_rank}, step {t}): "
                         f"{first_diff(h_p[:CPU_ROWS].cpu(), h_c)}")
                xs, ms = xc[:SCALAR_ROWS].numpy(), mc[:SCALAR_ROWS].numpy()
                h_s = np.stack([rt.step(h_s[b], xs[b]) if ms[b] else h_s[b]
                                for b in range(SCALAR_ROWS)])
                if not bits_equal(torch.from_numpy(h_s), h_c[:SCALAR_ROWS]):
                    fail(f"QRuntime != plain cpu ({mode}, low_rank="
                         f"{low_rank}, step {t})")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            print(f"kernel==plain bitwise: {'low' if low_rank else 'full'}"
                  f"-rank {mode:10s} S={S_KERNEL} x {STEPS} steps "
                  f"(cpu plain {CPU_ROWS} rows, QRuntime {SCALAR_ROWS} rows) "
                  f"in {time.perf_counter() - t0:.1f} s")
    return max_err


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

class Feeds:
    """Deterministic per-stream samples: a pool of synthetic-HAPT windows
    plus a bank of small noise, both made once from the seed."""

    def __init__(self, np, hapt):
        self.pool = hapt.generate_synthetic("test", SEED, n=4096).windows
        rng = np.random.default_rng(SEED)
        self.noise = (0.02 * rng.standard_normal((4093, 256, 3))).astype(
            np.float32)
        self.np = np

    def kind(self, i: int) -> str:
        if i % 16 == 0:
            return "two"
        if i % 16 == 1 and i < SLOTS:
            return "detach"
        return "one"

    def samples(self, i: int):
        np = self.np
        P = len(self.pool)
        n = self.noise[(i * 7919) % len(self.noise)]
        if self.kind(i) == "two":
            return np.concatenate([self.pool[i % P],
                                   self.pool[(i + 1) % P]]) + n
        return self.pool[i % P] + n[:128]


def drive(engine, feeds, ids):
    """Attach ``ids``, tick to the detach point, detach the mid-window
    streams, drain.  Returns (events, per-tick seconds, wall seconds,
    steady-tick ledger delta)."""
    import torch
    for i in ids:
        kind = feeds.kind(i)
        total = None if kind == "detach" else (256 if kind == "two" else 128)
        engine.attach(f"s{i}", feeds.samples(i), total_steps=total)
    events, ticks = [], []
    steady = None
    t_start = time.perf_counter()
    for t in range(DETACH_TICK):
        before = dict(engine.kernel.transfers.snapshot())
        t0 = time.perf_counter()
        events += engine.step()
        ticks.append(time.perf_counter() - t0)
        if t == 10:   # a steady tick: nothing admitted or emitted
            after = engine.kernel.transfers.snapshot()
            steady = {k: after[k] - before[k] for k in after}
    for i in ids:
        if feeds.kind(i) == "detach":
            events.append(engine.detach(f"s{i}"))
    while engine._any_buffered():
        n = engine.stats()["ticks"]
        t0 = time.perf_counter()
        events += engine.step()
        ticks.append(time.perf_counter() - t0)
        if engine.stats()["ticks"] == n:
            fail("a tick advanced no stream while samples were buffered")
    if engine.kernel.device.type == "cuda":
        torch.cuda.synchronize()
    return events, ticks, time.perf_counter() - t_start, steady


def per_stream(events, wanted) -> dict:
    """{stream_id: [(kind, step, window_step, prediction, warm, logits
    bytes)]} for the wanted ids, from per-stream and columnar events."""
    out = {sid: [] for sid in wanted}
    for e in events:
        if e is None:
            continue
        if hasattr(e, "stream_ids"):
            for j, sid in enumerate(e.stream_ids):
                if sid in out:
                    out[sid].append(("final" if e.final[j] else "window",
                                     int(e.steps[j]), int(e.window_steps[j]),
                                     int(e.predictions[j]), bool(e.warm[j]),
                                     e.logits[j].tobytes()))
        elif e.stream_id in out:
            out[e.stream_id].append((e.kind, e.step, e.window_step,
                                     e.prediction, e.warm,
                                     e.logits.tobytes()))
    return out


def main_path(torch, np, dev):
    from repro_torch import weights
    from repro_torch.compress import ModelArtifact
    from repro_torch.core.qruntime import QRuntime
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.data import hapt
    from repro_torch.obs import Observability, Tracer
    from repro_torch.serve.streaming import StreamingConfig, StreamingEngine

    params = weights.random_params(SEED)
    art = ModelArtifact.from_params(params, {"source": "chip_smoke seed 0"})
    art = art.replace(qp=quantize_params(params, QuantConfig()))
    blob = art.to_bytes()
    art = ModelArtifact.from_bytes(blob)
    if art.to_bytes() != blob:
        fail(".fgar round trip changed the bytes")
    feeds = Feeds(np, hapt)
    ids = list(range(SLOTS + EXTRA))

    # the host-clock span tracer breaks each tick into its phases
    obs = Observability(tracer=Tracer(capacity=1024))
    eng = StreamingEngine.from_artifact(
        art, StreamingConfig(max_slots=SLOTS, batch_events=True, device=dev),
        obs=obs)
    step_kernel = eng.kernel.kernel
    t0 = time.perf_counter()
    step_kernel.launches = 0            # count the main path's run only
    events, ticks, wall, steady = drive(eng, feeds, ids)
    launches = step_kernel.launches
    setup = time.perf_counter() - t0 - wall
    st = eng.stats()
    if launches != st["ticks"]:
        fail(f"kernel launches {launches} != advancing ticks {st['ticks']}")
    expect_steps = sum(DETACH_TICK if feeds.kind(i) == "detach" else
                       (256 if feeds.kind(i) == "two" else 128) for i in ids)
    if st["stream_steps"] != expect_steps:
        fail(f"stream steps {st['stream_steps']} != {expect_steps}")
    tr = st["transfers"]
    if tr["h_h2d_bytes"] != 0:
        fail(f"h-state h2d bytes {tr['h_h2d_bytes']} != 0")
    if steady["h_h2d_bytes"] or steady["h_d2h_bytes"]:
        fail(f"steady tick moved h bytes: {steady}")

    # sampled streams: the CPU engine and the scalar runtime
    step = (SLOTS + EXTRA) // SAMPLED
    sample = sorted({k * step + (k % 16) for k in range(SAMPLED)}
                    | {SLOTS + 1, SLOTS + EXTRA - 1})
    sample = [i for i in sample if i < SLOTS + EXTRA]
    cpu = StreamingEngine.from_artifact(
        art, StreamingConfig(max_slots=len(sample), device="cpu",
                             batch_events=True))
    cpu_events = drive(cpu, feeds, sample)[0]
    wanted = [f"s{i}" for i in sample]
    got, ref = per_stream(events, wanted), per_stream(cpu_events, wanted)
    for sid in wanted:
        if not got[sid] or got[sid] != ref[sid]:
            fail(f"stream {sid}: cuda events {got[sid][:1]} != "
                 f"cpu events {ref[sid][:1]}")
    rt = QRuntime.from_artifact(art)
    for i in sample[:SCALAR_STREAMS]:
        x = feeds.samples(i)
        kind = feeds.kind(i)
        wins = ([x[:128], x[128:]] if kind == "two" else
                [x[:DETACH_TICK]] if kind == "detach" else [x])
        logits = [rt.run_window(w).tobytes() for w in wins]
        if [e[5] for e in got[f"s{i}"]] != logits:
            fail(f"stream s{i}: logits differ from the scalar QRuntime")

    ms = np.array(ticks) * 1e3
    rate = st["stream_steps"] / wall
    p50, p95, p99 = np.percentile(ms, [50, 95, 99])
    print(f"main path: {len(ids)} streams ({EXTRA} pending at attach) over "
          f"{SLOTS} slots, {st['ticks']} ticks, {st['stream_steps']} "
          f"stream-steps in {wall:.3f} s = {rate:,.0f} stream-steps/s; "
          f"{len(ms)} step() calls: p50 {p50:.3f} ms, p95 {p95:.3f} ms, "
          f"p99 {p99:.3f} ms, max {ms.max():.3f} ms; "
          f"{int((ms > 20.0).sum())} over the 50 Hz budget of 20 ms; "
          f"set-up (attach) {setup:.1f} s")
    print(f"main path: transfers {tr}; steady tick {steady}")
    print("main path host phases (count, total ms, p50 us, p99 us): " +
          "; ".join(f"{k} {v['count']} {v['total_us'] / 1e3:.1f} "
                    f"{v['p50_us']:.1f} {v['p99_us']:.1f}"
                    for k, v in obs.tracer.phase_stats().items()))
    print(f"main path: {len(sample)} sampled streams bitwise equal to the "
          f"CPU engine, {SCALAR_STREAMS} to the scalar QRuntime")
    print("kernels: " + json.dumps([{"name": "q15_step", "launches": launches,
                                     "bitwise": True}]))
    return launches, eng, feeds


# ---------------------------------------------------------------------------
# trace helpers (torch.profiler)
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """The trace's device-side events: kernels, copies and memsets."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the events' device intervals, in us."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def kernel_device_us(prof, name: str):
    """(launches, mean device us) of kernel ``name`` from the trace's
    ``key_averages``, or None when the trace holds no such kernel."""
    rows = [e for e in prof.key_averages() if name in e.key]
    n = sum(e.count for e in rows)
    t = sum(getattr(e, "device_time_total", 0.0) for e in rows)
    return (n, t / n) if n and t > 0 else None


# ---------------------------------------------------------------------------
# phase 5: a profiled steady window of the main path
# ---------------------------------------------------------------------------

def profiled_window(torch, eng, feeds) -> dict | None:
    """Refill the drained engine with one-window streams, step
    ``PROFILE_WARM`` ticks, then trace ``PROFILE_TICKS`` steady ticks
    (nothing admitted or emitted) with torch.profiler (host and device).
    The device busy share is the union of the trace's device intervals over
    the window's host wall time; the profiler's own host overhead lengthens
    that wall time, so the idle share read here is an upper estimate."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(SLOTS):
        eng.attach(f"p{i}", feeds.samples(i)[:128], total_steps=128)
    for _ in range(PROFILE_WARM):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = device_events(prof)
    if not evs:
        print("profiled window: the trace holds no device event, so the "
              "device busy share is not measured")
        return None
    busy = busy_us(evs)
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    kern = kernel_device_us(prof, "q15_step_kernel")
    print(f"profiled window ({PROFILE_TICKS} steady ticks, {SLOTS} active "
          f"slots): host wall {wall_us:.1f} us ({wall_us / PROFILE_TICKS:.1f}"
          f" us per tick), device busy {busy:.1f} us = {busy / wall_us:.2%}, "
          f"idle {1 - busy / wall_us:.2%}; q15_step_kernel "
          f"{kern[0] if kern else 0} launches x "
          f"{kern[1] if kern else float('nan'):.3f} us device time")
    print("profiled window device time by event (count, total us): " +
          "; ".join(f"{k[:60]} {n} {t:.1f}" for k, (n, t) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    return {"busy_share": busy / wall_us, "kernel": kern}


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def timing(torch, sw):
    """Per-launch times of the kernel and of the plain step at S = 131,072.

    Device time: the launches are queued behind ``torch.cuda._sleep`` so
    that they run back to back on the card whatever the host's enqueue
    rate, timed with CUDA events (``prefilled`` says the queue really was
    full when the host finished enqueuing).  Host time: the host's enqueue
    cost per call, timed back to back.  The kernel's device time is also
    read from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step
    from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep

    dev = torch.device("cuda", 0)
    k = make_fastgrnn_step(sw, device=dev)
    S, H, d = S_KERNEL, sw.hidden_dim, sw.input_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sets = [(torch.randn(S, H, generator=g, device=dev) * 0.5,
             torch.randn(S, d, generator=g, device=dev),
             torch.ones(S, dtype=torch.bool, device=dev))
            for _ in range(TIMING_SETS)]
    in_bytes = sum(t.numel() * t.element_size() for st in sets for t in st)

    def event():
        return torch.cuda.Event(enable_timing=True)

    a, b = event(), event()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / a.elapsed_time(b)

    def per_launch(fn, n, warm):
        for i in range(warm):
            fn(*sets[i % TIMING_SETS])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(*sets[i % TIMING_SETS])
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        torch.cuda._sleep(int(cycles_per_ms * (3 * host_ms * n + 5)))
        a, b = event(), event()
        a.record()
        for i in range(n):
            fn(*sets[i % TIMING_SETS])
        b.record()
        prefilled = not a.query()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n, host_ms, prefilled

    kern = [per_launch(k, 200, 40)]
    plain = [per_launch(k.plain, 6, 4)]
    kern.append(per_launch(k, 200, 40))      # plain, kernel, kernel, plain
    plain.append(per_launch(k.plain, 6, 4))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(100):
            k(*sets[i % TIMING_SETS])
        torch.cuda.synchronize()
    prof_k = kernel_device_us(prof, "q15_step_kernel")

    roof = Q15StreamStep(sw, device=dev).roofline(1.0)
    nbytes = S * roof["hbm_bytes_per_stream_step"]
    nops = S * roof["model_flops_per_stream_step"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    ms = min(r[0] for r in kern)
    plain_ms = min(r[0] for r in plain)
    host_ms = min(r[1] for r in kern)

    def fmt(rows, digits):
        return ", ".join(f"device {r[0] * 1e3:.{digits}f} us / host "
                         f"{r[1] * 1e3:.{digits}f} us"
                         f"{'' if r[2] else ' (queue drained: host-bound)'}"
                         for r in rows)

    print(f"timing S={S} over {TIMING_SETS} input sets ({in_bytes} B of "
          f"inputs, one {S * H * 4} B output block reused), launches queued "
          f"behind a sleep: kernel [{fmt(kern, 3)}]; plain "
          f"[{fmt(plain, 1)}] per call")
    print(f"timing: q15_step_kernel device time from the profiler "
          f"{'not measured (no device event)' if prof_k is None else f'{prof_k[1]:.3f} us over {prof_k[0]} launches'}"
          f"; the {'host enqueue' if host_ms > ms else 'device'} bounds "
          f"back-to-back launches (host {host_ms * 1e3:.3f} us vs device "
          f"{ms * 1e3:.3f} us)")
    print(f"timing: bound {bound * 1e3:.3f} us ({nbytes} B over 3.35 TB/s; "
          f"{nops} fp32 ops = {t_ops * 1e3:.3f} us); kernel at "
          f"{bound / ms:.1%} of the bound; no single PyTorch call computes "
          f"this step, so there is no library yardstick")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.data import hapt

    card = environment(torch)
    build()
    windows = hapt.generate_synthetic("test", SEED, n=8).windows
    dev = torch.device("cuda", 0)
    max_err = kernel_vs_plain(torch, windows, dev)
    launches, eng, feeds = main_path(torch, np, dev)
    profiled_window(torch, eng, feeds)
    sw = eng.kernel.sw
    del eng
    t = timing(torch, sw)
    print(json.dumps({"kernels": [{
        "name": "q15_step", "route": "cuda",
        "source": "src/repro_torch/csrc/q15_step.cu",
        "replaces": "src/repro/kernels/fastgrnn_cell/kernel.py:119",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
