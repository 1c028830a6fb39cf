#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 is switched off for matmuls and cuDNN (no matmul or
   convolution runs on these paths, so this only pins the setting).
2. build both step kernels (``src/repro_torch/csrc/q15_step.cu``, K1, and
   ``q15_step_dense.cu``, K2) with nvcc, one process per source, started
   together.
3. K1 vs plain on the card: S = 131,072 streams at paper width, low- and
   full-rank, deployed / calibrated / naive activation storage, about a
   third of the rows masked, 2 % of them driven into LUT saturation, 128
   chained steps.  The kernel must equal the plain torch step bitwise every
   step; the plain step on the card must equal the CPU plain step bitwise
   on 4,096 rows, and the scalar ``QRuntime`` must agree bitwise on 64 rows.
4. K2 vs plain on the card: the same inputs for the dense layout (low and
   full rank); K2 must equal ``qstep.step_dense`` bitwise every step and
   the plain dense step on the card the CPU one on 4,096 rows; K2 must be
   within 1e-6 of K1 after one step in deployed storage (the reference's
   bound for its dense layout) on 4,096 rows drawn like the reference's
   test; K2's runtime-width instantiation is checked at H = 12, d = 5.
5. the single-engine main path: ``StreamingEngine.from_artifact`` on
   ``cuda`` with 131,072 slots over an artifact (seeded PTQ at
   ``fastgrnn_har`` width, round-tripped through ``.fgar``); 131,072 +
   1,024 synthetic-HAPT streams (some two windows long, some detached
   mid-window, the extra ones pending until slots free), drained.  K1
   launches must equal advancing ticks, sampled streams' events must be
   bitwise those of the CPU engine and of the scalar ``QRuntime``, and no
   hidden-state byte may go host-to-device.
6. a profiled steady window of that path (torch.profiler, host and
   device): the step kernel's device time and the device's busy share.
7. the fleet main path on K2: ``FleetEngine.from_artifact`` with 4 shards
   x 32,768 slots, ``mxu=True``, the same streams, a live migration of 64
   streams and a decommission / recommission of one shard mid-run.  K2
   launches must equal the ticks that advanced (one device group), no
   h-state byte may go host-to-device on a steady tick, sampled streams'
   events must be bitwise those of a CPU fleet on ``step_dense``, and at
   least 99.9 % of the windows' predictions must equal the K1 engine's.
   Then a profiled steady window of the fleet, as in phase 6.
8. the same fleet on K1 (``mxu=False``): every stream's events must be
   bitwise those of the single engine (shard-count invariance on the card).
9. failover: 4 shards x 4,096 slots on K2, snapshots every 16 ticks, one
   crash at each tick phase; the events must be bitwise those of the same
   run without crashes.  The width is cut from 131,072 because every
   snapshot encodes each live stream in Python.
10. time K1 and K2 and their plain steps per launch at S = 131,072 (CUDA
    events over launches queued behind a sleep, after warm-up, over input
    sets larger than L2; the profiler's device time and the host's enqueue
    cost beside them) and their HBM bound.

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
SAMPLED = 256             # streams replayed on the CPU engine / fleet
SCALAR_STREAMS = 64       # of those, replayed by the scalar QRuntime
K1K2_ROWS = 4_096         # rows of the K2-vs-K1 one-step check
SHARDS = 4                # fleet shards on the fleet main path
SHARD_SLOTS = SLOTS // SHARDS
MIGRATE_TICK = 80         # fleet: live migration of MIGRATED streams
MIGRATED = 64
DECOMMISSION_TICK = 140   # fleet: shard 1 drained ...
RECOMMISSION_TICK = 160   # ... and returned to routing
MIN_AGREEMENT = 0.999     # K2 fleet windows whose prediction equals K1's
FO_SLOTS = 4_096          # failover: slots per shard (4 shards)
FO_SNAPSHOT_EVERY = 16
FO_CRASHES = ((7, "mid_dispatch", 1), (13, "pre_tick", 2),
              (20, "post_emit", 0))
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


def build() -> None:
    """Both kernels, one nvcc each, started together; each one's build time
    and what ptxas reports of its registers, shared memory and spills."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all(["q15_step", "q15_step_dense"])
    wall = time.perf_counter() - t0
    for name, (lib, dt, log) in built.items():
        print(f"build: {lib.name} in {dt:.2f} s")
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "stack frame")):
                print(f"  {line.strip()}")
    print(f"build: both kernels in {wall:.2f} s (parallel nvcc)")


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
# phase 4: K2 (dense layout) vs plain, and vs K1
# ---------------------------------------------------------------------------

def dense_vs_plain(torch, np, dev) -> float:
    """K2 against ``qstep.step_dense`` bitwise over chained steps at the
    main path's S, the plain dense step on the card against the CPU's, K2
    within 1e-6 of K1 after one step, and K2's runtime-width code path."""
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell import qstep
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step

    def model(low_rank, **kw):
        qp = quantize_params(weights.random_params(SEED, low_rank=low_rank,
                                                   **kw), QuantConfig())
        return qstep.StepWeights.from_quantized(qp)

    max_err = 0.0
    for low_rank in (True, False):
        t0 = time.perf_counter()
        sw = model(low_rank)
        k_dev = make_fastgrnn_step(sw, device=dev, mxu=True)
        k_cpu = make_fastgrnn_step(sw, device="cpu", mxu=True)
        H, d = sw.hidden_dim, sw.input_dim
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        h_k = h_p = 0.5 * torch.randn(S_KERNEL, H, generator=g, device=dev)
        h_c = h_k[:CPU_ROWS].cpu()
        for t in range(STEPS):
            big = torch.rand(S_KERNEL, 1, generator=g, device=dev) < 0.02
            x = torch.randn(S_KERNEL, d, generator=g, device=dev) \
                * torch.where(big, 200.0, 1.0)
            m = torch.rand(S_KERNEL, generator=g, device=dev) >= 1 / 3
            h_next = k_dev(h_k, x, m)
            if t == 0 and not k_dev.fixed_width(h_k, h_next):
                fail("K2 did not run its fixed-width code at paper width")
            h_k = h_next
            h_p = k_dev.plain(h_p, x, m)
            if not bits_equal(h_k, h_p):
                fail(f"K2 != plain dense (low_rank={low_rank}, step {t}): "
                     f"{first_diff(h_k, h_p)}")
            max_err = max(max_err, float((h_k - h_p).abs().max()))
            h_c = k_cpu(h_c, x[:CPU_ROWS].cpu(), m[:CPU_ROWS].cpu())
            if not bits_equal(h_p[:CPU_ROWS].cpu(), h_c):
                fail(f"plain dense cuda != cpu (low_rank={low_rank}, step "
                     f"{t}): {first_diff(h_p[:CPU_ROWS].cpu(), h_c)}")
        torch.cuda.synchronize()
        print(f"K2==plain dense bitwise: {'low' if low_rank else 'full'}-rank "
              f"S={S_KERNEL} x {STEPS} steps (cpu plain {CPU_ROWS} rows) in "
              f"{time.perf_counter() - t0:.1f} s")

        # one step against K1 in deployed storage, inputs drawn with numpy
        # like the reference's test of its dense layout
        rng = np.random.default_rng(SEED + 3)
        h = torch.from_numpy((rng.normal(size=(K1K2_ROWS, H)) * 0.4)
                             .astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(K1K2_ROWS, d))
                             .astype(np.float32)).to(dev)
        m = torch.ones(K1K2_ROWS, dtype=torch.bool, device=dev)
        k1 = make_fastgrnn_step(sw, device=dev)
        diff = float((k_dev(h, x, m) - k1(h, x, m)).abs().max())
        if not diff <= 1e-6:
            fail(f"K2 vs K1 after one step: max |diff| {diff} > 1e-6 "
                 f"(low_rank={low_rank})")
        print(f"K2 vs K1 one step, deployed storage, {K1K2_ROWS} rows: max "
              f"|diff| {diff:.3e} <= 1e-6")

    # the runtime-width instantiation (any width but the paper's)
    sw = model(True, hidden_dim=12, input_dim=5)
    k_dev = make_fastgrnn_step(sw, device=dev, mxu=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    h = 0.5 * torch.randn(CPU_ROWS, 12, generator=g, device=dev)
    x = torch.randn(CPU_ROWS, 5, generator=g, device=dev)
    m = torch.rand(CPU_ROWS, generator=g, device=dev) >= 1 / 3
    out = k_dev(h, x, m)
    if k_dev.fixed_width(h, out) or not bits_equal(out, k_dev.plain(h, x, m)):
        fail("K2 at H=12, d=5 (runtime-width code) != plain dense")
    print(f"K2==plain dense bitwise at H=12, d=5 (runtime-width code), "
          f"{CPU_ROWS} rows")
    return max_err


# ---------------------------------------------------------------------------
# phase 5: the single-engine main path
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
    sample = sample_ids()
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

    rate = st["stream_steps"] / wall
    print(f"main path: {len(ids)} streams ({EXTRA} pending at attach) over "
          f"{SLOTS} slots, {st['ticks']} ticks, {st['stream_steps']} "
          f"stream-steps in {wall:.3f} s = {rate:,.0f} stream-steps/s; "
          f"{len(ticks)} step() calls: {tick_stats(np, ticks)}; "
          f"set-up (attach) {setup:.1f} s")
    print_host("main path", tr, steady, obs.tracer)
    print(f"main path: {len(sample)} sampled streams bitwise equal to the "
          f"CPU engine, {SCALAR_STREAMS} to the scalar QRuntime")
    print("kernels: " + json.dumps([{"name": "q15_step", "launches": launches,
                                     "bitwise": True}]))
    return launches, eng, feeds, art, events


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
# phase 6: a profiled steady window of the single-engine main path
# ---------------------------------------------------------------------------

def profiled_window(torch, eng, feeds, kernel: str = "q15_step_kernel",
                    label: str = "profiled window") -> dict | None:
    """Refill the drained engine (or fleet) with one-window streams, step
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
        print(f"{label}: the trace holds no device event, so the device "
              "busy share is not measured")
        return None
    busy = busy_us(evs)
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    kern = kernel_device_us(prof, kernel)
    print(f"{label} ({PROFILE_TICKS} steady ticks, {SLOTS} active "
          f"slots): host wall {wall_us:.1f} us ({wall_us / PROFILE_TICKS:.1f}"
          f" us per tick), device busy {busy:.1f} us = {busy / wall_us:.2%}, "
          f"idle {1 - busy / wall_us:.2%}; {kernel} "
          f"{kern[0] if kern else 0} launches x "
          f"{kern[1] if kern else float('nan'):.3f} us device time")
    print(f"{label} device time by event (count, total us): " +
          "; ".join(f"{k[:60]} {n} {t:.1f}" for k, (n, t) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    return {"busy_share": busy / wall_us, "kernel": kern}


# ---------------------------------------------------------------------------
# phases 7-9: the fleet
# ---------------------------------------------------------------------------

def fleet_kernels(fleet) -> list:
    """Every step wrapper of a fleet: the device groups' and the shards'."""
    return ([k.kernel for k in fleet._group_kernels.values()]
            + [sh.kernel.kernel for sh in fleet.shards])


def totals(feeds, i: int):
    kind = feeds.kind(i)
    return None if kind == "detach" else (256 if kind == "two" else 128)


def drive_fleet(torch, fleet, feeds, ids, *, verbs: bool):
    """``drive`` for a fleet: attach ``ids``, tick to the detach point,
    detach the mid-window streams, drain; with ``verbs``, migrate
    ``MIGRATED`` two-window streams live at ``MIGRATE_TICK`` and drain /
    return shard 1 at ``DECOMMISSION_TICK`` / ``RECOMMISSION_TICK``.
    Returns (events, per-tick seconds, wall seconds, steady-tick transfer
    delta, advancing ticks, verbs report)."""
    for i in ids:
        fleet.attach(f"s{i}", feeds.samples(i), total_steps=totals(feeds, i))
    events, ticks = [], []
    steady, advancing, report = None, 0, {}
    t_start = time.perf_counter()

    def tick(t):
        nonlocal steady, advancing
        before = fleet._stream_steps()
        if t == 10:   # a steady tick: nothing admitted or emitted
            tr0 = fleet.stats()["transfers"]
        t0 = time.perf_counter()
        events.extend(fleet.step())
        ticks.append(time.perf_counter() - t0)
        if t == 10:
            tr1 = fleet.stats()["transfers"]
            steady = {k: tr1[k] - tr0[k] for k in tr1}
        if fleet._stream_steps() == before:
            fail(f"fleet tick {t} advanced no stream while samples were "
                 "buffered")
        advancing += 1

    for t in range(DETACH_TICK):
        tick(t)
    for i in ids:
        if feeds.kind(i) == "detach":
            events.append(fleet.detach(f"s{i}"))
    t = DETACH_TICK
    while fleet._any_buffered():
        if verbs and t == MIGRATE_TICK:
            moved = [f"s{i}" for i in ids if feeds.kind(i) == "two"][:MIGRATED]
            t0 = time.perf_counter()
            report["migrate"] = [fleet.migrate(sid) for sid in moved]
            report["migrate_s"] = time.perf_counter() - t0
        if verbs and t == DECOMMISSION_TICK:
            t0 = time.perf_counter()
            report["decommissioned"] = len(fleet.decommission(1))
            report["decommission_s"] = time.perf_counter() - t0
        if verbs and t == RECOMMISSION_TICK:
            fleet.recommission(1)
        tick(t)
        t += 1
    torch.cuda.synchronize()
    return (events, ticks, time.perf_counter() - t_start, steady, advancing,
            report)


def tick_stats(np, ticks) -> str:
    """Percentiles of per-tick seconds, and the ticks over the 50 Hz
    budget of 20 ms."""
    ms = np.array(ticks) * 1e3
    p50, p95, p99 = np.percentile(ms, [50, 95, 99])
    return (f"tick p50 {p50:.3f} ms, p95 {p95:.3f} ms, p99 {p99:.3f} ms, "
            f"max {ms.max():.3f} ms; {int((ms > 20.0).sum())} over the 50 Hz "
            "budget of 20 ms")


def print_host(label: str, tr, steady, tracer) -> None:
    """A path's transfer ledger, its steady tick's delta, and the host
    phases of the span tracer."""
    print(f"{label}: transfers {tr}; steady tick {steady}")
    print(f"{label} host phases (count, total ms, p50 us, p99 us): " +
          "; ".join(f"{k} {v['count']} {v['total_us'] / 1e3:.1f} "
                    f"{v['p50_us']:.1f} {v['p99_us']:.1f}"
                    for k, v in tracer.phase_stats().items()))


def sample_ids():
    step = (SLOTS + EXTRA) // SAMPLED
    sample = sorted({k * step + (k % 16) for k in range(SAMPLED)}
                    | {SLOTS + 1, SLOTS + EXTRA - 1})
    return [i for i in sample if i < SLOTS + EXTRA]


def fleet_path(torch, np, dev, art, feeds, single, *, mxu: bool) -> dict:
    """The fleet main path on K2 (``mxu``) or K1.  ``single`` is the
    single-engine main path's per-stream events."""
    from repro_torch.obs import Observability, Tracer
    from repro_torch.serve.fleet import FleetConfig, FleetEngine
    from repro_torch.serve.streaming import StreamingConfig

    name = "K2 (q15_step_dense)" if mxu else "K1 (q15_step)"
    ids = list(range(SLOTS + EXTRA))
    obs = Observability(tracer=Tracer(capacity=1024))
    t0 = time.perf_counter()
    fleet = FleetEngine.from_artifact(art, FleetConfig(
        shards=SHARDS, max_pending_per_shard=0,
        stream=StreamingConfig(max_slots=SHARD_SLOTS, batch_events=True,
                               device=dev, mxu=mxu)), obs=obs)
    if len(fleet._group_list) != 1:
        fail(f"{len(fleet._group_list)} device groups on one card, want 1")
    kernels = fleet_kernels(fleet)
    for k in kernels:
        k.launches = 0                  # count this path's run only
    events, ticks, wall, steady, advancing, report = drive_fleet(
        torch, fleet, feeds, ids, verbs=True)
    launches = sum(k.launches for k in kernels)
    setup = time.perf_counter() - t0 - wall
    kinds = {type(k).__name__ for k in kernels if k.launches}
    want = "DenseStep" if mxu else "FastGRNNStep"
    if kinds != {want}:
        fail(f"fleet launched {kinds}, want only {want}")
    if launches != advancing:
        fail(f"{name}: launches {launches} != advancing fleet ticks "
             f"{advancing}")
    st = fleet.stats()
    expect = sum(DETACH_TICK if feeds.kind(i) == "detach"
                 else totals(feeds, i) for i in ids)
    if st["stream_steps"] != expect:
        fail(f"{name}: stream steps {st['stream_steps']} != {expect}")
    if st["migrations"] != len(report["migrate"]) + report["decommissioned"]:
        fail(f"{name}: migrations {st['migrations']}")
    tr = st["transfers"]
    if steady["h_h2d_bytes"] or steady["h_d2h_bytes"]:
        fail(f"{name}: steady tick moved h bytes: {steady}")
    got = per_stream(events, [f"s{i}" for i in ids])
    if mxu:
        # sampled streams against a CPU fleet on the plain dense step
        sample = sample_ids()
        cpu = FleetEngine.from_artifact(art, FleetConfig(
            shards=SHARDS, max_pending_per_shard=0,
            stream=StreamingConfig(max_slots=len(sample), device="cpu",
                                   batch_events=True, mxu=True)))
        ref = per_stream(drive_fleet(torch, cpu, feeds, sample,
                                     verbs=False)[0],
                         [f"s{i}" for i in sample])
        for sid, want_ev in ref.items():
            if not want_ev or got[sid] != want_ev:
                fail(f"{name} fleet stream {sid}: events {got[sid][:1]} != "
                     f"cpu fleet {want_ev[:1]}")
        # predictions against the K1 single engine
        n = same = 0
        for sid, want_ev in single.items():
            mine = got[sid]
            if [e[:3] for e in mine] != [e[:3] for e in want_ev]:
                fail(f"{name} fleet stream {sid}: event steps differ from "
                     "the K1 engine")
            n += len(want_ev)
            same += sum(a[3] == b[3] for a, b in zip(mine, want_ev))
        share = same / n
        print(f"fleet {name}: {len(sample)} sampled streams bitwise equal to "
              f"the CPU fleet on step_dense; {same} of {n} windows "
              f"({share:.4%}) predict as the K1 engine")
        if share < MIN_AGREEMENT:
            fail(f"{name}: prediction agreement {share:.4%} < "
                 f"{MIN_AGREEMENT:.1%}")
    else:
        if got != single:
            bad = next(sid for sid in single if got[sid] != single[sid])
            fail(f"{name} fleet stream {bad}: events differ from the "
                 f"single engine's")
        share = 1.0
        print(f"fleet {name}: all {len(single)} streams' events bitwise "
              "equal to the single engine's")
    rate = st["stream_steps"] / wall
    print(f"fleet {name}: {SHARDS} shards x {SHARD_SLOTS} slots, "
          f"{len(ids)} streams, {len(ticks)} ticks ({advancing} advancing, "
          f"{launches} launches), {st['stream_steps']} stream-steps in "
          f"{wall:.3f} s = {rate:,.0f} stream-steps/s; "
          f"{tick_stats(np, ticks)}; set-up (build + attach) {setup:.1f} s")
    statuses = report["migrate"]
    print(f"fleet {name}: migrate {len(statuses)} streams at tick "
          f"{MIGRATE_TICK} "
          f"in {report['migrate_s'] * 1e3:.1f} ms "
          f"({statuses.count('active')} active, {statuses.count('pending')} "
          f"pending); decommission shard 1 at tick {DECOMMISSION_TICK}: "
          f"{report['decommissioned']} streams moved in "
          f"{report['decommission_s'] * 1e3:.1f} ms; recommission at tick "
          f"{RECOMMISSION_TICK}; global spills {st['global_spills']}")
    print_host(f"fleet {name}", tr, steady, obs.tracer)
    if mxu:
        profiled_window(torch, fleet, feeds, "q15_step_dense_kernel",
                        f"fleet {name} profiled window")
    del fleet
    return {"launches": launches, "rate": rate, "share": share}


def failover(torch, np, dev, art, feeds) -> None:
    """Failover on the card (K2): one crash at each tick phase against the
    same run without crashes, every event bitwise."""
    from repro_torch.serve.fleet import (FleetConfig, FleetEngine,
                                         ScheduledFaults)
    from repro_torch.serve.streaming import StreamingConfig

    ids = range(SHARDS * FO_SLOTS)
    logs, recovery = {}, []
    for crashes in (True, False):
        fleet = FleetEngine.from_artifact(art, FleetConfig(
            shards=SHARDS, max_pending_per_shard=0,
            snapshot_every=FO_SNAPSHOT_EVERY,
            stream=StreamingConfig(max_slots=FO_SLOTS, batch_events=True,
                                   device=dev, mxu=True)),
            faults=ScheduledFaults(schedule=FO_CRASHES) if crashes else None)
        crash = fleet.crash_shard

        def timed(shard, phase=None):
            t0 = time.perf_counter()
            out = crash(shard, phase=phase)
            torch.cuda.synchronize()
            recovery.append((time.perf_counter() - t0, out))
            return out

        fleet.crash_shard = timed
        for i in ids:
            x = feeds.samples(i)
            fleet.attach(f"s{i}", x, total_steps=len(x))
        t0 = time.perf_counter()
        events = fleet.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = fleet.stats()
        logs[crashes] = per_stream(events, [f"s{i}" for i in ids])
        print(f"failover ({'3 crashes' if crashes else 'no crash'}): "
              f"{SHARDS} x {FO_SLOTS} slots, {len(ids)} streams, "
              f"{st['ticks']} ticks in {wall:.3f} s, failovers "
              f"{st['failovers']}, snapshots {st['snapshots']}, replayed "
              f"{st['replayed_samples']} samples, suppressed "
              f"{st['replay_suppressed']} events")
        del fleet
    if len(recovery) != len(FO_CRASHES):
        fail(f"{len(recovery)} crashes ran, want {len(FO_CRASHES)}")
    if logs[True] != logs[False]:
        bad = next(s for s in logs[False] if logs[True][s] != logs[False][s])
        fail(f"failover: stream {bad} events differ from the run without "
             "crashes")
    for dt, rep in recovery:
        print(f"failover: shard {rep['shard']} crashed at {rep['phase']}: "
              f"{rep['streams_recovered']} streams recovered "
              f"({rep['replayed_samples']} samples to replay, "
              f"{rep['wire_bytes']} wire bytes) in {dt * 1e3:.1f} ms")
    print(f"failover: all {len(logs[False])} streams' events bitwise equal "
          "to the run without crashes")


# ---------------------------------------------------------------------------
# phase 10: timing
# ---------------------------------------------------------------------------

def timing(torch, sw) -> dict:
    """Per-launch times of K1 and K2 and of their plain steps at S =
    131,072, side by side in one process.

    Device time: the launches are queued behind ``torch.cuda._sleep`` so
    that they run back to back on the card whatever the host's enqueue
    rate, timed with CUDA events (``prefilled`` says the queue really was
    full when the host finished enqueuing).  Host time: the host's enqueue
    cost per call, timed back to back.  Each kernel's device time is also
    read from a torch.profiler trace.  Rounds run K1, K2, plain K1, plain
    K2 and then in the reverse order."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step
    from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep

    dev = torch.device("cuda", 0)
    steps = {"q15_step": make_fastgrnn_step(sw, device=dev),
             "q15_step_dense": make_fastgrnn_step(sw, device=dev, mxu=True)}
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

    kern = {n: [] for n in steps}
    plain = {n: [] for n in steps}
    order = list(steps)
    for names in (order, order[::-1]):
        for n in names:
            kern[n].append(per_launch(steps[n], 200, 40))
        for n in names:
            plain[n].append(per_launch(steps[n].plain, 6, 4))
    prof_us = {}
    for n, k in steps.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(100):
                k(*sets[i % TIMING_SETS])
            torch.cuda.synchronize()
        prof_us[n] = kernel_device_us(prof, f"{n}_kernel")

    def fmt(rows, digits):
        return ", ".join(f"device {r[0] * 1e3:.{digits}f} us / host "
                         f"{r[1] * 1e3:.{digits}f} us"
                         f"{'' if r[2] else ' (queue drained: host-bound)'}"
                         for r in rows)

    out = {}
    for n in steps:
        roof = Q15StreamStep(sw, device=dev, mxu=n == "q15_step_dense"
                             ).roofline(1.0)
        nbytes = S * roof["hbm_bytes_per_stream_step"]
        nops = S * roof["model_flops_per_stream_step"]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        ms = min(r[0] for r in kern[n])
        host_ms = min(r[1] for r in kern[n])
        prof_k = prof_us[n]
        print(f"timing {n} S={S} over {TIMING_SETS} input sets ({in_bytes} "
              f"B of inputs, one {S * H * 4} B output block reused), "
              f"launches queued behind a sleep: kernel [{fmt(kern[n], 3)}]; "
              f"plain [{fmt(plain[n], 1)}] per call")
        print(f"timing {n}: device time from the profiler "
              f"{'not measured (no device event)' if prof_k is None else f'{prof_k[1]:.3f} us over {prof_k[0]} launches'}"
              f"; the {'host enqueue' if host_ms > ms else 'device'} bounds "
              f"back-to-back launches (host {host_ms * 1e3:.3f} us vs device "
              f"{ms * 1e3:.3f} us)")
        print(f"timing {n}: bound {bound * 1e3:.3f} us ({nbytes} B over "
              f"3.35 TB/s; {nops} fp32 ops = {t_ops * 1e3:.3f} us); kernel at "
              f"{bound / ms:.1%} of the bound; no single PyTorch call "
              f"computes this gated step, so there is no library yardstick")
        out[n] = {"ms": ms, "plain_ms": min(r[0] for r in plain[n]),
                  "bound_ms": bound,
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


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
    dense_err = dense_vs_plain(torch, np, dev)
    launches, eng, feeds, art, events = main_path(torch, np, dev)
    profiled_window(torch, eng, feeds)
    sw = eng.kernel.sw
    del eng
    single = per_stream(events, [f"s{i}" for i in range(SLOTS + EXTRA)])
    del events
    k2 = fleet_path(torch, np, dev, art, feeds, single, mxu=True)
    fleet_path(torch, np, dev, art, feeds, single, mxu=False)
    del single
    failover(torch, np, dev, art, feeds)
    t = timing(torch, sw)
    src = "src/repro/kernels/fastgrnn_cell/kernel.py"
    rows = [("q15_step", f"{src}:119", launches, max_err),
            ("q15_step_dense", f"{src}:146", k2["launches"], dense_err)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": t[name]["ms"],
        "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
        "bound_by": t[name]["bound_by"], "library_ms": None}
        for name, replaces, n, err in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
