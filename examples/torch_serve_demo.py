"""Serving demo on the PyTorch port: batched prefill + decode with the
L-S-Q quantized path.

    PYTHONPATH=src python examples/torch_serve_demo.py --arch mamba2-780m
    PYTHONPATH=src python examples/torch_serve_demo.py --shards 4
    (both take --device cuda|cpu; cuda, the default, raises without a card)

The port's counterpart of ``examples/serve_demo.py``.  Default mode runs a
reduced LM through the serving engine twice — bf16 weights and int8 (Q7)
per-tensor quantized weights (the paper's Q stage at LM scale, through
``repro_torch.compress.quantize_tree``; on ``cuda`` the quantized head is
the q15_matmul kernel) — and reports tokens generated, agreement between
the two paths, the per-tree weight-byte saving, and the weight bytes of
the full config.

``--shards N`` (N > 1) drives the *sensor-fleet* serving path instead: a
sharded ``serve.fleet.FleetEngine`` (N per-shard slot schedulers,
rendezvous routing, one fused Q15 step launch per device per tick)
classifies a batch of HAPT windows with a forced mid-stream migration,
and its predictions are checked bit for bit against the scalar QRuntime.
The initial weights are ``torch.Generator`` draws, not the reference's.
"""
import argparse

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.compress import tree_size_report
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, ServeConfig

parser = argparse.ArgumentParser()
parser.add_argument("--arch", default="deepseek-7b", choices=list(C.ARCHS))
parser.add_argument("--batch", type=int, default=4)
parser.add_argument("--new-tokens", type=int, default=24)
parser.add_argument("--shards", type=int, default=1,
                    help="> 1: demo the sharded Q15 sensor-fleet path "
                         "(serve/fleet) instead of the LM engine")
parser.add_argument("--metrics-out", default=None,
                    help="attach the repro_torch.obs telemetry bundle "
                         "(tracer + metrics) and write the metrics snapshot "
                         "JSON (schema 'metrics_snapshot') to this path")
parser.add_argument("--device", default="cuda")
args = parser.parse_args()
dev = resolve_device(args.device)


def _make_obs():
    if not args.metrics_out:
        return None
    from repro_torch.obs import Observability
    return Observability.full()


def _write_metrics(obs) -> None:
    if obs is None:
        return
    with open(args.metrics_out, "w") as f:
        f.write(obs.metrics.dumps() + "\n")
    phases = ", ".join(sorted(obs.tracer.phase_stats())) or "none"
    print(f"wrote {args.metrics_out} (traced phases: {phases})")


def fleet_demo(n_shards: int) -> None:
    from repro_torch.core import fastgrnn as fg
    from repro_torch.core.qruntime import QRuntime
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.data import hapt
    from repro_torch.serve.fleet import FleetConfig, FleetEngine
    from repro_torch.serve.streaming import StreamingConfig

    obs = _make_obs()
    qp = quantize_params(
        fg.init_params(fg.FastGRNNConfig(rank_w=2, rank_u=8),
                       torch.Generator().manual_seed(0)), QuantConfig(),
        device=dev)
    windows = hapt.load("test", n=96).windows
    fleet = FleetEngine(qp, FleetConfig(
        shards=n_shards, stream=StreamingConfig(max_slots=16, device=dev)),
        obs=obs)
    for i, w in enumerate(windows):
        fleet.attach(f"sensor-{i}", w, total_steps=len(w))
    for _ in range(40):                      # advance mid-window...
        fleet.step()
    moved = fleet.migrate("sensor-0")        # ...then live-migrate one
    dst = fleet.shard_of("sensor-0")
    events = fleet.drain()
    preds = {}
    for e in events:
        for ev in (e.events() if hasattr(e, "events") else [e]):
            preds[ev.stream_id] = ev.prediction
    ref = QRuntime(qp).predict_batch(windows)
    agree = float(np.mean([preds[f"sensor-{i}"] == ref[i]
                           for i in range(len(windows))]))
    st = fleet.stats()
    print(f"fleet: {st['shards']} shards x "
          f"{st['per_shard'][0]['max_slots']} slots on {dev}, "
          f"{st['completed']} streams classified, "
          f"{st['migrations']} live migration(s) "
          f"(sensor-0 re-attached {moved!r} on shard {dst})")
    print(f"scheduler roll-up: {st['scheduler']['admissions']} admissions, "
          f"{st['scheduler']['spills']} spills, "
          f"{st['scheduler']['evictions']} evictions across "
          f"{st['shards']} per-shard schedulers")
    print(f"bit-exactness vs scalar QRuntime: {agree * 100:.1f}% "
          f"({'OK' if agree == 1.0 else 'MISMATCH'})")
    _write_metrics(obs)


if args.shards > 1:
    fleet_demo(args.shards)
    raise SystemExit(0)

full = C.get(args.arch)
if not full.has_decode:
    raise SystemExit(f"{args.arch} is encoder-only: no decode path")
cfg = C.reduced(full, compute_dtype="float32", param_dtype="float32")
params = registry.init(cfg, torch.Generator(device=dev).manual_seed(0))
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (args.batch, 12))

obs = _make_obs()
fp = Engine(cfg, params, ServeConfig(max_len=64), obs=obs, device=dev)
q8 = Engine(cfg, params, ServeConfig(max_len=64, quant_bits=8), device=dev)
out_fp = fp.generate(prompts, max_new=args.new_tokens)
out_q8 = q8.generate(prompts, max_new=args.new_tokens)
agree = float((out_fp == out_q8).mean())
print(f"generated {out_fp.shape[1]} tokens x {args.batch} sequences on {dev}")
sched = fp.stats()["scheduler"]
print(f"scheduler: {sched['admissions']} admissions, "
      f"{sched['recycles']} recycles, {sched['spills']} spills "
      f"(continuous batching via serve/scheduler.py)")
print(f"bf16-vs-int8 token agreement: {agree*100:.1f}% "
      f"(greedy, random-init model — trained models track much closer)")

# the engine quantized through repro_torch.compress.quantize_tree (the one
# home of the PTQ math); audit the quantized tree it actually serves
srep = tree_size_report(q8.qparams, bits=8)
print(f"quantized tree: {srep['quantized_params']} int8 params, "
      f"{srep['weight_bytes_quantized']/1e6:.2f} MB vs "
      f"{srep['weight_bytes_bf16']/1e6:.2f} MB bf16 "
      f"({srep['compression_ratio']:.2f}x)")

n = registry.param_count(full)
print(f"full {args.arch}: {n/1e9:.2f}B params -> weight bytes/decode-step "
      f"{n*2/1e9:.2f} GB (bf16) vs {n/1e9:.2f} GB (int8): the decode "
      f"memory-roofline term halves")
_write_metrics(obs)
