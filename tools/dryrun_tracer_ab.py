"""Time the dry-run's trace of one cell three ways, on the CPU, as rank 0
of the fake production mesh (``repro_torch.launch.dryrun``):

  stock     ``CollectiveCounter`` with ``FlopCounterMode`` and
            ``MemTracker`` stacked over it;
  tracer    ``StepTracer``: the same counts in one dispatch mode;
  no-memo   ``StepTracer`` with its metadata memo switched off.

Each variant builds the cell anew and runs its step once; the FLOPs and
peak bytes of each are printed beside its seconds, so a variant that
disagrees shows.  Usage:

  PYTHONPATH=src python tools/dryrun_tracer_ab.py --cell qwen2-1.5b:train_4k \
      --cell qwen2-1.5b:prefill_32k
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.pytree import tree_leaves


def _stock(step, args, mesh):
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    colls = D.CollectiveCounter(mesh)
    flops, mem = FlopCounterMode(display=False), MemTracker()
    mem.track_external(*[t for a in args for t in tree_leaves(a)])
    t0 = time.perf_counter()
    with torch.device("meta"), mem, flops, colls:
        out = step(*args)
    dt = time.perf_counter() - t0
    del out
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    return dt, flops.get_total_flops(), peak, colls.total_bytes


def _tracer(step, args, mesh, memo: bool):
    key = D.StepTracer._key
    if not memo:
        D.StepTracer._key = lambda self, func, args, kwargs: None
    try:
        tr, dt = D.trace_step(step, args, mesh)
    finally:
        D.StepTracer._key = key
    return dt, tr.flops, tr.peak_bytes, tr.total_bytes


VARIANTS = {
    "stock": _stock,
    "tracer": lambda s, a, m: _tracer(s, a, m, True),
    "no-memo": lambda s, a, m: _tracer(s, a, m, False),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", required=True,
                    help="arch:shape, traced on the 16 x 16 mesh")
    ap.add_argument("--variant", action="append", choices=list(VARIANTS),
                    help="default: all three, in the order above")
    args = ap.parse_args(argv)
    D.fake_group(256)
    mesh = make_production_mesh(multi_pod=False)
    for cell in args.cell:
        arch, shape = cell.split(":")
        for name in args.variant or list(VARIANTS):
            step, sargs, _ = D.build_cell(arch, shape, mesh)
            dt, flops, peak, coll = VARIANTS[name](step, sargs, mesh)
            print(json.dumps({"cell": cell, "variant": name,
                              "trace_s": round(dt, 3), "flops": flops,
                              "peak_bytes": peak, "collective_bytes": coll}),
                  flush=True)


if __name__ == "__main__":
    main()
