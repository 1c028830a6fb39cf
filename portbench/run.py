"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (a ``workloads`` entry of
``BENCHMARK.json``) names a configuration and a traffic mix; the mix names
its driver.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, each read by ``portbench/metrics/<name>.py``
from the traced run's records.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``checks``: each number
the correctness check compared, beside its limit); the last lines of
standard error repeat the checks.  The run exits non-zero, printing no
result, without a card (or with fewer than the cell asks for), and if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.

``--control fp8`` puts the reference, computed with every weight product's
operands in float8, in the program's place for the check (the
lower-precision control of ``portbench/tests``); the benchmark's own runs
never pass it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's configuration, mix and run."""
    cell: dict
    cfg: object
    cfg_file: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    params: dict
    control: str | None = None
    break_path: object = lambda path: None
    marks: dict = dataclasses.field(default_factory=dict)


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, *, t_start: float, control=None,
             break_path=None) -> dict:
    """Run one cell once on ``device`` and return its result object (the
    line's keys, ``checks`` last)."""
    import torch

    from portbench.harness import manifest as mf
    from portbench.harness import weights
    man = mf.load(root)
    cell = mf.cell(man, workload)
    cfg_file = mf.config_file(root, man, cell["config"])
    mix = mf.traffic_file(root, cell["traffic"])
    cfg = mf.model_config(cfg_file)
    drv = mf.driver(mix["driver"])
    marks = {"imports": time.perf_counter() - t_start}
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
        torch.zeros((), device=device)
    marks["device"] = time.perf_counter() - t_start
    params = weights.init_params(cfg_file["layout"], seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["weights"] = time.perf_counter() - t_start
    ctx = Context(cell=cell, cfg=cfg, cfg_file=cfg_file, mix=mix, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  t_start=t_start, params=params, control=control,
                  marks=marks)
    if break_path is not None:
        ctx.break_path = break_path
    out = drv.run(ctx)

    metrics = {}
    if trace:
        for m in mf.metrics_of(man, "per_layer", workload):
            v = mf.metric_reader(root, m["name"])(out["rec"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in mf.metrics_of(man, "end_to_end", workload):
            v = out["end_to_end"].get(m["name"])
            if v is None:
                raise RuntimeError(f"{workload}: the driver gave no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(out["correct"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        from portbench.harness.devtrace import power_limit
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["trace_window_s"]
        dev["power_limit"] = (power_limit() if device.type == "cuda"
                              else "cpu")
        result["breakdown"] = out["breakdown"]
    result["notes"] = dict(out.get("notes", {}), setup_marks_s=ctx.marks)
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"portbench: no port at {src / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(src)]
    import torch
    from portbench.harness import manifest as mf
    chips = mf.cell(mf.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=T_START,
                      control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The checks on standard error, then the result line on standard
    output, each last."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
