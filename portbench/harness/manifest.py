"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration's file is the one its ``configs`` entry names; the mix is
``portbench/traffic/<traffic>.json``, whose ``driver`` key names a module
``portbench/drivers/<driver>.py``; each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Nothing here knows a cell, a mix or a
metric by name, so a later cell, mix or metric is new files plus new
entries.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _one(entries, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in "
                       "BENCHMARK.json")
    return found[0]


def cell(manifest: dict, name: str) -> dict:
    return _one(manifest["workloads"], name, "workload")


def config_entry(manifest: dict, name: str) -> dict:
    return _one(manifest["configs"], name, "config")


def config_file(root: Path, manifest: dict, name: str) -> dict:
    return json.loads((Path(root) / config_entry(manifest, name)["file"])
                      .read_text())


def traffic_path(root: Path, traffic: str) -> Path:
    return Path(root) / "portbench" / "traffic" / f"{traffic}.json"


def traffic_file(root: Path, traffic: str) -> dict:
    return json.loads(traffic_path(root, traffic).read_text())


def driver(name: str):
    """The driver module ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_path(root: Path, name: str) -> Path:
    return Path(root) / "portbench" / "metrics" / f"{name}.py"


def metric_reader(root: Path, name: str):
    """``read(rec) -> float | None`` of ``portbench/metrics/<name>.py``
    (loaded from its path: a metric's name may hold dots)."""
    path = metric_path(root, name)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, kind: str, cell_name: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, and those with no such list."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def model_config(cfg_file: dict):
    """The ``repro_torch.configs.<module>`` config with the file's
    ``model`` keys set, checked to hold every one of them: the file states
    the configuration as it is run."""
    mod = importlib.import_module(f"repro_torch.configs.{cfg_file['module']}")
    cfg = dataclasses.replace(mod.CONFIG, **cfg_file["model"])
    for k, v in cfg_file["model"].items():
        if getattr(cfg, k) != v:
            raise ValueError(f"config {cfg_file['module']}: {k} is "
                             f"{getattr(cfg, k)!r}, the file says {v!r}")
    return cfg
