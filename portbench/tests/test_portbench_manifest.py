"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it found as a file."""
import json
import math
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def man():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    return json.loads(raw)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in man["paths"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # the full check of 24 cells fits the driver's 43,200 s
    cells = 24
    assert ((2 + 14 * cells) * (man["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200


def test_names_units_and_files_of_paths(man):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for e in man[k]]
    assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for k in ("configs", "workloads"):
        ns = [e["name"] for e in man[k]]
        assert len(set(ns)) == len(ns)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for p in man["paths"]:
        for f in (REPO / p).rglob("*"):
            if "__pycache__" not in f.parts:
                assert PATH.match(str(f.relative_to(REPO))), f


def test_configs(man):
    files = [c["file"] for c in man["configs"]]
    assert 1 <= len(man["configs"]) <= 24 and len(set(files)) == len(files)
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in (
            "d_model", "d_ff", "ssm_state", "mamba_headdim", "head_dim",
            "top_k") for k in c["reduced"])
        assert c["name"] in used


def test_workloads(man):
    assert 1 <= len(man["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, math.floor(0.25 * len(man["workloads"])))


def test_metrics_and_moves(man):
    from portbench.harness import manifest as mf
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    layers = {}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        for c in m.get("workloads", sorted(cells)):
            assert c in cells
            reports = [x["name"] for x in mf.metrics_of(man, "end_to_end", c)]
            assert m["moves"] in reports, (m["name"], c)
    for c in cells:
        e = [x["name"] for x in mf.metrics_of(man, "end_to_end", c)]
        assert "setup_s" in e and len(e) >= 2
        assert mf.metrics_of(man, "per_layer", c)


def test_each_name_is_found_as_a_file(man):
    from portbench.harness import manifest as mf
    for w in man["workloads"]:
        mix = mf.traffic_file(REPO, w["traffic"])
        assert mf.driver(mix["driver"]).run
        assert mf.model_config(mf.config_file(REPO, man, w["config"]))
    for m in man["per_layer"]:
        assert callable(mf.metric_reader(REPO, m["name"]))
