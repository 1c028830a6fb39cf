"""A temporary copy of the benchmark with tiny cells added as new files
plus new entries, the way a later change adds a configuration, a mix or
a metric: nothing that was there is edited."""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "tiny-ssm": {
        "module": "mamba2_780m",
        "source": "test",
        "model": {"name": "tiny-ssm", "num_layers": 2, "d_model": 64,
                  "vocab_size": 256, "ssm_state": 16, "mamba_headdim": 16,
                  "ssd_chunk": 16},
        "reduced": ["num_layers", "d_model", "vocab_size", "ssm_state",
                    "mamba_headdim", "ssd_chunk"],
        "serve": {"quant_bits": 16},
        "train": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                  "weight_decay": 0.0, "grad_clip": 1.0,
                  "warmup_steps": 100},
        "limits": {"serve": {"logit_gap": 0.1},
                   "train": {"loss_gap": 0.01, "first_grad_gap": 0.1,
                             "change_gap": 0.2}},
    },
    "tiny-hybrid": {
        "module": "zamba2_1_2b",
        "source": "test",
        "model": {"name": "tiny-hybrid", "num_layers": 4, "d_model": 64,
                  "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
                  "d_ff": 128, "vocab_size": 256, "ssm_state": 16,
                  "mamba_headdim": 16, "attn_every": 2, "ssd_chunk": 16},
        "reduced": ["num_layers", "d_model", "num_heads", "num_kv_heads",
                    "head_dim", "d_ff", "vocab_size", "ssm_state",
                    "mamba_headdim", "ssd_chunk"],
        "serve": {"quant_bits": 16},
        "limits": {"serve": {"logit_gap": 0.1}},
    },
}

TINY_MIX = {
    "driver": "serve_closed_loop", "why": "test", "clients": 2,
    "max_slots": 2, "max_len": 80,
    "prompt": {"dist": "log_uniform", "min": 20, "max": 60},
    "output": {"dist": "uniform", "min": 3, "max": 6},
    "block": 4, "lead_in": 2, "sample": 1000, "trace_ticks": 3,
}

TINY_TRAIN = {
    "driver": "train_steps", "why": "test", "seq_len": 32, "batch": 2,
    "check_steps": 3, "trace_steps": 1,
}

DUMMY_METRIC = '''"""A dummy per-layer metric: the window's seconds."""


def read(rec):
    return rec.get("window_s")
'''


def make_root(tmp: Path) -> Path:
    """``tmp/bench``: ``BENCHMARK.json`` and ``portbench/`` copied, ``src``
    linked, and the tiny cells added as new files and entries."""
    root = Path(tmp) / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "src", root / "src")
    man = json.loads((root / "BENCHMARK.json").read_text())
    from portbench.harness.manifest import model_config
    from portbench.harness.weights import layout
    for name, body in TINY_CONFIGS.items():
        path = root / "portbench" / "configs" / f"{name}.json"
        body = dict(body, layout=layout(model_config(body)))
        path.write_text(json.dumps(body))
        man["configs"].append({"name": name, "source": "test",
                               "file": f"portbench/configs/{name}.json",
                               "reduced": body["reduced"], "why": "test"})
        man["workloads"].append({"name": f"{name}.tiny-serve",
                                 "config": name, "traffic": "tiny-serve",
                                 "chips": 1, "why": "test"})
    man["workloads"].append({"name": "tiny-ssm.tiny-train",
                             "config": "tiny-ssm", "traffic": "tiny-train",
                             "chips": 1, "why": "test"})
    (root / "portbench" / "traffic" / "tiny-serve.json").write_text(
        json.dumps(TINY_MIX))
    (root / "portbench" / "traffic" / "tiny-train.json").write_text(
        json.dumps(TINY_TRAIN))
    (root / "portbench" / "metrics" / "window_s.dummy.py").write_text(
        DUMMY_METRIC)
    cells = [f"{n}.tiny-serve" for n in TINY_CONFIGS]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" not in m:
            continue
        if m["name"].endswith(".serve") or m["name"] in (
                "tokens_per_s", "ttft_ms_p95", "k5_roofline", "k6_roofline"):
            m["workloads"] = m["workloads"] + cells
        elif "train" in m["name"]:
            m["workloads"] = m["workloads"] + ["tiny-ssm.tiny-train"]
    man["per_layer"].append({"name": "window_s.dummy", "unit": "s",
                             "better": "lower", "source": "host_clock",
                             "layer": "device", "moves": "tokens_per_s",
                             "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root
