"""The port's examples (``examples/torch_*.py``), each the counterpart of a
reference example: run on the CPU in a subprocess at small flags, each
prints the reference's contract lines, and none imports ``jax`` or
``repro``."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
REFERENCE = sorted(f for f in os.listdir(EXAMPLES)
                   if f.endswith(".py") and not f.startswith("torch_"))


def run_example(name, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, name),
                          "--device", "cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_every_reference_example_has_a_torch_counterpart():
    assert len(REFERENCE) == 6
    for name in REFERENCE:
        assert os.path.exists(os.path.join(EXAMPLES, f"torch_{name}")), name


@pytest.mark.parametrize("name", [f"torch_{n}" for n in REFERENCE])
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse(open(os.path.join(EXAMPLES, name)).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro", "ml_dtypes"}, tops


def test_example_refuses_a_missing_card():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(
        EXAMPLES, "torch_serve_demo.py"), "--shards", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "is_available() is False" in out.stderr


def test_quickstart():
    out = run_example("torch_quickstart.py", "--epochs", "2")
    assert re.search(r"^FP32  macro-F1: \d\.\d{3}$", out, re.M)
    assert re.search(r"^Q15   macro-F1: \d\.\d{3}$", out, re.M)
    assert re.search(r"^FP32-vs-Q15 prediction agreement: \d+\.\d\d%$", out,
                     re.M)
    assert "deployed weights: 566 bytes" in out


def test_streaming_har_demo():
    out = run_example("torch_streaming_har_demo.py", "--streams", "6",
                      "--slots", "2", "--epochs", "2")
    assert "streaming-vs-offline scalar agreement: 6/6 (bit-exact contract)" \
        in out


@pytest.mark.parametrize("args", [("--shards", "4"), ()],
                         ids=["fleet", "lm"])
def test_serve_demo(args, tmp_path):
    metrics = tmp_path / "metrics.json"
    out = run_example("torch_serve_demo.py", *args, "--metrics-out",
                      str(metrics))
    if args:
        assert "bit-exactness vs scalar QRuntime: 100.0% (OK)" in out
        assert "1 live migration(s)" in out
    else:
        assert "generated 24 tokens x 4 sequences on cpu" in out
        assert re.search(r"^bf16-vs-int8 token agreement: \d+\.\d%", out, re.M)
        assert re.search(r"^quantized tree: \d+ int8 params, .* \(2\.00x\)$",
                         out, re.M)
        assert "full deepseek-7b: 6.91B params" in out
    assert json.loads(metrics.read_text())["benchmark"] == "metrics_snapshot"
    assert f"wrote {metrics}" in out


def test_export_mcu(tmp_path):
    out = run_example("torch_export_mcu.py", "--windows", "48", "--outdir",
                      str(tmp_path))
    bitwise = re.findall(r"^  bitwise (\S+): (\S+)$", out, re.M)
    argmax = re.findall(r"^  argmax (\S+): (\S+)$", out, re.M)
    assert {"c_float_engine_logits", "c_float_engine_traj",
            "c_int_qvm_logits", "c_int_qvm_traces"} <= {k for k, _ in bitwise}
    assert all(v == "OK" for _, v in bitwise)
    assert len(argmax) >= 6 and all(v == "1.0000" for _, v in argmax)
    assert "parity over 48 windows:" in out
    for f in ("model.fgar", "model.fgrn", "parity.json", "host/int"):
        assert os.path.exists(tmp_path / f)


def test_har_end_to_end():
    out = run_example("torch_har_end_to_end.py", "--fast", "--epochs", "2")
    assert "deployed parameters: 283 (566 bytes at Q15)" in out
    assert re.search(r"^FP32 macro-F1 : \d\.\d{4}$", out, re.M)
    assert re.search(r"^Q15  macro-F1 : \d\.\d{4}$", out, re.M)
    assert re.search(r"^agreement     : \d+\.\d\d% on 800 windows$", out,
                     re.M)
    assert re.search(r"^warm-up: median \d+ samples", out, re.M)
    assert "energy: 246 uJ/inference, 31.5 mJ/window" in out


def test_lm_train_demo(tmp_path):
    args = ("--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path))
    out = run_example("torch_lm_train_demo.py", *args)
    assert "arch=qwen2-1.5b family=dense reduced to 4L x d128" in out
    assert re.search(r"^step 0 loss \d+\.\d{3} -> step 2 loss \d+\.\d{3}$",
                     out, re.M)
    assert f"checkpoints in {tmp_path} (restart this script to resume)" in out
    assert os.listdir(tmp_path)
