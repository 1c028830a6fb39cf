"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
``jax`` and nothing of the reference package ``repro`` (the training path,
``train/``, ``launch/`` and ``data/tokens.py``, runs with them blocked);
an entry point asked for the card raises without one; the kernel build
fails loudly; every kernel wrapper refuses an input that requires grad
under grad mode (no kernel has a backward)."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def port_modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_and_steps_with_jax_and_repro_blocked():
    code = f"""
import importlib, importlib.abc, sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Refuse())
for m in {port_modules()!r}:
    importlib.import_module(m)
import numpy as np
from repro_torch import weights
from repro_torch.core.quantization import QuantConfig, quantize_params
from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
qp = quantize_params(weights.random_params(0), QuantConfig())
k = Q15StreamStep(qp, device="cpu")
h = k.step(np.zeros((4, 16), np.float32), np.ones((4, 3), np.float32),
           np.ones(4, bool))
assert h.shape == (4, 16)
from repro_torch.serve.fleet import FleetConfig, FleetEngine, wire
from repro_torch.serve.streaming import StreamingConfig
fleet = FleetEngine(qp, FleetConfig(
    shards=2, snapshot_every=2,
    stream=StreamingConfig(max_slots=2, device="cpu", mxu=True)))
assert type(fleet.shards[0].kernel.kernel).__name__ == "DenseStep"
fleet.attach("s", np.ones((6, 3), np.float32), total_steps=6)
fleet.step(); fleet.step()
blob = wire.encode_stream_state(fleet.shards[fleet.shard_of("s")]
                                .snapshot_stream("s"))
assert wire.decode_stream_state(blob).steps == 2
fleet.crash_shard(fleet.shard_of("s"))
assert len(fleet.drain()) == 1
import torch
from repro_torch.core import fastgrnn, warmup
from repro_torch.kernels.fastgrnn_cell.ops import fastgrnn_window_kernel
from repro_torch.kernels.lut_act.ops import lut_sigmoid, lut_tanh
deq = qp.dequantize()
xs = np.ones((8, 2, 3), np.float32)
h, traj = fastgrnn_window_kernel(deq, xs, device="cpu")
assert traj.shape == (8, 2, 16)
lg = fastgrnn.forward_window(deq, torch.from_numpy(xs), sigma=lut_sigmoid,
                             tanh=lut_tanh)
preds = (traj @ deq["head_w"] + deq["head_b"]).argmax(-1).T.numpy()
assert lg.shape == (2, 6) and warmup.characterize(preds).n_windows == 2
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig
cfg = configs.reduced(configs.get("qwen2-1.5b"), compute_dtype="float32")
params = T.init(cfg, torch.Generator().manual_seed(0))
eng = Engine(cfg, params, ServeConfig(max_len=16, max_slots=2,
                                      quant_bits=16), device="cpu")
out = eng.generate(np.ones((3, 4), np.int32), max_new=3)
assert out.shape == (3, 3) and eng.stats()["prefills"] == 3
from repro_torch.kernels.ssd_scan.ops import ssd_scan
for arch in ("mamba2-780m", "zamba2-1.2b"):
    cfg = configs.reduced(configs.get(arch), compute_dtype="float32")
    eng = Engine(cfg, T.init(cfg, torch.Generator().manual_seed(0)),
                 ServeConfig(max_len=16, max_slots=2), device="cpu")
    out = eng.generate(np.ones((3, 5), np.int32), max_new=3)
    assert out.shape == (3, 3) and eng.stats()["prefills"] == 3
cfg = configs.reduced(configs.get("olmoe-1b-7b"), compute_dtype="float32")
eng = Engine(cfg, T.init(cfg, torch.Generator().manual_seed(0)),
             ServeConfig(max_len=16, max_slots=2, quant_bits=16),
             device="cpu")
out = eng.generate(np.ones((3, 6), np.int32), max_new=3)
assert out.shape == (3, 3) and eng.stats()["prefills"] == 3
cfg = configs.reduced(configs.get("internvl2-76b"), compute_dtype="float32")
eng = Engine(cfg, T.init(cfg, torch.Generator().manual_seed(0)),
             ServeConfig(max_len=24, max_slots=2, quant_bits=16),
             device="cpu")
out = eng.generate(np.ones((3, 4), np.int32), max_new=3, extra=dict(
    patch_embeds=np.zeros((3, cfg.num_patches, cfg.d_model), np.float32)))
assert out.shape == (3, 3) and eng.stats()["prefills"] == 3
from repro_torch.models import baselines, registry
cfg = configs.reduced(configs.get("hubert-xlarge"), compute_dtype="float32")
lg = registry.make_prefill_step(cfg)(
    T.init(cfg, torch.Generator().manual_seed(0)),
    dict(frames=torch.ones(1, 5, cfg.d_model)))
assert lg.shape == (1, 5, cfg.vocab_size)
assert registry.param_count(configs.get("nemotron-4-340b")) > 3e11
g = torch.Generator().manual_seed(0)
traj = baselines.rnn_run(baselines.gru_step, baselines.gru_init(g),
                         torch.ones(4, 2, 3), torch.zeros(2, 16))
assert traj.shape == (4, 2, 16) and baselines.mlp_param_count() == 12518
from repro_torch.analysis import lint_tree, run_selftest
assert lint_tree()["findings"] == [] and run_selftest()["ok"]
y, st = ssd_scan(torch.ones(1, 5, 2, 4), torch.ones(1, 5, 2), -torch.ones(2),
                 torch.ones(1, 5, 1, 3), torch.ones(1, 5, 1, 3), chunk=2)
assert y.shape == (1, 5, 2, 4) and st.shape == (1, 2, 3, 4)
import contextlib, io, tempfile
from repro_torch.launch import serve as launch_serve, train as launch_train
from repro_torch.train import optimizer
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stdout(io.StringIO()):
    hist = launch_train.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--device", "cpu", "--steps", "2", "--seq",
                              "16", "--global-batch", "2", "--ckpt-dir", d])
    out = launch_serve.main(["--arch", "qwen2-1.5b", "--reduced",
                             "--device", "cpu", "--batch", "1",
                             "--new-tokens", "2", "--ckpt-dir", d])
assert len(hist) == 2 and out.shape == (1, 2)
cfg = configs.reduced(configs.get("mamba2-780m"))
params = T.init(cfg, torch.Generator().manual_seed(0))
_, _, met = registry.make_train_step(cfg, optimizer.AdamConfig())(
    params, optimizer.init(params, optimizer.AdamConfig()),
    dict(tokens=torch.ones(1, 8, dtype=torch.int32),
         labels=torch.ones(1, 8, dtype=torch.int32)))
assert torch.isfinite(met["loss"])
assert not any(n in ("jax", "repro", "ml_dtypes")
               or n.startswith(("jax.", "repro.", "ml_dtypes."))
               for n in sys.modules if sys.modules[n])
print("ok", {len(port_modules())})
"""
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "repro", "ml_dtypes")]
    assert not bad, f"{path}: imports {bad}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step
    from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
    from repro_torch.kernels.fastgrnn_cell.qstep import StepWeights
    from repro_torch.serve.fleet import FleetEngine
    from repro_torch.serve.streaming import StreamingEngine
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan
    from repro_torch.kernels.fastgrnn_cell.ops import fastgrnn_window_kernel
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    lm_cfg = configs.reduced(configs.get("qwen2-1.5b"))
    lm_params = T.init(lm_cfg, torch.Generator().manual_seed(0))
    ssm_cfg = configs.reduced(configs.get("mamba2-780m"))
    ssm_params = T.init(ssm_cfg, torch.Generator().manual_seed(0))
    vlm_cfg = configs.reduced(configs.get("internvl2-76b"))
    vlm_params = T.init(vlm_cfg, torch.Generator().manual_seed(0))
    params = weights.random_params(0)
    qp = quantize_params(params, QuantConfig())
    sw = StepWeights.from_quantized(qp)
    xs = np.zeros((4, 2, 3), np.float32)
    for make in (lambda: Q15StreamStep(qp), lambda: StreamingEngine(qp),
                 lambda: make_fastgrnn_step(sw),
                 lambda: make_fastgrnn_step(sw, mxu=True),
                 lambda: Q15StreamStep(qp, mxu=True),
                 lambda: FleetEngine(qp), lambda: WindowScan(params),
                 lambda: fastgrnn_window_kernel(params, xs),
                 lambda: Engine(lm_cfg, lm_params),
                 lambda: Engine(lm_cfg, lm_params, device="cuda:0"),
                 lambda: T.init_cache(lm_cfg, 1, 4),
                 lambda: Engine(ssm_cfg, ssm_params),
                 lambda: Engine(vlm_cfg, vlm_params),
                 lambda: T.init_cache(ssm_cfg, 1, 4),
                 lambda: T.init_slot_cache(ssm_cfg, 1, 4),
                 lambda: T.init_slot_cache(lm_cfg, 1, 4),
                 lambda: weights.lm_params_from_numpy(
                     {"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_host_state_step_refuses_the_card():
    """On cuda the state table stays on the card: the host-table step and
    its row adapter raise instead of staging h across the boundary."""
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
    k = Q15StreamStep(quantize_params(weights.random_params(0), QuantConfig()),
                      device="cpu")
    k.device = torch.device("cuda", 0)
    h, x, m = (np.zeros((4, 16), np.float32), np.ones((4, 3), np.float32),
               np.ones(4, bool))
    for call in (lambda: k.step(h, x, m), lambda: k.step_rows(h, x, m)):
        with pytest.raises(RuntimeError, match="step_resident"):
            call()
    assert k.transfers.snapshot()["h2d_bytes"] == 0


def test_resolve_device_rejects_other_backends():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")  # always fails
    with pytest.raises(_build.KernelBuildError, match="q15_step"):
        _build.build("q15_step")
    assert not list(tmp_path.iterdir())       # no partial library left behind
    lib = _build.library_path("q15_step")
    assert lib.parent == tmp_path and lib.name.startswith("libq15_step-")


def test_find_nvcc_raises_when_absent(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(_build.KernelBuildError):
        _build.find_nvcc()


CUDA_SOURCES = ("q15_step.cu", "q15_step_dense.cu", "fastgrnn_window.cu",
                "lut_act.cu", "q15_matmul.cu", "ssd_scan.cu")


def test_cuda_source_holds_the_numerics_contract():
    """The flags that make each kernel bitwise equal to its plain version
    (the kernels themselves run on the card): no FMA contraction, no fast
    math; and the sources that the per-source checks below cover."""
    from repro_torch.kernels import _build
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "-prec-div=true" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == set(CUDA_SOURCES)


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_cuda_source_keeps_its_needles_and_bans(name):
    """Each source, with the headers it includes, holds the intrinsics of
    its numerics contract (explicit round-to-nearest ops) and none of the
    banned ones.  K5 (``q15_matmul.cu``) and K6 (``ssd_scan.cu``) alone
    may use the tensor cores: their products of two bfloat16 values are
    exact in float32, and their gates are tolerances on the order of the
    float32 sums (K5 1e-5 x max|plain|; K6 1e-4 in float32, 1e-5 x max +
    one ulp in bfloat16), which ``mma.sync`` with float32 accumulation
    keeps.  K6 alone may use FMA: its sums were already in another order
    than its plain version's, and an FMA rounds once where a multiply and
    an add round twice."""
    csrc = PORT / "csrc"
    src = (csrc / name).read_text()
    src += "".join(p.read_text() for p in csrc.glob("*.cuh")
                   if f'#include "{p.name}"' in src)
    needles = ["__float2int_rz", "__fmul_rn", "__fadd_rn", "__fsub_rn",
               'extern "C"', "cudaGetLastError"]
    banned = ["roundf(", "__fmaf", "fmaf(", "fast_math", "__expf", "wmma",
              "mma."]
    if name == "q15_matmul.cu":     # bf16 products on the tensor cores
        needles = ["mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "cvt.rn.bf16x2.f32", "__float2bfloat16_rn", "__fmul_rn",
                   "__fadd_rn", 'extern "C"', "cudaGetLastError"]
        banned.remove("mma.")
    if name == "ssd_scan.cu":       # float32 sums, held to a tolerance
        needles = ["mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "__fmaf_rn", 'extern "C"', "cudaGetLastError"]
        for ban in ("__fmaf", "fmaf(", "mma."):
            banned.remove(ban)
    if name == "q15_step.cu":       # Q15 activation storage
        needles += ["__fdiv_rn", "rintf"]
    if name == "lut_act.cu":        # lerp's (x - lo) / bw, bf16 output
        needles += ["__fdiv_rn", "__float2bfloat16_rn"]
    for needle in needles:
        assert needle in src, (name, needle)
    for ban in banned:
        assert ban not in src, (name, ban)


def test_hapt_loader_reads_nothing_outside_given_root(monkeypatch):
    from repro_torch.data import hapt
    monkeypatch.delenv("HAPT_ROOT", raising=False)
    a = hapt.load("test", n=3)
    np.testing.assert_array_equal(a.windows,
                                  hapt.generate_synthetic("test", n=3).windows)


def test_library_key_follows_the_shared_headers(tmp_path, monkeypatch):
    """A header edit must not load a library built from the old header."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.kernel_names() == ["k"]
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before


def _guard_cases():
    """(wrapper call, its inputs) for each of the six kernel wrappers, on
    the CPU (the guard runs before any device dispatch)."""
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell.kernel import (DenseStep,
                                                          FastGRNNStep,
                                                          WindowScan)
    from repro_torch.kernels.fastgrnn_cell.qstep import StepWeights
    from repro_torch.kernels.lut_act.kernel import LUTAct
    from repro_torch.kernels.q15_matmul.kernel import Q15Matmul
    from repro_torch.kernels.ssd_scan.kernel import SSDScan
    params = weights.random_params(0)
    sw = StepWeights.from_quantized(quantize_params(params, QuantConfig()))
    h, x, mask = torch.zeros(4, 16), torch.ones(4, 3), torch.ones(
        4, dtype=torch.bool)
    wq = torch.ones(5, 6, dtype=torch.int16)
    return {
        "q15_step": (FastGRNNStep(sw, "cpu"), (h, x, mask), {}),
        "q15_step_dense": (DenseStep(sw, "cpu"), (h, x, mask), {}),
        "fastgrnn_window": (WindowScan(params, "cpu"),
                            (torch.ones(6, 2, 3),), {}),
        "lut_act": (LUTAct(), (torch.linspace(-9, 9, 50), "sigmoid"), {}),
        "q15_matmul": (Q15Matmul(), (torch.ones(2, 5), wq,
                                     torch.tensor(0.5)), {}),
        "ssd_scan": (SSDScan(), (torch.ones(2, 5, 4), torch.ones(2, 5, 1),
                                 -torch.ones(2, 1), torch.ones(2, 5, 3),
                                 torch.ones(2, 5, 3)), {"chunk": 2}),
    }


@pytest.mark.parametrize("name", ["q15_step", "q15_step_dense",
                                  "fastgrnn_window", "lut_act", "q15_matmul",
                                  "ssd_scan"])
def test_kernel_wrappers_refuse_a_gradient(name):
    """No kernel has a backward, and a launch's output has no grad_fn: a
    requires-grad floating input under grad mode raises before anything
    runs, on any device; under ``no_grad`` or detached it runs."""
    call, args, kw = _guard_cases()[name]
    floats = [i for i, a in enumerate(args)
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
    assert floats
    for i in floats:
        live = list(args)
        live[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                           "grad"):
            call(*live, **kw)
        with torch.no_grad():
            call(*live, **kw)
        live[i] = live[i].detach()
        call(*live, **kw)
