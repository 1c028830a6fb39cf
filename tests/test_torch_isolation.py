"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
``jax`` and nothing of the reference package ``repro``; an entry point asked
for the card raises without one; the kernel build fails loudly."""
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
k = Q15StreamStep(quantize_params(weights.random_params(0), QuantConfig()),
                  device="cpu")
h = k.step(np.zeros((4, 16), np.float32), np.ones((4, 3), np.float32),
           np.ones(4, bool))
assert h.shape == (4, 16)
assert not any(n == "jax" or n.startswith(("jax.", "repro."))
               or n == "repro" for n in sys.modules if sys.modules[n])
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
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    assert not bad, f"{path}: imports {bad}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step
    from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
    from repro_torch.kernels.fastgrnn_cell.qstep import StepWeights
    from repro_torch.serve.streaming import StreamingEngine
    qp = quantize_params(weights.random_params(0), QuantConfig())
    for make in (lambda: Q15StreamStep(qp), lambda: StreamingEngine(qp),
                 lambda: make_fastgrnn_step(StepWeights.from_quantized(qp))):
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


def test_cuda_source_holds_the_numerics_contract():
    """The flags and intrinsics that make the kernel bitwise equal to the
    plain version (checked here; the kernel itself runs on the card)."""
    from repro_torch.kernels import _build
    src = (PORT / "csrc" / "q15_step.cu").read_text()
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "-prec-div=true" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    for needle in ("__fdiv_rn", "rintf", "__float2int_rz", "__fmul_rn",
                   "__fadd_rn", 'extern "C"', "cudaGetLastError"):
        assert needle in src, needle
    assert "roundf(" not in src and "__fmaf" not in src


def test_hapt_loader_reads_nothing_outside_given_root(monkeypatch):
    from repro_torch.data import hapt
    monkeypatch.delenv("HAPT_ROOT", raising=False)
    a = hapt.load("test", n=3)
    np.testing.assert_array_equal(a.windows,
                                  hapt.generate_synthetic("test", n=3).windows)
