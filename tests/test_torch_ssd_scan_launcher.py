"""K6's launcher (``csrc/ssd_scan.cu``) as far as the CPU can see it: the
ctypes bindings match the C signatures in the source (the source compiles
only on the card), the plan of the three phases is the card's answer, and
the least-work bound that ``chip_smoke.py`` reports for float32 inputs
counts C B^T on the CUDA cores."""
import ctypes
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"


def c_params(name: str) -> list[str]:
    """The parameters of the ``extern "C"`` function ``name``."""
    m = re.search(rf"\bint {name}\(([^)]*)\)", SOURCE.read_text())
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, argtypes", [
    ("ssd_scan_launch", kernel._ARGTYPES),
    ("ssd_scan_plan", [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])])
def test_binding_matches_the_source(name, argtypes):
    params = c_params(name)
    assert len(params) == len(argtypes), params
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is not ctypes.c_int), (param,
                                                                 argtype)
    if name == "ssd_scan_launch":   # the scratch comes between state and dtype
        assert [p.split()[-1] for p in params[6:10]] == [
            "state", "cs", "hc", "dtype"]


def test_plan_is_the_cards_answer():
    scan = kernel.SSDScan()
    if torch.cuda.is_available():
        plan = scan.plan(torch.bfloat16, 48, 1000, 64, 128, chunk=256)
        assert [p["phase"] for p in plan] == list(kernel.PHASES)
        assert min(plan[0]["blocks"], plan[2]["blocks"]) >= 132
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            scan.plan(torch.bfloat16, 48, 1000, 64, 128, chunk=256)
    with pytest.raises(TypeError):
        scan.plan(torch.float16, 48, 1000, 64, 128, chunk=256)


def test_least_work_without_tensor_cores():
    """bfloat16: every product on the tensor cores, C B^T as it is and M x,
    C H and the state sums as three bfloat16 parts (4.809 us at
    mamba2-780m's prefill, above its 4.348 us of bytes: the bound of
    ``PERF.md``); float32: every multiply-add a float32 instruction, so
    the bound can only grow."""
    cs = chip_smoke()
    ms, q, fp32, flop = cs.ssd_least_work(48, 1, 1000, 64, 128)
    assert round(ms * 1e3, 3) == 4.809 and flop > 0
    tri = 1000 // q * q * (q + 1) // 2 + (1000 % q) * (1000 % q + 1) // 2
    assert flop == 2 * tri * 128 + 6 * 48 * (tri * 64 + 2 * 1000 * 128 * 64)
    ms32, q32, fp32_32, flop32 = cs.ssd_least_work(48, 1, 1000, 64, 128,
                                                   tensor_cores=False)
    assert flop32 == 0 and ms32 > ms and fp32_32 > fp32
