"""K1's launcher (``csrc/q15_step.cu``) as far as the CPU can see it: the
ctypes bindings match the C signatures in the source (the source compiles
only on the card), the plan and the fixed-width answer come from the card,
the CPU wrapper still runs the plain version, and ``chip_smoke.py``'s
``--parent`` and its K1 checks parse what the card's build and launcher
report."""
import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.core.quantization import QuantConfig, quantize_params
from repro_torch.kernels.fastgrnn_cell import kernel, qstep

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src" / "repro_torch" / "csrc" / "q15_step.cu"


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


def step_weights(**shape) -> qstep.StepWeights:
    qp = quantize_params(weights.random_params(0, **shape), QuantConfig())
    return qstep.StepWeights.from_quantized(qp)


@pytest.mark.parametrize("name, argtypes", [
    ("q15_step_launch", kernel._ARGTYPES),
    ("q15_step_plan", kernel._PLAN_ARGTYPES)])
def test_binding_matches_the_source(name, argtypes):
    params = c_params(name)
    assert len(params) == len(argtypes), params
    for param, argtype in zip(params, argtypes):
        pointer = argtype not in (ctypes.c_int, ctypes.c_float)
        assert ("*" in param) == pointer, (param, argtype)
        if argtype is ctypes.c_float:
            assert param.startswith("float "), param
    if name == "q15_step_plan":     # h and out, then the plan's ints
        assert [p.split()[-1] for p in params[6:]] == ["h", "out", "plan"]
        assert len(kernel.PLAN_KEYS) == 8
        assert "plan[0..7]" in SOURCE.read_text()


def test_plan_and_fixed_width_come_from_the_card():
    sw = step_weights()
    h = torch.zeros(512, 16)
    step = kernel.FastGRNNStep(sw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        step.plan(512, h, h)
    with pytest.raises(RuntimeError, match="CUDA"):
        step.fixed_width(h, h)
    if torch.cuda.is_available():
        step = kernel.FastGRNNStep(sw, device="cuda")
        h = h.cuda()
        plan = step.plan(131_072, h, torch.empty_like(h))
        assert plan["fixed"] == 1 and plan["local_bytes"] == 0
        off = torch.empty(512 * 16 + 1, device="cuda")[1:].view(512, 16)
        assert not step.fixed_width(off, h)


@pytest.mark.parametrize("shape", [{}, {"low_rank": False},
                                   {"hidden_dim": 12, "input_dim": 5},
                                   {"rank_w": 3, "rank_u": 5}])
def test_cpu_wrapper_runs_plain_and_counts_no_launch(shape):
    sw = step_weights(**shape)
    step = kernel.FastGRNNStep(sw, device="cpu")
    rng = np.random.default_rng(3)
    S, H, d = 300, sw.hidden_dim, sw.input_dim
    h = torch.from_numpy((0.5 * rng.standard_normal((S, H))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((S, d)).astype(np.float32))
    m = torch.from_numpy(rng.random(S) >= 1 / 3)
    out = step(h, x, m)
    want = torch.where(m[:, None], qstep.step_batched(
        sw.arrays("cpu"), sw, h, x), h)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(out[~m], h[~m]) and step.launches == 0


def test_parent_flag_parses_and_loads_nothing_without_a_tree():
    cs = chip_smoke()
    assert cs.parse_args([]).parent is None
    assert cs.parse_args(["--parent", "scratch_tree/p"]).parent == \
        "scratch_tree/p"
    for old in ("--k5-parent", "--k6-parent"):
        with pytest.raises(SystemExit):
            cs.parse_args([old, "scratch_tree/p"])
    assert cs.PARENT_KERNELS == ("q15_step", "q15_step_dense", "q15_matmul",
                                 "ssd_scan")
    assert cs.start_parent_builds(None) == {}
    assert cs.parent_k1(step_weights(), "cpu") is None
    assert cs.parent_k5() is None and cs.parent_k6() is None


def test_fixed_frames_read_from_the_ptxas_log():
    """The build phase's gate reads each fixed-width instantiation's stack
    frame from the mangled entry names, and skips the runtime-width one."""
    cs = chip_smoke()
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0_11_"
        f"q15_step_cu_0{name}ENS_10StepParamsE' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n"
        f"    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes "
        f"spill loads"
        for name, frame in (
            ("21q15_step_kernel_fixedILi16ELi3ELi0ELi0EEEv", 0),
            ("21q15_step_kernel_fixedILi16ELi3ELi2ELi8EEEv", 8),
            ("19q15_step_kernel_any", 576)))
    assert cs.k1_fixed_frames(log) == {"16,3,0,0": 0, "16,3,2,8": 8}


def test_fixed_count_asks_the_plan_of_each_launch():
    """``chip_smoke.FixedCount`` counts the launches whose plan is the
    fixed-width code and passes every argument on unchanged."""
    cs = chip_smoke()

    class Lib:
        launched = []

        def q15_step_plan(self, S, H, D, lr, rw, ru, h, out, plan):
            plan[0] = int(h % 16 == 0 and out % 16 == 0)
            return 0

        def q15_step_launch(self, *args):
            self.launched.append(args)
            return 0

        def q15_step_error_string(self, err):
            return b"no error"

    lib = Lib()
    counted = cs.FixedCount(lib)
    args = [64, 0, 0, 128, 10, 16, 3, 1, 2, 8] + [0] * 19 + [0]
    assert counted.q15_step_launch(*args) == 0
    args[0] = 68                    # h 4 bytes off a 16-byte boundary
    assert counted.q15_step_launch(*args) == 0
    assert counted.fixed == 1 and len(lib.launched) == 2
    assert lib.launched[1] == tuple(args)
    assert counted.q15_step_error_string(0) == b"no error"
