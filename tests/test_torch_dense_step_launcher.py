"""K2's launcher (``csrc/q15_step_dense.cu``) as far as the CPU can see it:
the ctypes bindings match the C signatures in the source (the source
compiles only on the card), the plan and the fixed-width answer come from
the card, the CPU wrapper still runs ``qstep.step_dense``, the two step
kernels share one pipeline header and keep their own entry names, and
``chip_smoke.py``'s ``--parent`` and its K2 checks parse what the card's
build and launcher report."""
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
CSRC = REPO / "src" / "repro_torch" / "csrc"
SOURCE = CSRC / "q15_step_dense.cu"


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
    ("q15_step_dense_launch", kernel._DENSE_ARGTYPES),
    ("q15_step_dense_plan", kernel._DENSE_PLAN_ARGTYPES)])
def test_binding_matches_the_source(name, argtypes):
    params = c_params(name)
    assert len(params) == len(argtypes), params
    for param, argtype in zip(params, argtypes):
        pointer = argtype not in (ctypes.c_int, ctypes.c_float)
        assert ("*" in param) == pointer, (param, argtype)
        if argtype is ctypes.c_float:
            assert param.startswith("float "), param
    if name == "q15_step_dense_plan":   # S H D, h and out, then the plan
        assert [p.split()[-1] for p in params] == ["S", "H", "D", "h", "out",
                                                   "plan"]
        assert "plan[0..7]" in SOURCE.read_text()
    # the plan query took the place of the old fixed-width query
    assert "q15_step_dense_fixed(" not in SOURCE.read_text()


def test_plan_and_fixed_width_come_from_the_card():
    sw = step_weights()
    h = torch.zeros(512, 16)
    step = kernel.DenseStep(sw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        step.plan(512, h, h)
    with pytest.raises(RuntimeError, match="CUDA"):
        step.fixed_width(h, h)
    if torch.cuda.is_available():
        step = kernel.DenseStep(sw, device="cuda")
        h = h.cuda()
        plan = step.plan(131_072, h, torch.empty_like(h))
        assert plan["fixed"] == 1 and plan["local_bytes"] == 0
        off = torch.empty(512 * 16 + 1, device="cuda")[1:].view(512, 16)
        assert not step.fixed_width(off, h)


@pytest.mark.parametrize("shape", [{}, {"low_rank": False},
                                   {"hidden_dim": 12, "input_dim": 5}])
def test_cpu_wrapper_runs_step_dense_and_counts_no_launch(shape):
    sw = step_weights(**shape)
    step = kernel.make_fastgrnn_step(sw, device="cpu", mxu=True)
    assert isinstance(step, kernel.DenseStep)
    rng = np.random.default_rng(4)
    S, H, d = 300, sw.hidden_dim, sw.input_dim
    h = torch.from_numpy((0.5 * rng.standard_normal((S, H))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((S, d)).astype(np.float32))
    m = torch.from_numpy(rng.random(S) >= 1 / 3)
    out = step(h, x, m)
    want = qstep.step_dense(qstep.dense_arrays(sw, "cpu"), h, x, m)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(out[~m].view(torch.int32), h[~m].view(torch.int32))
    assert step.launches == 0


def test_both_step_kernels_share_the_pipeline_and_keep_their_names():
    """K1 and K2 include one tiled pipeline header, and each keeps its own
    ``__global__`` entries: ``chip_smoke.py`` finds the fixed-width
    instantiations in the ptxas log and the kernels in profiler traces by
    these names."""
    header = (CSRC / "step_tiles.cuh").read_text()
    assert "__global__ void" not in header     # no kernel of its own
    for fn in ("lut_bucket", "tile_row_load", "tile_row_store", "bulk_load",
               "bulk_store", "mbar_wait", "tile_loop", "persistent_grid"):
        assert re.search(rf"\b{fn}\(", header), fn
    k1 = (CSRC / "q15_step.cu").read_text()
    k2 = SOURCE.read_text()
    for src, entries in ((k1, ("q15_step_kernel_fixed", "q15_step_kernel_any")),
                         (k2, ("q15_step_dense_kernel_fixed",
                               "q15_step_dense_kernel_any"))):
        assert '#include "step_tiles.cuh"' in src
        for entry in entries:
            assert re.search(rf"\n{entry}\(\w+Params p\)", src), entry
    # K2's fixed width does not depend on the rank: the dense layout always
    # multiplies by the effective H x d and H x H matrices
    assert "q15_step_dense_kernel_fixed<16, 3>" in k2
    assert "low_rank" not in k2


def test_parent_k2_is_none_without_a_tree():
    cs = chip_smoke()
    assert "q15_step_dense" in cs.PARENT_KERNELS
    assert cs.parent_k2(step_weights(), "cpu") is None


def ptxas_log(entries) -> str:
    """A ptxas -v log of (mangled entry name, stack frame bytes)."""
    return "\n".join(
        f"ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0_11_"
        f"q15_step_cu_0{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n"
        f"    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes "
        f"spill loads"
        for name, frame in entries)


@pytest.mark.parametrize("k2_frame", [0, 16])
def test_fixed_frames_read_k2_entry_from_the_ptxas_log(k2_frame):
    """The build phase reads K2's fixed-width instantiation by its mangled
    entry name, and neither K2's runtime-width kernel nor K1's entries."""
    cs = chip_smoke()
    log = ptxas_log((
        ("27q15_step_dense_kernel_fixedILi16ELi3EEEvNS_11DenseParamsE",
         k2_frame),
        ("25q15_step_dense_kernel_anyENS_11DenseParamsE", 576),
        ("21q15_step_kernel_fixedILi16ELi3ELi2ELi8EEEvNS_10StepParamsE", 8)))
    assert cs.fixed_frames(log, cs.K2_FIXED) == {"16,3": k2_frame}
    assert cs.k1_fixed_frames(log) == {"16,3,2,8": 8}


class DenseLib:
    """A stand-in for K2's library: the plan says fixed-width when h and
    out are 16-byte aligned."""

    def __init__(self):
        self.launched = []

    def q15_step_dense_plan(self, S, H, D, h, out, plan):
        plan[0] = int(H == 16 and D == 3 and h % 16 == 0 and out % 16 == 0)
        return 0

    def q15_step_dense_launch(self, *args):
        self.launched.append(args)
        return 0

    def q15_step_dense_error_string(self, err):
        return b"no error"


def test_fixed_count_asks_the_dense_plan_of_each_launch():
    """``chip_smoke.FixedCount`` counts K2's launches whose plan is the
    fixed-width code and passes every argument on unchanged."""
    cs = chip_smoke()
    lib = DenseLib()
    counted = cs.FixedCount(lib)
    args = [64, 0, 0, 128, 10, 16, 3] + [0] * 6 + [0.5, 0.25] + [0]
    assert counted.q15_step_dense_launch(*args) == 0
    args[3] = 132                   # out 4 bytes off a 16-byte boundary
    assert counted.q15_step_dense_launch(*args) == 0
    args[3], args[5], args[6] = 128, 12, 5      # the runtime-width code
    assert counted.q15_step_dense_launch(*args) == 0
    assert counted.fixed == 1 and len(lib.launched) == 3
    assert lib.launched[2] == tuple(args)
    assert counted.q15_step_dense_error_string(0) == b"no error"


def test_count_fixed_wraps_once_and_read_fixed_gives_the_libraries_back():
    """The fleet and failover checks: each wrapper's launches zeroed and
    its library seen through once (a crashed shard's replacement is
    watched later without resetting the others), then the counts read and
    the libraries given back."""
    cs = chip_smoke()

    class Step:
        def __init__(self):
            self._lib, self.launches = DenseLib(), 7

        def launch(self, h):
            self._lib.q15_step_dense_launch(h, 0, 0, 128, 8, 16, 3, *[0] * 9)
            self.launches += 1

    a, b = Step(), Step()
    libs = [a._lib, b._lib]
    cs.count_fixed([a])
    a.launch(64)
    cs.count_fixed([a, b])          # a keeps its count, b starts from 0
    a.launch(68)
    b.launch(64)
    assert cs.read_fixed([a, b]) == (3, 2)
    assert [a._lib, b._lib] == libs
