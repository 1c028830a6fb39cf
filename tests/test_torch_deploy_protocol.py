"""Port parity, the paper's full Sec. VI-B protocol: the pinned protocol
model (``repro.deploy.verify.PROTOCOL``) trained once in the reference,
under ``threefry_partitionable(False)`` (ROADMAP C0), carried across, and
run through both packages' ``run_parity`` over the full 3,399-window
synthetic test split.  Mirrors ``tests/test_deploy.py``'s slow protocol
test.

On this toolchain the pinned model's integer path does not reach the
100 % its seed was pinned for, in either package: the qvm and the int C
miss the engine on the same 20 of 3,399 windows (99.41 %; ROADMAP C5).
So this test holds the port to the reference's verdicts on every key of
the report, and to the contracts that hold at every seed: every bitwise
entry (the float C == the engine oracle, logits and trajectories; the
int C == the qvm, traces, logits and counters) and the float C equal to
the engine on every window.
"""
import jax
import numpy as np
import pytest

from repro.compress import ModelArtifact as JArtifact
from repro.core.qruntime import QRuntime as JRuntime
from repro.core.qruntime import calibrate_deploy as j_calibrate_deploy
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.quantization import quantize_params as j_quantize_params
from repro.deploy import verify as JV
from repro.deploy.image import build_image as j_build_image
from repro_torch import weights
from repro_torch.compress import ModelArtifact
from repro_torch.core.qruntime import QRuntime, calibrate
from repro_torch.core.quantization import QuantConfig, quantize_params
from repro_torch.data import hapt
from repro_torch.deploy import emit_c, verify
from repro_torch.deploy.image import build_image


@pytest.mark.slow
def test_full_protocol_all_quantized_paths_agree():
    if emit_c.find_cc() is None:
        pytest.skip("no C compiler")
    with jax.threefry_partitionable(False):
        jparams, calib = JV.protocol_model()
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    qp = quantize_params(weights.params_from_numpy(np_params), QuantConfig())
    img = build_image(ModelArtifact(
        qp=qp, act_scales=dict(calibrate(QRuntime(qp), calib,
                                         deploy=True))))
    jqp = j_quantize_params(np_params, JQuantConfig())
    jimg = j_build_image(JArtifact(
        qp=jqp, act_scales=dict(j_calibrate_deploy(JRuntime(jqp), calib))))
    assert img.to_bytes() == jimg.to_bytes()
    test = hapt.load("test")
    assert len(test.windows) == 3399
    report = verify.run_parity(img, qp, test.windows, use_fp32=False,
                               device="cpu")
    assert report["bitwise"]["c_float_engine_logits"]
    assert report["bitwise"]["c_float_engine_traj"]
    assert report["bitwise"]["c_int_qvm_traces"]
    assert report["bitwise"]["c_int_qvm_logits"]
    assert all(report["bitwise"].values()), report["bitwise"]
    assert report["agreement"]["c_float_vs_engine"] == 1.0
    assert report["agreement"]["qruntime_subset_vs_engine"] == 1.0
    jreport = JV.run_parity(jimg, jqp, test.windows, use_fp32=False)
    for k in ("paths", "agreement", "pairwise", "bitwise", "size",
              "budgets", "numerics"):
        assert report[k] == jreport[k], k
    assert verify.quantized_paths_agree(report) == \
        JV.quantized_paths_agree(jreport), report["pairwise"]
