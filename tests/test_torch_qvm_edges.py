"""Port parity, qvm integer edge cases: ``repro_torch.deploy.qvm`` at the
exact boundaries qlint proves, mirroring ``tests/test_qvm_edges.py`` one
for one, each held to the reference's qvm on the same image bytes and
inputs.

* int16 saturation at both boundaries from both sides;
* the INT16_MIN negation hazard;
* requant round-shift extremes (``sh=1``, ``sh=62``, the underflow form
  ``m=0``, a floor preshift, the too-large-factor rejection);
* LUT index clamping to entries 0 and 255 at the fine-scale extremes;
* extreme windows through the emitted int C.
"""
import tempfile

import numpy as np
import pytest

from repro.deploy import goldens as JG
from repro.deploy.image import DeployImage as JImage
from repro.deploy.image import build_image as j_build_image
from repro.deploy.qvm import QVM as JQVM
from repro.deploy.qvm import Requant as JRequant
from repro.deploy.qvm import plan_from_image as j_plan_from_image
from repro.deploy.qvm import quantize_multiplier as j_quantize_multiplier
from repro_torch import weights
from repro_torch.core.lut import LUT_SIZE
from repro_torch.deploy import QVM, build_reference_model, emit_c
from repro_torch.deploy.goldens import build_reference_artifact
from repro_torch.deploy.image import build_image
from repro_torch.deploy.qvm import (FINE_CLIP, I16_MAX, I16_MIN, Requant,
                                    _LUT_IDX0, plan_from_image,
                                    quantize_multiplier, sat16)
from torchharness import reference_init


@pytest.fixture(scope="module")
def ref_params():
    return reference_init()


@pytest.fixture(scope="module")
def model(ref_params):
    return build_reference_model(params=weights.params_from_numpy(ref_params),
                                 device="cpu")


@pytest.fixture(scope="module")
def vm(model):
    return QVM(model[2])


@pytest.fixture(scope="module")
def jvm(model):
    """The reference's qvm on the port's image bytes."""
    return JQVM(JImage.from_bytes(model[2].to_bytes()))


# ---------------------------------------------------------------------------
# int16 saturation boundaries
# ---------------------------------------------------------------------------

def test_sat16_exact_at_both_boundaries():
    v = np.array([I16_MIN - 1, I16_MIN, I16_MIN + 1,
                  I16_MAX - 1, I16_MAX, I16_MAX + 1], np.int64)
    np.testing.assert_array_equal(
        sat16(v),
        [I16_MIN, I16_MIN, I16_MIN + 1, I16_MAX - 1, I16_MAX, I16_MAX])


def test_step_saturates_never_wraps(vm, jvm):
    """All four input/state extremes keep every stored state inside
    int16, and the step is the reference's bit for bit."""
    H, d = vm.plan.H, vm.plan.d
    for hval in (I16_MIN, I16_MAX):
        for xval in (I16_MIN, I16_MAX):
            hq = np.full((2, H), hval, np.int16)
            xq = np.full((2, d), xval, np.int16)
            out = vm.step(hq, xq)
            assert out.dtype == np.int16
            assert int(out.min()) >= I16_MIN and int(out.max()) <= I16_MAX
            np.testing.assert_array_equal(out, jvm.step(hq, xq))


# ---------------------------------------------------------------------------
# INT16_MIN negation hazard
# ---------------------------------------------------------------------------

def test_int16_min_survives_gate_path(vm, jvm):
    H, d = vm.plan.H, vm.plan.d
    hq = np.full((1, H), I16_MIN, np.int16)
    x0 = np.zeros((1, d), np.int16)
    out = vm.step(hq, x0)
    assert out.dtype == np.int16
    assert int(out.min()) >= I16_MIN and int(out.max()) <= I16_MAX
    np.testing.assert_array_equal(out, jvm.step(hq, x0))
    assert -np.int64(I16_MIN) == 32768


# ---------------------------------------------------------------------------
# requant shift extremes
# ---------------------------------------------------------------------------

def test_requant_shift_floor_sh1():
    rq, jrq = Requant(m=1 << 24, sh=1, pre=0), JRequant(m=1 << 24, sh=1, pre=0)
    for acc in (0, 1, -1, 3, -3, 12345):
        expect = (acc * (1 << 24) + 1) >> 1
        expect = max(min(expect, (1 << 31) - 1), -(1 << 31))
        assert int(rq.apply(np.int64(acc))) == expect
        assert int(jrq.apply(np.int64(acc))) == expect


def test_requant_shift_max_sh62():
    rq = Requant(m=1 << 24, sh=62, pre=0)
    assert int(rq.apply(np.int64(1 << 37))) == 1
    assert int(rq.apply(np.int64((1 << 37) - 1))) == 0
    assert int(rq.apply(np.int64(-(1 << 37)))) == 0   # round-half-up
    assert int(rq.apply(np.int64(-(1 << 37) - 1))) == -1


def test_requant_underflow_form_is_zero():
    rq = quantize_multiplier(1e-20)
    assert (rq.m, rq.sh) == (0, 62)
    acc = np.array([0, 1, -1, 1 << 36, -(1 << 36)], np.int64)
    np.testing.assert_array_equal(rq.apply(acc), 0)


def test_requant_preshift_accuracy():
    factor = 3.14159e-7
    rq = quantize_multiplier(factor, acc_bits=45)
    assert rq.pre == 8
    acc = 1 << 44
    got = int(rq.apply(np.int64(acc)))
    assert abs(got - factor * acc) <= factor * acc * 2 ** -23 + 1
    # the reference's multiplier for the same factor and bound, and the
    # same rescale of a sweep of accumulators
    jrq = j_quantize_multiplier(factor, acc_bits=45)
    assert (rq.m, rq.sh, rq.pre) == (jrq.m, jrq.sh, jrq.pre)
    accs = np.random.default_rng(0).integers(-(1 << 44), 1 << 44, 4096)
    np.testing.assert_array_equal(rq.apply(accs), jrq.apply(accs))
    np.testing.assert_array_equal(rq.raw(accs), jrq.raw(accs))


def test_requant_rejects_oversized_factor_and_sh0():
    with pytest.raises(ValueError):
        quantize_multiplier(2.0 ** 30)
    with pytest.raises(ValueError):
        quantize_multiplier(-1.0)


@pytest.mark.parametrize("bits", [15, 7])
def test_plan_requants_well_formed(bits, ref_params):
    """Every requant of a reference plan obeys the gemmlowp contract qlint
    checks, and equals the reference plan's requant."""
    p = plan_from_image(build_image(build_reference_artifact(
        params=weights.params_from_numpy(ref_params), bits=bits,
        device="cpu")))
    jp = j_plan_from_image(j_build_image(
        JG.build_reference_artifact(params=ref_params, bits=bits)))
    rqs = dict(p.rq)
    rqs["gate"], rqs["hstore"] = p.rq_gate, p.rq_hstore
    jrqs = dict(jp.rq)
    jrqs["gate"], jrqs["hstore"] = jp.rq_gate, jp.rq_hstore
    assert rqs.keys() == jrqs.keys()
    for name, rq in rqs.items():
        assert rq.m == 0 or (1 << 24) <= rq.m < (1 << 25), name
        assert 1 <= rq.sh <= 62, name
        assert rq.pre >= 0, name
        assert (rq.m, rq.sh, rq.pre) == (jrqs[name].m, jrqs[name].sh,
                                         jrqs[name].pre), name


# ---------------------------------------------------------------------------
# LUT index extremes
# ---------------------------------------------------------------------------

def test_lut_index_clamps_to_0_and_255(vm):
    p = vm.plan
    lo = np.array([[-FINE_CLIP - 1]], np.int64)
    hi = np.array([[FINE_CLIP]], np.int64)
    zero = np.array([[0]], np.int64)
    for table in (p.sig_lut, p.tanh_lut):
        assert int(vm._lut(table, lo)[0, 0]) == int(table[0])
        assert int(vm._lut(table, hi)[0, 0]) == int(table[LUT_SIZE - 1])
        assert int(vm._lut(table, zero)[0, 0]) == int(table[_LUT_IDX0])
    raw_lo = (int(lo[0, 0]) * p.lut_m + (_LUT_IDX0 << p.lut_sh)) >> p.lut_sh
    raw_hi = (int(hi[0, 0]) * p.lut_m + (_LUT_IDX0 << p.lut_sh)) >> p.lut_sh
    assert raw_lo < 0 and raw_hi > LUT_SIZE - 1


def test_sigmoid_tanh_monotone_tables(vm, jvm):
    p = vm.plan
    v = np.linspace(-FINE_CLIP - 1, FINE_CLIP, 4097).astype(np.int64)[None]
    for table, jtable in ((p.sig_lut, jvm.plan.sig_lut),
                          (p.tanh_lut, jvm.plan.tanh_lut)):
        y = vm._lut(table, v)[0]
        assert (np.diff(y.astype(np.int64)) >= 0).all()
        np.testing.assert_array_equal(y, jvm._lut(jtable, v)[0])


# ---------------------------------------------------------------------------
# extreme inputs against the emitted-C twin
# ---------------------------------------------------------------------------

def test_extreme_windows_bit_identical_to_c(model, jvm):
    """Both saturation boundaries, INT16_MIN runs and alternating extremes
    through the compiled int engine: traces and logits equal the port's
    qvm's, which equal the reference's."""
    if emit_c.find_cc() is None:
        pytest.skip("no C compiler")
    _, _, img = model
    vm = QVM(img)
    T, d = 16, img.d
    xq = np.zeros((5, T, d), np.int16)
    xq[0] = I16_MAX
    xq[1] = I16_MIN
    xq[2, :, ::2] = I16_MAX
    xq[2, :, 1::2] = I16_MIN
    xq[3, ::2] = I16_MIN
    xq[3, 1::2] = I16_MAX
    lg, traces = vm.run_windows(xq, return_trajectory=True)
    assert int(traces.min()) >= I16_MIN and int(traces.max()) <= I16_MAX
    with tempfile.TemporaryDirectory() as td:
        binary = emit_c.compile_host(img, td, engine="int")
        cm = emit_c.CHostModel(binary, img.H, img.C, engine="int")
        ctr, clg, cpred = cm.trace(xq)
    np.testing.assert_array_equal(ctr, traces)
    np.testing.assert_array_equal(clg, lg)
    np.testing.assert_array_equal(cpred, np.argmax(lg, axis=1))
    jlg, jtraces = jvm.run_windows(xq, return_trajectory=True)
    np.testing.assert_array_equal(lg, jlg)
    np.testing.assert_array_equal(traces, jtraces)
