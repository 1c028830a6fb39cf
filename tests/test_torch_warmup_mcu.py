"""Port parity, the paper's numpy-only models: warm-up characterization
(``repro_torch.core.warmup``, Sec. VI-A), the MCU latency model
(``core.mcu``, Table VII) and the energy model (``core.energy``, Tables
VIII-IX), mirroring the warm-up parts of ``tests/test_warmup_data.py`` and
all of ``tests/test_energy_mcu.py``, each number also equal to the
reference's."""
import numpy as np
import pytest

from repro.core import energy as jen
from repro.core import fastgrnn as jfg
from repro.core import mcu as jmcu
from repro.core import warmup as jwarmup
from repro_torch.core import energy as en
from repro_torch.core import mcu, warmup
from repro_torch.core.fastgrnn import FastGRNNConfig

CFG = FastGRNNConfig(rank_w=2, rank_u=8)
JCFG = jfg.FastGRNNConfig(rank_w=2, rank_u=8)


# ---- warm-up (mirror of tests/test_warmup_data.py) -------------------------

def test_stabilization_step_cases():
    assert warmup.stabilization_step(np.array([2, 2, 2])) == 1
    assert warmup.stabilization_step(np.array([0, 1, 2, 2, 2])) == 3
    assert warmup.stabilization_step(np.array([1, 1, 1, 0])) == 4
    assert warmup.stabilization_step(np.array([0, 1])) == 2


def test_characterize_stats():
    preds = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [0, 1, 0, 2, 2]])
    st = warmup.characterize(preds)
    assert st.worst_case == 4
    assert st.n_windows == 3
    assert st.median_samples == 3.0
    assert abs(st.median_seconds - 3 / 50) < 1e-9


def test_characterize_and_row_match_reference():
    preds = np.random.default_rng(0).integers(0, 3, size=(100, 128))
    preds[:, 90:] = preds[:, -1:]            # every window settles by 91
    st, jst = warmup.characterize(preds), jwarmup.characterize(preds)
    assert st.row() == jst.row()
    assert (st.median_samples, st.iqr_lo, st.iqr_hi, st.worst_case, st.mean,
            st.n_windows) == (jst.median_samples, jst.iqr_lo, jst.iqr_hi,
                              jst.worst_case, jst.mean, jst.n_windows)


def test_trajectory_predictions_generic():
    head = np.eye(4, 3, dtype=np.float32)
    windows = [np.random.default_rng(i).normal(size=(6, 4)) for i in range(3)]
    run = lambda params, w: w                     # trajectory = the inputs
    head_fn = lambda params, traj: traj @ params
    got = warmup.trajectory_predictions(head, windows, head_fn, run)
    np.testing.assert_array_equal(
        got, jwarmup.trajectory_predictions(head, windows, head_fn, run))
    assert got.shape == (3, 6)


# ---- energy (mirror of tests/test_energy_mcu.py) ---------------------------

def test_active_power_17_7mw():
    assert abs(en.MSP430_LUT.p_active_mw - 17.7) < 0.1


def test_energy_per_inference_246uj():
    assert abs(en.LUT_BUILD.e_inference_uj - 246) < 2


def test_energy_per_window_31_5mj():
    assert abs(en.LUT_BUILD.e_window_mj - 31.5) < 0.3


def test_no_lut_energy_7440uj():
    assert abs(en.NO_LUT_BUILD.e_inference_uj - 7440) < 20


def test_battery_life_602h_streaming_417h_continuous():
    assert abs(en.LUT_BUILD.battery_hours(continuous=False) - 602) < 5
    assert abs(en.LUT_BUILD.battery_hours(continuous=True) - 417) < 3


def test_lut_speedup_30_5x():
    assert abs(en.lut_speedup() - 30.5) < 0.5


def test_window_energy_reduction_96_7pct():
    assert abs(en.window_energy_reduction() - 0.967) < 0.002


def test_no_lut_misses_50hz_deadline():
    assert en.LUT_BUILD.meets_50hz
    assert not en.NO_LUT_BUILD.meets_50hz


def test_energy_numbers_equal_reference():
    for build, jbuild in ((en.LUT_BUILD, jen.LUT_BUILD),
                          (en.NO_LUT_BUILD, jen.NO_LUT_BUILD)):
        assert build.e_inference_uj == jbuild.e_inference_uj
        assert build.e_window_mj == jbuild.e_window_mj
        for c in (True, False):
            assert build.battery_hours(c) == jbuild.battery_hours(c)
    assert en.window_energy_reduction() == jen.window_energy_reduction()
    assert not hasattr(en, "TPUChipPower")   # TPU v5e figures stay behind


# ---- MCU cycle model (Table VII) -------------------------------------------

def test_arduino_latency_9_21ms():
    t = mcu.step_latency_s(CFG, mcu.ARDUINO, lut=True)
    assert abs(t * 1e3 - 9.21) < 0.15


def test_msp430_latency_13_9ms():
    t = mcu.step_latency_s(CFG, mcu.MSP430, lut=True)
    assert abs(t * 1e3 - 13.87) < 0.2


def test_msp430_no_lut_421ms():
    t = mcu.step_latency_s(CFG, mcu.MSP430, lut=False)
    assert abs(t * 1e3 - 421) < 5


def test_arduino_lut_speedup_1_51x():
    assert abs(mcu.lut_speedup(CFG, mcu.ARDUINO) - 1.51) < 0.05


def test_msp430_lut_speedup_30x():
    assert abs(mcu.lut_speedup(CFG, mcu.MSP430) - 30.4) < 1.0


def test_budget_use_46_65_pct():
    assert abs(mcu.budget_use(CFG, mcu.ARDUINO) - 0.46) < 0.02
    assert abs(mcu.budget_use(CFG, mcu.MSP430) - 0.69) < 0.05


def test_flash_and_sram_budgets():
    assert mcu.flash_bytes(CFG, nonzero_params=283) == 566 + 2048
    assert mcu.flash_bytes(CFG, nonzero_params=283) < 16 * 1024
    assert mcu.sram_bytes(CFG) < 512                 # MSP430G2553 SRAM


def test_h32_would_still_fit_but_slower():
    big = FastGRNNConfig(hidden_dim=32)
    t16 = mcu.step_latency_s(FastGRNNConfig(), mcu.MSP430)
    t32 = mcu.step_latency_s(big, mcu.MSP430)
    assert t32 > 2.5 * t16                          # ~4x MACs, 2x acts


@pytest.mark.parametrize("kw", [{}, {"rank_w": 2, "rank_u": 8},
                                {"hidden_dim": 32}])
@pytest.mark.parametrize("key", ["avr", "msp430"])
def test_mcu_model_equals_reference(kw, key):
    cfg, jcfg = FastGRNNConfig(**kw), jfg.FastGRNNConfig(**kw)
    prof, jprof = mcu.platform(key), jmcu.platform(key)
    assert mcu.step_op_counts(cfg) == jmcu.step_op_counts(jcfg)
    for lut in (True, False):
        assert mcu.step_latency_s(cfg, prof.costs, lut) == \
            jmcu.step_latency_s(jcfg, jprof.costs, lut)
        assert mcu.window_latency_s(cfg, prof.costs, lut) == \
            jmcu.window_latency_s(jcfg, jprof.costs, lut)
    assert mcu.flash_bytes(cfg) == jmcu.flash_bytes(jcfg)
    assert mcu.sram_bytes(cfg) == jmcu.sram_bytes(jcfg)
    assert mcu.audit_budget(2614, 300, prof) == \
        jmcu.audit_budget(2614, 300, jprof)
    with pytest.raises(ValueError):
        mcu.audit_budget(prof.flash_capacity, 0, prof)
