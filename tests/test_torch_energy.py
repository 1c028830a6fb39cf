"""The H100 half of the port's energy model (``core/energy.py``): the
``nvidia-smi`` power parser on canned lines, ``sample_power``'s refusals,
the per-step estimate's arithmetic from a ``Roofline``, and the MCU
constants and Tables VIII-IX beside it bitwise the reference's."""
import dataclasses
import math

import pytest

from repro.core import energy as jen
from repro_torch.core import energy as en
from repro_torch.launch import roofline as RL


@pytest.mark.parametrize("line, want", [
    ("412.35, 700.00", (412.35, 700.0)),
    ("412.35, 700.00\n", (412.35, 700.0)),
    ("71.2,700", (71.2, 700.0)),
])
def test_parse_power(line, want):
    assert en.parse_power(line) == want


@pytest.mark.parametrize("line", ["[N/A], 700.00", "412.35, [N/A]", "",
                                  "412.35", "412.35, 700.00, 1",
                                  "-3.0, 700.00", "412.35, 0"])
def test_parse_power_refuses_a_missing_reading(line):
    with pytest.raises(ValueError):
        en.parse_power(line)


def test_sample_power_refuses_the_cpu():
    calls = []
    with pytest.raises(ValueError, match="CUDA device"):
        en.sample_power(lambda: calls.append(1), "cpu", min_seconds=1.0)
    assert not calls


def test_sample_power_refuses_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        en.sample_power(lambda: None, "cuda", min_seconds=1.0)


def test_readings_of_the_first_second_are_dropped():
    """``power.draw`` lags by about a second: a window keeps only the
    readings from ``SETTLE_S`` after its start to its end."""
    t0 = 100.0
    readings = [(t0 + 0.1 * i, float(i), 700.0) for i in range(60)]
    kept = en.settled(readings, t0, t0 + 5.0)
    assert [d for d, _ in kept] == [float(i) for i in range(10, 51)]
    assert en.settled(readings, t0, t0 + en.SETTLE_S - 0.05) == []
    assert en.IDLE_SECONDS - en.SETTLE_S >= en.MIN_SAMPLES * \
        en.SAMPLE_INTERVAL_S


def test_energy_per_step_arithmetic():
    power = en.H100Power(limit_w=700.0, idle_w=70.0)
    # a bound in seconds: idle over the step, (limit - idle) over the bound
    assert en.h100_energy_per_step(4e-4, 1e-3, power) == \
        70.0 * 1e-3 + 630.0 * 4e-4
    assert en.h100_energy_per_step(4e-4, 1e-3, power, chips=4) == \
        70.0 * 1e-3 * 4 + 630.0 * 4e-4 * 4
    roof = RL.Roofline(flops_per_device=2 * RL.PEAK_FLOPS * 1e-3,
                       bytes_per_device=RL.HBM_BW * 1e-3,
                       collective_bytes_per_device=0.0,
                       model_flops_global=0.0, chips=1)
    assert math.isclose(roof.t_bound, 2e-3)
    assert en.h100_energy_per_step(roof, 5e-3, power) == \
        70.0 * 5e-3 + 630.0 * roof.t_bound


def test_power_sample_joules():
    s = en.PowerSample(mean_w=400.0, max_w=450.0, limit_w=700.0,
                       seconds=5.0, calls=10, samples=50)
    assert s.joules_per(1000) == 400.0 * 5.0 / 1000
    assert s.joules_per(1000, idle_w=70.0) == 330.0 * 5.0 / 1000
    assert dataclasses.asdict(en.H100Power(700.0, 70.0)) == {
        "limit_w": 700.0, "idle_w": 70.0}


def test_mcu_constants_stay_the_reference_s():
    assert en.MSP430_LUT == dataclasses.replace(
        en.MSP430_LUT, **dataclasses.asdict(jen.MSP430_LUT))
    assert (en.T_STEP_LUT_S, en.T_STEP_NO_LUT_S, en.WINDOW_S,
            en.BATTERY_WH) == (jen.T_STEP_LUT_S, jen.T_STEP_NO_LUT_S,
                               jen.WINDOW_S, jen.BATTERY_WH)
    assert en.LUT_BUILD.e_inference_uj == jen.LUT_BUILD.e_inference_uj
    assert en.LUT_BUILD.e_window_mj == jen.LUT_BUILD.e_window_mj
    assert not hasattr(en, "TPUChipPower")
