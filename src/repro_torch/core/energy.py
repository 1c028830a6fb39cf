"""Energy model (paper Sec. V-H, Tables VIII-IX).

Without an INA226 on an MCU rail at hand, this module encodes the paper's
MEASURED constants and reproduces every DERIVED quantity in Tables
VIII-IX exactly.  (The reference's TPU v5e energy envelope is not carried
over; an H100 counterpart is still to be written.)

Paper measurement setup: INA226 high-side shunt (0.1 ohm, addr 0x44) on the
MSP430G2553 LaunchPad VCC rail, steady-state means after 60 s, TEST_MODE 3
silent firmware (no UART/LED/I2C).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RailMeasurement:
    """One row of Table VIII."""
    vcc_v: float
    i_idle_ma: float       # upper bound (below INA226 resolution floor)
    i_50hz_ma: float | None
    i_cont_ma: float

    @property
    def p_active_mw(self) -> float:
        return self.vcc_v * self.i_cont_ma

    @property
    def p_idle_mw(self) -> float:
        return self.vcc_v * self.i_idle_ma


# Table VIII, measured:
MSP430_LUT = RailMeasurement(vcc_v=3.478, i_idle_ma=0.025, i_50hz_ma=5.14, i_cont_ma=5.10)
MSP430_NO_LUT = RailMeasurement(vcc_v=3.478, i_idle_ma=0.025, i_50hz_ma=None, i_cont_ma=5.08)

WINDOW_SAMPLES = 128
SAMPLE_PERIOD_S = 0.020           # 50 Hz
WINDOW_S = WINDOW_SAMPLES * SAMPLE_PERIOD_S  # 2.56 s
BATTERY_WH = 7.4                  # 2000 mAh x 3.7 V Li-Ion


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Table IX derivations for one build."""
    p_active_mw: float
    t_step_s: float

    @property
    def e_inference_uj(self) -> float:
        """E/inference = P_cont * t_step."""
        return self.p_active_mw * 1e-3 * self.t_step_s * 1e6

    @property
    def e_window_mj(self) -> float:
        """E/window = 128 * E/inference (50 Hz streaming, LPM between steps)."""
        return WINDOW_SAMPLES * self.e_inference_uj * 1e-3

    @property
    def p_stream_eff_mw(self) -> float:
        """Effective streaming power = E/window over the 2.56 s window."""
        return self.e_window_mj / WINDOW_S

    def battery_hours(self, continuous: bool) -> float:
        p_mw = self.p_active_mw if continuous else self.p_stream_eff_mw
        return BATTERY_WH * 1000.0 / p_mw

    @property
    def meets_50hz(self) -> bool:
        return self.t_step_s <= SAMPLE_PERIOD_S


# t_step from the paper: 13 ms avg measured (Table VII); for the energy
# table the paper's 246 uJ at 17.74 mW implies t_step = 13.87 ms (the
# inference-only portion, excluding loop pacing).  The no-LUT ablation:
# 421 ms/step -> 54 s/window -> the 30.5x factor.
T_STEP_LUT_S = 0.01387
T_STEP_NO_LUT_S = 0.421

LUT_BUILD = EnergyReport(p_active_mw=MSP430_LUT.p_active_mw, t_step_s=T_STEP_LUT_S)
NO_LUT_BUILD = EnergyReport(p_active_mw=MSP430_NO_LUT.p_active_mw, t_step_s=T_STEP_NO_LUT_S)


def lut_speedup() -> float:
    """~30.5x (paper Sec. V-G)."""
    return T_STEP_NO_LUT_S / T_STEP_LUT_S


def window_energy_reduction() -> float:
    """~96.7% (paper abstract / conclusion)."""
    e_no = NO_LUT_BUILD.e_inference_uj * WINDOW_SAMPLES * 1e-3  # mJ
    e_lut = LUT_BUILD.e_window_mj
    return 1.0 - e_lut / e_no
