"""Energy model (paper Sec. V-H, Tables VIII-IX).

Without an INA226 on an MCU rail at hand, this module encodes the paper's
MEASURED constants and reproduces every DERIVED quantity in Tables
VIII-IX exactly.  Beside them, the H100's side (the counterpart of the
reference's TPU v5e envelope, whose figures are not carried over): the
card's power limit and idle draw read off the card (:class:`H100Power`),
its draw sampled while a function runs (:func:`sample_power`), and an
estimate of the energy of one step from ``launch.roofline``'s bound
(:func:`h100_energy_per_step`).

Paper measurement setup: INA226 high-side shunt (0.1 ohm, addr 0x44) on the
MSP430G2553 LaunchPad VCC rail, steady-state means after 60 s, TEST_MODE 3
silent firmware (no UART/LED/I2C).
"""
from __future__ import annotations

import dataclasses
import shutil
import subprocess
import threading
import time


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


# ---------------------------------------------------------------------------
# The H100's side: power read off the card, energy from the roofline bound
# ---------------------------------------------------------------------------

POWER_QUERY = ("--query-gpu=power.draw,power.limit",
               "--format=csv,noheader,nounits")
SAMPLE_INTERVAL_S = 0.1
# An H100's ``power.draw`` is a mean over about the last second, so the
# readings of a window's first second still show what the card did
# before it; they are dropped.
SETTLE_S = 1.0
MIN_SAMPLES = 10
IDLE_SECONDS = 2.5     # H100Power.from_card's idle window, SETTLE_S included


def parse_power(line: str) -> tuple[float, float]:
    """(draw W, limit W) of one line of ``nvidia-smi`` under
    :data:`POWER_QUERY` (``"412.35, 700.00"``); raises ``ValueError`` on
    anything else, ``[N/A]`` included: a missing reading is never 0."""
    parts = [p.strip() for p in line.strip().split(",")]
    if len(parts) != 2:
        raise ValueError(f"nvidia-smi power line {line!r}: want 'draw, limit'")
    try:
        draw, limit = (float(p) for p in parts)
    except ValueError:
        raise ValueError(f"nvidia-smi power line {line!r} has no reading") \
            from None
    if not (draw >= 0 and limit > 0):
        raise ValueError(f"nvidia-smi power line {line!r} is out of range")
    return draw, limit


def _smi_id(device) -> str:
    """The card's id for ``nvidia-smi -i``: its UUID, which does not depend
    on ``CUDA_VISIBLE_DEVICES``' numbering."""
    import torch
    return f"GPU-{torch.cuda.get_device_properties(device).uuid}"


@dataclasses.dataclass(frozen=True)
class PowerSample:
    """What :func:`sample_power` saw: the mean and max draw over the
    samples kept, the power limit, the seconds ``fn`` ran, its calls and
    the number of samples kept."""
    mean_w: float
    max_w: float
    limit_w: float
    seconds: float
    calls: int
    samples: int

    def joules_per(self, work: float, idle_w: float = 0.0) -> float:
        """Energy per unit of ``work`` done over the run (``work`` units
        in total); with ``idle_w``, only the draw above it (marginal)."""
        return (self.mean_w - idle_w) * self.seconds / work


def settled(readings, t0: float, t1: float) -> list[tuple[float, float]]:
    """The (draw, limit) of the ``(seconds, draw, limit)`` readings taken
    from :data:`SETTLE_S` after ``t0`` to ``t1``, the loop's end."""
    return [(d, lim) for t, d, lim in readings if t0 + SETTLE_S <= t <= t1]


def sample_power(fn, device, *, min_seconds: float) -> PowerSample:
    """Call ``fn()`` on the card in a loop for at least ``min_seconds``
    (a synchronize after each call), while ``nvidia-smi`` reads the
    board's draw every :data:`SAMPLE_INTERVAL_S` (its ``--loop-ms`` loop,
    one line a reading, parsed by :func:`parse_power` on a thread); the
    readings of the first :data:`SETTLE_S` are dropped (:func:`settled`).
    Raises on a CPU device, without ``nvidia-smi``, on a reading it
    cannot parse (``[N/A]``) and with fewer than :data:`MIN_SAMPLES`
    samples kept."""
    import torch
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"sample_power needs a CUDA device, not {str(dev)!r}")
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: no power reading")
    readings: list[tuple[float, float, float]] = []
    errors: list[BaseException] = []
    torch.cuda.synchronize(dev)
    proc = subprocess.Popen(
        [smi, *POWER_QUERY, "-i", _smi_id(dev),
         f"--loop-ms={round(SAMPLE_INTERVAL_S * 1e3)}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def read():
        for line in proc.stdout:
            if line.strip():
                try:
                    readings.append((time.perf_counter(),
                                     *parse_power(line)))
                except ValueError as e:  # handed to the caller below
                    errors.append(e)

    thread = threading.Thread(target=read, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    calls = 0
    try:
        while True:
            fn()
            torch.cuda.synchronize(dev)
            calls += 1
            if time.perf_counter() - t0 >= min_seconds:
                break
    finally:
        t1 = time.perf_counter()
        seconds = t1 - t0
        proc.terminate()
        proc.wait(timeout=10)
        thread.join(timeout=10)
    if errors:
        raise errors[0]
    kept = settled(readings, t0, t1)
    if len(kept) < MIN_SAMPLES:
        raise RuntimeError(f"sample_power: {len(kept)} power samples after "
                           f"the first {SETTLE_S} s of {seconds:.2f} s, "
                           f"fewer than {MIN_SAMPLES}")
    draws = [d for d, _ in kept]
    return PowerSample(mean_w=sum(draws) / len(draws), max_w=max(draws),
                       limit_w=kept[-1][1], seconds=seconds, calls=calls,
                       samples=len(kept))


@dataclasses.dataclass(frozen=True)
class H100Power:
    """One card's power envelope, read off the card: its power limit and
    its draw at rest."""
    limit_w: float
    idle_w: float

    @classmethod
    def from_card(cls, device="cuda") -> "H100Power":
        """The limit and the mean draw of the card left idle for
        :data:`IDLE_SECONDS` (polled as :func:`sample_power` polls)."""
        s = sample_power(lambda: time.sleep(SAMPLE_INTERVAL_S / 4), device,
                         min_seconds=IDLE_SECONDS)
        return cls(limit_w=s.limit_w, idle_w=s.mean_w)


def h100_energy_per_step(roof, step_time_s: float, power: H100Power,
                         chips: int = 1) -> float:
    """J per step on ``chips`` cards: the static part, idle draw over the
    step's time, plus the dynamic part, the draw above idle up to the
    limit for the time the bound says a card must be busy.  ``roof`` is a
    ``launch.roofline.Roofline`` (its ``t_bound``) or that bound in
    seconds."""
    t_bound = getattr(roof, "t_bound", roof)
    static = power.idle_w * step_time_s * chips
    dynamic = (power.limit_w - power.idle_w) * t_bound * chips
    return static + dynamic
