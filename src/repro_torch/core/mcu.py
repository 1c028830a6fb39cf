"""MCU cycle-cost latency model (paper Tables VII + Sec. V-G).

Without MCU hardware at hand, per-sample latency is reproduced through a
structural cycle model:

    t_step = (N_mac * c_mac + N_act * c_act + c_fixed) / f_clk

with op counts N_mac/N_act derived from the architecture (low-rank factored
matvecs, 2H activation calls per step) and per-platform cycle constants
c_mac/c_act FITTED to the paper's measured endpoints (9.21 ms Arduino-LUT,
13.87 ms MSP430-LUT, 421 ms MSP430-no-LUT, 1.51x Arduino LUT speedup).
The fitted constants are physically plausible (see comments) and the model
then *predicts* unmeasured configurations (H=32, full-rank, Q7...).

This is a MODEL, not a measurement — labeled as such everywhere it is
reported.  A copy of the reference's ``repro.core.mcu`` over the port's
:class:`~repro_torch.core.fastgrnn.FastGRNNConfig`.
"""
from __future__ import annotations

import dataclasses

from .fastgrnn import FastGRNNConfig


F_CLK_HZ = 16_000_000  # both targets run at 16 MHz


@dataclasses.dataclass(frozen=True)
class PlatformCosts:
    name: str
    c_mac: float      # cycles per dequant+FP32 multiply-accumulate
    c_act_sw: float   # cycles per software sigma/tanh (transcendental)
    c_act_lut: float  # cycles per LUT activation (index+load+saturate)
    c_fixed: float    # per-step fixed overhead (gate arithmetic, loop)


# Fitted to the paper's measured endpoints (see module docstring):
#  - AVR has a HW 8x8 multiplier -> soft-FP32 mul ~140 cyc, add ~160,
#    dequant int16->f32 ~100  => c_mac ~ 480.  avr-libc tanhf ~ 2.5k cyc.
#  - MSP430G2553 has NO multiplier: every 16x16 mult is software (~180 cyc)
#    => FP32 MAC ~ 730 cyc.  TI libm tanhf/expf with soft multiply is the
#    paper's bottleneck; the 421 ms/step measurement implies ~2.0e5 cyc per
#    transcendental call, which is what makes the LUT worth 30.5x.
ARDUINO = PlatformCosts("Arduino Uno R3 (ATmega328P)",
                        c_mac=364.0, c_act_sw=2500.0, c_act_lut=150.0, c_fixed=1500.0)
MSP430 = PlatformCosts("MSP430G2553",
                       c_mac=548.0, c_act_sw=203_765.0, c_act_lut=200.0, c_fixed=2000.0)


# ---------------------------------------------------------------------------
# Deployment platform profiles (paper Table I): memory capacities and ISA
# facts the export compiler (repro/deploy) audits a packed weight image
# against.  ``flash_capacity`` / ``sram_capacity`` are the physical part
# limits; the image + runtime working set must fit with code headroom.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlatformProfile:
    key: str                      # export-target key ("avr" | "msp430" | "host")
    name: str
    costs: PlatformCosts | None
    flash_capacity: int           # bytes of program flash
    sram_capacity: int            # bytes of data RAM
    has_multiplier: bool          # MSP430G2553 has no HW multiply (paper V-G)
    word_bits: int
    # fraction of flash reserved for code/runtime (not weights/LUTs); the
    # paper's fastgrnn.cpp translation unit is ~2-6 KB of code per target.
    code_reserve: int = 6 * 1024


AVR_PROFILE = PlatformProfile(
    key="avr", name="Arduino Uno R3 (ATmega328P)", costs=ARDUINO,
    flash_capacity=32 * 1024, sram_capacity=2 * 1024,
    has_multiplier=True, word_bits=8)
MSP430_PROFILE = PlatformProfile(
    key="msp430", name="MSP430G2553", costs=MSP430,
    flash_capacity=16 * 1024, sram_capacity=512,
    has_multiplier=False, word_bits=16, code_reserve=4 * 1024)
HOST_PROFILE = PlatformProfile(
    key="host", name="host cc (parity oracle)", costs=None,
    flash_capacity=1 << 30, sram_capacity=1 << 30,
    has_multiplier=True, word_bits=64, code_reserve=0)

PLATFORMS: dict[str, PlatformProfile] = {
    p.key: p for p in (AVR_PROFILE, MSP430_PROFILE, HOST_PROFILE)}


def platform(key: str) -> PlatformProfile:
    if key not in PLATFORMS:
        raise KeyError(f"unknown platform {key!r}; have {sorted(PLATFORMS)}")
    return PLATFORMS[key]


def audit_budget(image_bytes: int, sram_needed: int,
                 profile: PlatformProfile) -> dict[str, object]:
    """Check a packed weight image + runtime working set against a platform's
    memory budgets.  Returns the audit record; raises if either budget is
    blown (export should fail loudly, not ship an unflashable image)."""
    flash_avail = profile.flash_capacity - profile.code_reserve
    rec = {
        "platform": profile.key,
        "flash_capacity": profile.flash_capacity,
        "code_reserve": profile.code_reserve,
        "image_bytes": image_bytes,
        "flash_headroom": flash_avail - image_bytes,
        "sram_capacity": profile.sram_capacity,
        "sram_needed": sram_needed,
        "sram_headroom": profile.sram_capacity - sram_needed,
        "fits": image_bytes <= flash_avail and sram_needed <= profile.sram_capacity,
    }
    if not rec["fits"]:
        raise ValueError(
            f"image does not fit {profile.name}: "
            f"flash {image_bytes}/{flash_avail} B, "
            f"sram {sram_needed}/{profile.sram_capacity} B")
    return rec


def step_op_counts(cfg: FastGRNNConfig) -> dict[str, int]:
    """Per-sample op counts for one fastgrnn_step()."""
    d, H = cfg.input_dim, cfg.hidden_dim
    if cfg.rank_w is None:
        mac_w = H * d
    else:
        mac_w = cfg.rank_w * d + H * cfg.rank_w
    if cfg.rank_u is None:
        mac_u = H * H
    else:
        mac_u = cfg.rank_u * H + H * cfg.rank_u
    elementwise = 6 * H            # gate interpolation arithmetic
    return {"mac": mac_w + mac_u + elementwise, "act": 2 * H}


def step_latency_s(cfg: FastGRNNConfig, platform: PlatformCosts, lut: bool = True) -> float:
    n = step_op_counts(cfg)
    c_act = platform.c_act_lut if lut else platform.c_act_sw
    cycles = n["mac"] * platform.c_mac + n["act"] * c_act + platform.c_fixed
    return cycles / F_CLK_HZ


def window_latency_s(cfg: FastGRNNConfig, platform: PlatformCosts,
                     lut: bool = True, window: int = 128) -> float:
    return window * step_latency_s(cfg, platform, lut)


def budget_use(cfg: FastGRNNConfig, platform: PlatformCosts,
               lut: bool = True, budget_s: float = 0.020) -> float:
    return step_latency_s(cfg, platform, lut) / budget_s


def lut_speedup(cfg: FastGRNNConfig, platform: PlatformCosts) -> float:
    return step_latency_s(cfg, platform, lut=False) / step_latency_s(cfg, platform, lut=True)


def flash_bytes(cfg: FastGRNNConfig, nonzero_params: int | None = None,
                itemsize: int = 2, lut_tables: int = 2) -> int:
    """Deployed image weight+LUT footprint (paper: 566 B weights + 2 KB LUT)."""
    n = nonzero_params if nonzero_params is not None else (
        cfg.cell_param_count() + cfg.head_param_count())
    return n * itemsize + lut_tables * 256 * 4


def sram_bytes(cfg: FastGRNNConfig) -> int:
    """Runtime working set: h, z, h~, pre, logits, scratch (~300 B, paper)."""
    H, C = cfg.hidden_dim, cfg.num_classes
    floats = 4 * H + C + max(cfg.rank_w or 0, cfg.rank_u or 0, cfg.input_dim)
    return floats * 4 + 48  # + loop/bookkeeping
