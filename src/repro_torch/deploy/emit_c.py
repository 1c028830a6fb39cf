"""C code generator: DeployImage -> fastgrnn_model.h / fastgrnn_cell.c,
ported from the reference ``repro.deploy.emit_c``.  The emitted sources
are byte-identical to the reference's for the same image, their comments
included (``tests/test_torch_deploy.py``), so the C templates below keep
the reference package's module names in their comments.

Lowers a packed weight image into a self-contained, dependency-free C
translation unit.  Two engine modes, matching the two deployed arithmetic
paths of the paper:

  * ``engine="float"`` — the paper's deployed fastgrnn.cpp arithmetic
    (Sec. IV-D): int16 Q15 weights dequantized on use, FP32 accumulation
    in a FIXED ascending-j evaluation order, float 256-entry LUT
    activations.  No libm anywhere — the LUT replaces the
    transcendentals, and +,* are plain IEEE-754 single ops (soft-float
    on AVR/MSP430, exactly the paper's configuration).  Compiled with
    ``-ffp-contract=off`` this is **bit-identical** to the
    ``core/qruntime.QRuntime`` oracle — paper contribution (i), the
    cross-platform bit-equivalence claim, shipped as C.
  * ``engine="int"``   — the pure-integer twin of :mod:`repro_torch.deploy.qvm`
    (the multiplier-less MSP430 stand-in): same requant multipliers,
    same shifts, same saturation, same LUT indexing, so per-step int16
    hidden traces are byte-identical to the emulator.

Targets (storage/ISA differences only; arithmetic is per-engine):

  * ``avr``    — weight/LUT arrays in PROGMEM, read through
    ``pgm_read_word``/``pgm_read_dword``/``pgm_read_float`` (ATmega328P
    keeps its 2 KB SRAM for state);
  * ``msp430`` — plain ``const`` arrays (MSP430 flash is memory-mapped);
  * ``host``   — plain const arrays plus ``fastgrnn_main.c``, a
    stdin/stdout batch driver used by the parity harness (binary
    protocol: pre-quantized int16 windows in, traces/logits/argmax out).

``compile_host`` builds the host target with the system ``cc`` and
:class:`CHostModel` drives the binary over pipes.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np

from repro_torch.obs.numerics import site_order as _site_order
from .image import DeployImage
from .qvm import plan_from_image, QuantPlan, _LUT_IDX0, FINE_CLIP

TARGETS = ("avr", "msp430", "host")
ENGINES = ("float", "int")
IO_MAGIC = b"FGIO"


# ---------------------------------------------------------------------------
# Source generation
# ---------------------------------------------------------------------------

def _f32(v) -> str:
    """Exact C literal for a float32 value (hexfloat — no decimal drift)."""
    return float(np.float32(v)).hex() + "f"


def _c_int_array(name: str, a: np.ndarray, ctype: str, per_line: int = 12) -> str:
    flat = np.asarray(a).reshape(-1)
    lines = []
    for i in range(0, len(flat), per_line):
        lines.append("  " + ", ".join(str(int(v)) for v in flat[i:i + per_line]) + ",")
    return (f"static const {ctype} {name}[{len(flat)}] FG_FLASH = {{\n"
            + "\n".join(lines) + "\n};\n")


def _c_f32_array(name: str, a: np.ndarray, per_line: int = 4) -> str:
    flat = np.asarray(a, np.float32).reshape(-1)
    lines = []
    for i in range(0, len(flat), per_line):
        lines.append("  " + ", ".join(_f32(v) for v in flat[i:i + per_line]) + ",")
    return (f"static const float {name}[{len(flat)}] FG_FLASH = {{\n"
            + "\n".join(lines) + "\n};\n")


def _header_common(img: DeployImage, plan: QuantPlan, target: str,
                   engine: str) -> list[str]:
    return [
        "/* fastgrnn_model.h — generated by repro.deploy.emit_c.",
        " * Self-contained Q15 FastGRNN weight image + derived constants.",
        f" * Target: {target}; engine: {engine}.  Do not edit; re-export. */",
        "#ifndef FASTGRNN_MODEL_H",
        "#define FASTGRNN_MODEL_H",
        "#include <stdint.h>",
        "",
        f"#define FASTGRNN_TARGET_{target.upper()} 1",
        f"#define FASTGRNN_ENGINE_{engine.upper()} 1",
        "",
        "#if defined(FASTGRNN_TARGET_AVR)",
        "#include <avr/pgmspace.h>",
        "#define FG_FLASH PROGMEM",
        "#define FG_READ16(a, i) ((int16_t)pgm_read_word(&(a)[(i)]))",
        "#define FG_READ32(a, i) ((int32_t)pgm_read_dword(&(a)[(i)]))",
        "#define FG_READF(a, i)  ((float)pgm_read_float(&(a)[(i)]))",
        "#else",
        "#define FG_FLASH",
        "#define FG_READ16(a, i) ((a)[(i)])",
        "#define FG_READ32(a, i) ((a)[(i)])",
        "#define FG_READF(a, i)  ((a)[(i)])",
        "#endif",
        "",
        f"#define FG_D  {plan.d}",
        f"#define FG_H  {plan.H}",
        f"#define FG_C  {plan.C}",
        f"#define FG_RW {plan.rank_w}",
        f"#define FG_RU {plan.rank_u}",
        f"#define FG_LOW_RANK {1 if plan.low_rank else 0}",
        "",
        "/* Sensor-boundary scale: inputs arrive as int16 at FG_S_X.  The",
        " * float engine dequantizes them once per sample; the int engine",
        " * consumes them directly.  The inference loops are libm-free. */",
        f"#define FG_S_X {_f32(plan.s_x)}",
        "",
    ]


def _header_int(img: DeployImage, plan: QuantPlan, target: str) -> str:
    p = plan
    lines = _header_common(img, plan, target, "int")
    lines += [
        "/* requant: out = (((acc >> PRE) * M) + (1 << (SH-1))) >> SH */",
    ]
    for key, rq in sorted(p.rq.items()):
        lines += [f"#define FG_RQ_{key.upper()}_M {rq.m}",
                  f"#define FG_RQ_{key.upper()}_SH {rq.sh}",
                  f"#define FG_RQ_{key.upper()}_PRE {rq.pre}"]
    lines += [
        f"#define FG_RQ_GATE_M {p.rq_gate.m}",
        f"#define FG_RQ_GATE_SH {p.rq_gate.sh}",
        f"#define FG_RQ_GATE_PRE {p.rq_gate.pre}",
        f"#define FG_RQ_HSTORE_M {p.rq_hstore.m}",
        f"#define FG_RQ_HSTORE_SH {p.rq_hstore.sh}",
        f"#define FG_RQ_HSTORE_PRE {p.rq_hstore.pre}",
        f"#define FG_FINE_CLIP {FINE_CLIP}",
        "",
        "/* LUT index = (v * FG_LUT_M + (FG_LUT_IDX0 << FG_LUT_SH)) >> FG_LUT_SH",
        " * (floor, no rounding half — mirrors the float engine's truncation) */",
        f"#define FG_LUT_M {p.lut_m}",
        f"#define FG_LUT_SH {p.lut_sh}",
        f"#define FG_LUT_IDX0 {_LUT_IDX0}",
        "",
        f"#define FG_ZETA_Q {p.zeta_q}",
        f"#define FG_NU2_Q {p.nu2_q}",
        f"#define FG_LOGIT_SH {p.logit_sh}",
        "",
        "/* Numeric-health counter sites (repro.obs.numerics.site_order —",
        " * the same IDs the static analyzer classifies).  Counting is",
        " * compiled in only under -DFG_NUMERIC_COUNTERS; the indices are",
        " * emitted unconditionally so the vocabulary is part of the",
        " * image contract. */",
    ]
    sites = _site_order(p.low_rank)
    for i, site in enumerate(sites):
        lines.append(f"#define FG_SITE_{site.upper().replace('.', '_')} {i}")
    lines += [f"#define FG_NUM_SITES {len(sites)}", ""]
    for name in img.tensor_order():
        lines.append(_c_int_array(f"FG_{name.upper()}", img.q[name], "int16_t"))
    lines.append(_c_int_array("FG_BZ_Q", plan.bz_q, "int32_t"))
    lines.append(_c_int_array("FG_BH_Q", plan.bh_q, "int32_t"))
    lines.append(_c_int_array("FG_HEADB_Q", plan.headb_q, "int32_t"))
    lines.append(_c_int_array("FG_SIG_LUT", img.sig_lut, "int16_t"))
    lines.append(_c_int_array("FG_TANH_LUT", img.tanh_lut, "int16_t"))
    lines.append("#endif /* FASTGRNN_MODEL_H */")
    return "\n".join(lines) + "\n"


def _header_float(img: DeployImage, plan: QuantPlan, target: str) -> str:
    import math
    zeta = np.float32(1.0 / (1.0 + math.exp(-img.zeta_raw)))
    nu = np.float32(1.0 / (1.0 + math.exp(-img.nu_raw)))
    lines = _header_common(img, plan, target, "float")
    lines += ["/* per-tensor dequantization scales (Appendix B) */"]
    for name in img.tensor_order():
        lines.append(f"#define FG_SCALE_{name.upper()} {_f32(img.scales[name])}")
    lines += [
        f"#define FG_ZETA {_f32(zeta)}",
        f"#define FG_NU {_f32(nu)}",
        "",
    ]
    for name in img.tensor_order():
        lines.append(_c_int_array(f"FG_{name.upper()}", img.q[name], "int16_t"))
    lines.append(_c_f32_array("FG_BZ", img.b_z))
    lines.append(_c_f32_array("FG_BH", img.b_h))
    lines.append(_c_f32_array("FG_HEADB", img.head_b))
    lines.append(_c_f32_array("FG_SIG_LUT", img.sig_lut_f32))
    lines.append(_c_f32_array("FG_TANH_LUT", img.tanh_lut_f32))
    lines.append("#endif /* FASTGRNN_MODEL_H */")
    return "\n".join(lines) + "\n"


_CELL_INT_C = r"""/* fastgrnn_cell.c — generated by repro.deploy.emit_c (integer engine).
 * Pure-integer Q15 FastGRNN step (no float, no libm).  Arithmetic is the
 * bit-exact twin of repro/deploy/qvm.py; see docs/deployment.md for the
 * fixed-point contract (int16 state, int32 fine intermediates, 64-bit
 * matvec accumulators per CMSIS-NN q15 convention, round-half-up
 * requant, arithmetic shifts, saturation). */
#include "fastgrnn_model.h"

static int16_t fg_h[FG_H];

/* Optional numeric-health counters (-DFG_NUMERIC_COUNTERS): one uint64
 * per FG_SITE_* clamp site, incremented when the raw value falls outside
 * the clamp bounds — the same strictly-outside counting semantic as the
 * qvm monitor (repro.obs.numerics), parity-gated against it.  Disabled,
 * FG_COUNT compiles away and the arithmetic below is untouched. */
#ifdef FG_NUMERIC_COUNTERS
static uint64_t fg_numeric[FG_NUM_SITES];
#define FG_COUNT(site) (fg_numeric[(site)]++)
const uint64_t *fastgrnn_numeric_counters(void) { return fg_numeric; }
void fastgrnn_numeric_reset(void) {
  for (int i = 0; i < FG_NUM_SITES; i++) fg_numeric[i] = 0;
}
#else
#define FG_COUNT(site) ((void)0)
#endif

static int16_t fg_sat16(int32_t v) {
  if (v > 32767) return 32767;
  if (v < -32768) return -32768;
  return (int16_t)v;
}

static int32_t fg_requant(int64_t acc, int32_t pre, int32_t m, int32_t sh,
                          int site) {
  int64_t v;
  (void)site;
  acc >>= pre;
  v = (acc * (int64_t)m + ((int64_t)1 << (sh - 1))) >> sh;
  /* saturate instead of an implementation-defined narrowing wrap: the
   * gate-path product can exceed int32 when the calibrated h scale is
   * tiny and the inputs saturate; the qvm clips identically. */
  if (v > 2147483647LL || v < -2147483648LL) FG_COUNT(site);
  if (v > 2147483647LL) v = 2147483647LL;
  if (v < -2147483648LL) v = -2147483648LL;
  return (int32_t)v;
}

static int32_t fg_fine(int64_t acc, int32_t pre, int32_t m, int32_t sh,
                       int s_out, int s_fine) {
  int64_t v;
  (void)s_out;
  (void)s_fine;
  acc >>= pre;
  v = (acc * (int64_t)m + ((int64_t)1 << (sh - 1))) >> sh;
  /* the fine clip bounds are inside int32, so the staged int32 clamp is
   * value-identical to the single fine clamp — it exists to count the
   * *.out site separately from the *.fine site, mirroring the qvm. */
  if (v > 2147483647LL || v < -2147483648LL) FG_COUNT(s_out);
  if (v > 2147483647LL) v = 2147483647LL;
  if (v < -2147483648LL) v = -2147483648LL;
  if (v > FG_FINE_CLIP || v < -FG_FINE_CLIP - 1) FG_COUNT(s_fine);
  if (v > FG_FINE_CLIP) v = FG_FINE_CLIP;
  if (v < -FG_FINE_CLIP - 1) v = -FG_FINE_CLIP - 1;
  return (int32_t)v;
}

static int16_t fg_lut(const int16_t *table, int32_t v, int site) {
  int64_t idx = ((int64_t)v * FG_LUT_M
                 + ((int64_t)FG_LUT_IDX0 << FG_LUT_SH)) >> FG_LUT_SH;
  (void)site;
  if (idx < 0 || idx > 255) FG_COUNT(site);
  if (idx < 0) idx = 0;
  if (idx > 255) idx = 255;
  return FG_READ16(table, (int)idx);
}

void fastgrnn_reset(void) {
  for (int i = 0; i < FG_H; i++) fg_h[i] = 0;
}

const int16_t *fastgrnn_state(void) { return fg_h; }

void fastgrnn_step(const int16_t x[FG_D]) {
  int32_t pre[FG_H];
#if FG_LOW_RANK
  int32_t t1[FG_RW];
  int32_t t2[FG_RU];
  for (int r = 0; r < FG_RW; r++) {            /* t1 = W2^T x, fine s_wx1 */
    int64_t acc = 0;
    for (int j = 0; j < FG_D; j++)
      acc += (int32_t)FG_READ16(FG_W2, j * FG_RW + r) * x[j];
    t1[r] = fg_fine(acc, FG_RQ_W2_PRE, FG_RQ_W2_M, FG_RQ_W2_SH,
                    FG_SITE_W2_OUT, FG_SITE_W2_FINE);
  }
  for (int r = 0; r < FG_RU; r++) {            /* t2 = U2^T h, fine s_uh1 */
    int64_t acc = 0;
    for (int j = 0; j < FG_H; j++)
      acc += (int32_t)FG_READ16(FG_U2, j * FG_RU + r) * fg_h[j];
    t2[r] = fg_fine(acc, FG_RQ_U2_PRE, FG_RQ_U2_M, FG_RQ_U2_SH,
                    FG_SITE_U2_OUT, FG_SITE_U2_FINE);
  }
  for (int i = 0; i < FG_H; i++) {        /* pre = W1 t1 + U1 t2, fine s_pre */
    int64_t aw = 0, au = 0;
    for (int r = 0; r < FG_RW; r++)
      aw += (int64_t)FG_READ16(FG_W1, i * FG_RW + r) * t1[r];
    for (int r = 0; r < FG_RU; r++)
      au += (int64_t)FG_READ16(FG_U1, i * FG_RU + r) * t2[r];
    pre[i] = fg_fine(aw, FG_RQ_W1_PRE, FG_RQ_W1_M, FG_RQ_W1_SH,
                     FG_SITE_W1_OUT, FG_SITE_W1_FINE)
           + fg_fine(au, FG_RQ_U1_PRE, FG_RQ_U1_M, FG_RQ_U1_SH,
                     FG_SITE_U1_OUT, FG_SITE_U1_FINE);
  }
#else
  for (int i = 0; i < FG_H; i++) {             /* pre = W x + U h, fine */
    int64_t aw = 0, au = 0;
    for (int j = 0; j < FG_D; j++)
      aw += (int32_t)FG_READ16(FG_W, i * FG_D + j) * x[j];
    for (int j = 0; j < FG_H; j++)
      au += (int32_t)FG_READ16(FG_U, i * FG_H + j) * fg_h[j];
    pre[i] = fg_fine(aw, FG_RQ_W_PRE, FG_RQ_W_M, FG_RQ_W_SH,
                     FG_SITE_W_OUT, FG_SITE_W_FINE)
           + fg_fine(au, FG_RQ_U_PRE, FG_RQ_U_M, FG_RQ_U_SH,
                     FG_SITE_U_OUT, FG_SITE_U_FINE);
  }
#endif
  for (int i = 0; i < FG_H; i++) {
    int32_t z  = fg_lut(FG_SIG_LUT,  pre[i] + FG_READ32(FG_BZ_Q, i),
                        FG_SITE_ACT_Z_IDX);
    int32_t ht = fg_lut(FG_TANH_LUT, pre[i] + FG_READ32(FG_BH_Q, i),
                        FG_SITE_ACT_HT_IDX);
    /* h' = (zeta*(1-z) + nu) * h~ + z*h: evaluated at product scale,
     * ONE store-rounding into the int16 state. */
    int64_t g2 = (int64_t)FG_ZETA_Q * (32767 - z) + FG_NU2_Q;  /* unit^2 */
    int64_t af = fg_requant(g2 * ht, FG_RQ_GATE_PRE, FG_RQ_GATE_M,
                            FG_RQ_GATE_SH, FG_SITE_GATE_OUT); /* F=s_h/Q15 */
    int64_t hf = af + (int64_t)z * fg_h[i];                 /* F, exact */
    /* clip at +-2^31: past the int16 saturation point in F units */
    if (hf > 2147483647LL || hf < -2147483648LL) FG_COUNT(FG_SITE_GATE_HF_CLIP);
    if (hf > 2147483647LL) hf = 2147483647LL;
    if (hf < -2147483648LL) hf = -2147483648LL;
    {
      int32_t hs = fg_requant(hf, FG_RQ_HSTORE_PRE, FG_RQ_HSTORE_M,
                              FG_RQ_HSTORE_SH, FG_SITE_HSTORE_OUT);
      if (hs > 32767 || hs < -32768) FG_COUNT(FG_SITE_H_NEXT);
      fg_h[i] = fg_sat16(hs);
    }
  }
}

void fastgrnn_logits(int32_t out[FG_C]) {
  for (int c = 0; c < FG_C; c++) {
    int64_t acc = 0;
    int64_t lv;
    for (int i = 0; i < FG_H; i++)
      acc += (int32_t)FG_READ16(FG_HEAD_W, i * FG_C + c) * fg_h[i];
    /* int64 sum, one narrowing store — the qvm's astype(int32) twin
     * (the in-range case is identical to the historical int32 add) */
    lv = (acc >> FG_LOGIT_SH) + (int64_t)FG_READ32(FG_HEADB_Q, c);
    if (lv > 2147483647LL || lv < -2147483648LL) FG_COUNT(FG_SITE_HEAD_LOGITS);
    out[c] = (int32_t)lv;
  }
}

int fastgrnn_argmax(void) {
  int32_t lg[FG_C];
  fastgrnn_logits(lg);
  int best = 0;
  for (int c = 1; c < FG_C; c++)
    if (lg[c] > lg[best]) best = c;
  return best;
}
"""


_CELL_FLOAT_C = r"""/* fastgrnn_cell.c — generated by repro.deploy.emit_c (float engine).
 * The paper's deployed arithmetic (Sec. IV-D): int16 Q15 weights
 * dequantized on use, FP32 accumulation in a FIXED ascending-j order,
 * float LUT activations.  libm-free.  Compile with -ffp-contract=off:
 * every operation below is then the same IEEE-754 single op, in the same
 * order, as core/qruntime.QRuntime — logits are bit-identical. */
#include "fastgrnn_model.h"

static float fg_h[FG_H];

/* nearest-bucket LUT over [-8, 8), float index math identical to the
 * NumPy reference: truncate-toward-zero cast, clip, boundary override. */
static float fg_lutf(const float *table, float v) {
  int32_t idx = (int32_t)((v - -8.0f) * 16.0f);
  if (idx < 0) idx = 0;
  if (idx > 255) idx = 255;
  float y = FG_READF(table, idx);
  if (v >= 8.0f) y = FG_READF(table, 255);
  if (v <= -8.0f) y = FG_READF(table, 0);
  return y;
}

void fastgrnn_reset(void) {
  for (int i = 0; i < FG_H; i++) fg_h[i] = 0.0f;
}

const float *fastgrnn_state_f(void) { return fg_h; }

void fastgrnn_step_f(const float x[FG_D]) {
  float pre[FG_H];
#if FG_LOW_RANK
  float t1[FG_RW];
  float t2[FG_RU];
  for (int r = 0; r < FG_RW; r++) {            /* t1 = W2^T x */
    float acc = 0.0f;
    for (int j = 0; j < FG_D; j++)
      acc = acc + (float)FG_READ16(FG_W2, j * FG_RW + r) * FG_SCALE_W2 * x[j];
    t1[r] = acc;
  }
  for (int r = 0; r < FG_RU; r++) {            /* t2 = U2^T h */
    float acc = 0.0f;
    for (int j = 0; j < FG_H; j++)
      acc = acc + (float)FG_READ16(FG_U2, j * FG_RU + r) * FG_SCALE_U2 * fg_h[j];
    t2[r] = acc;
  }
  for (int i = 0; i < FG_H; i++) {             /* pre = W1 t1 + U1 t2 */
    float aw = 0.0f, au = 0.0f;
    for (int r = 0; r < FG_RW; r++)
      aw = aw + (float)FG_READ16(FG_W1, i * FG_RW + r) * FG_SCALE_W1 * t1[r];
    for (int r = 0; r < FG_RU; r++)
      au = au + (float)FG_READ16(FG_U1, i * FG_RU + r) * FG_SCALE_U1 * t2[r];
    pre[i] = aw + au;
  }
#else
  for (int i = 0; i < FG_H; i++) {             /* pre = W x + U h */
    float aw = 0.0f, au = 0.0f;
    for (int j = 0; j < FG_D; j++)
      aw = aw + (float)FG_READ16(FG_W, i * FG_D + j) * FG_SCALE_W * x[j];
    for (int j = 0; j < FG_H; j++)
      au = au + (float)FG_READ16(FG_U, i * FG_H + j) * FG_SCALE_U * fg_h[j];
    pre[i] = aw + au;
  }
#endif
  for (int i = 0; i < FG_H; i++) {
    float z  = fg_lutf(FG_SIG_LUT,  pre[i] + FG_READF(FG_BZ, i));
    float ht = fg_lutf(FG_TANH_LUT, pre[i] + FG_READF(FG_BH, i));
    fg_h[i] = (FG_ZETA * (1.0f - z) + FG_NU) * ht + z * fg_h[i];
  }
}

void fastgrnn_logits_f(float out[FG_C]) {
  for (int c = 0; c < FG_C; c++) {
    float acc = 0.0f;
    for (int i = 0; i < FG_H; i++)
      acc = acc + (float)FG_READ16(FG_HEAD_W, i * FG_C + c)
                  * FG_SCALE_HEAD_W * fg_h[i];
    out[c] = acc + FG_READF(FG_HEADB, c);
  }
}

int fastgrnn_argmax(void) {
  float lg[FG_C];
  fastgrnn_logits_f(lg);
  int best = 0;
  for (int c = 1; c < FG_C; c++)
    if (lg[c] > lg[best]) best = c;
  return best;
}
"""


_MAIN_INT_C = r"""/* fastgrnn_main.c — host parity driver (generated; host target only).
 * Binary stdin protocol: "FGIO", int32 mode (0=predict, 1=trace,
 * 2=predict+numeric counters), int32 N, int32 T, int32 d, then N*T*d
 * int16 samples pre-quantized at FG_S_X.  stdout: mode 0 -> N int32
 * argmax; mode 1 -> per window T*FG_H int16 hidden trace, FG_C int32
 * logits, int32 argmax; mode 2 -> N int32 argmax then FG_NUM_SITES
 * uint64 cumulative saturation counters (requires a binary built with
 * -DFG_NUMERIC_COUNTERS). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "fastgrnn_model.h"

void fastgrnn_reset(void);
void fastgrnn_step(const int16_t x[FG_D]);
const int16_t *fastgrnn_state(void);
void fastgrnn_logits(int32_t out[FG_C]);
int fastgrnn_argmax(void);
#ifdef FG_NUMERIC_COUNTERS
const uint64_t *fastgrnn_numeric_counters(void);
#endif

static void die(const char *msg) { fprintf(stderr, "%s\n", msg); exit(2); }

int main(void) {
  char magic[4];
  int32_t mode, n, t, d;
  if (fread(magic, 1, 4, stdin) != 4 || memcmp(magic, "FGIO", 4) != 0)
    die("bad magic");
  if (fread(&mode, 4, 1, stdin) != 1 || fread(&n, 4, 1, stdin) != 1 ||
      fread(&t, 4, 1, stdin) != 1 || fread(&d, 4, 1, stdin) != 1)
    die("bad header");
  if (d != FG_D) die("input dim mismatch");
#ifndef FG_NUMERIC_COUNTERS
  if (mode == 2) die("mode 2 requires a -DFG_NUMERIC_COUNTERS build");
#endif
  int16_t *x = (int16_t *)malloc((size_t)t * d * sizeof(int16_t));
  if (!x) die("oom");
  for (int32_t w = 0; w < n; w++) {
    if (fread(x, sizeof(int16_t), (size_t)t * d, stdin) != (size_t)t * d)
      die("short read");
    fastgrnn_reset();
    for (int32_t s = 0; s < t; s++) {
      fastgrnn_step(x + (size_t)s * d);
      if (mode == 1)
        fwrite(fastgrnn_state(), sizeof(int16_t), FG_H, stdout);
    }
    if (mode == 1) {
      int32_t lg[FG_C];
      fastgrnn_logits(lg);
      fwrite(lg, sizeof(int32_t), FG_C, stdout);
    }
    int32_t am = fastgrnn_argmax();
    fwrite(&am, sizeof(int32_t), 1, stdout);
  }
#ifdef FG_NUMERIC_COUNTERS
  if (mode == 2)
    fwrite(fastgrnn_numeric_counters(), sizeof(uint64_t), FG_NUM_SITES,
           stdout);
#endif
  free(x);
  fflush(stdout);
  return 0;
}
"""


_MAIN_FLOAT_C = r"""/* fastgrnn_main.c — host parity driver (generated; float engine).
 * Same binary protocol as the integer driver (int16 samples at FG_S_X on
 * stdin — the shared recorded sensor data); this driver dequantizes them
 * exactly like the NumPy oracle ((float)q * (float)FG_S_X) before each
 * step.  stdout: mode 0 -> N int32 argmax; mode 1 -> per window T*FG_H
 * float hidden trace, FG_C float logits, int32 argmax. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "fastgrnn_model.h"

void fastgrnn_reset(void);
void fastgrnn_step_f(const float x[FG_D]);
const float *fastgrnn_state_f(void);
void fastgrnn_logits_f(float out[FG_C]);
int fastgrnn_argmax(void);

static void die(const char *msg) { fprintf(stderr, "%s\n", msg); exit(2); }

int main(void) {
  char magic[4];
  int32_t mode, n, t, d;
  if (fread(magic, 1, 4, stdin) != 4 || memcmp(magic, "FGIO", 4) != 0)
    die("bad magic");
  if (fread(&mode, 4, 1, stdin) != 1 || fread(&n, 4, 1, stdin) != 1 ||
      fread(&t, 4, 1, stdin) != 1 || fread(&d, 4, 1, stdin) != 1)
    die("bad header");
  if (d != FG_D) die("input dim mismatch");
  int16_t *x = (int16_t *)malloc((size_t)t * d * sizeof(int16_t));
  if (!x) die("oom");
  float xf[FG_D];
  for (int32_t w = 0; w < n; w++) {
    if (fread(x, sizeof(int16_t), (size_t)t * d, stdin) != (size_t)t * d)
      die("short read");
    fastgrnn_reset();
    for (int32_t s = 0; s < t; s++) {
      for (int32_t j = 0; j < d; j++)
        xf[j] = (float)x[(size_t)s * d + j] * FG_S_X;
      fastgrnn_step_f(xf);
      if (mode == 1)
        fwrite(fastgrnn_state_f(), sizeof(float), FG_H, stdout);
    }
    if (mode == 1) {
      float lg[FG_C];
      fastgrnn_logits_f(lg);
      fwrite(lg, sizeof(float), FG_C, stdout);
    }
    int32_t am = fastgrnn_argmax();
    fwrite(&am, sizeof(int32_t), 1, stdout);
  }
  free(x);
  fflush(stdout);
  return 0;
}
"""


def generate_sources(img: DeployImage, target: str = "host",
                     engine: str = "float") -> dict[str, str]:
    """Emit the C translation unit for ``target``/``engine``.  Returns
    {filename: source}; ``host`` additionally carries the parity driver."""
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}")
    plan = plan_from_image(img)
    if engine == "float":
        out = {"fastgrnn_model.h": _header_float(img, plan, target),
               "fastgrnn_cell.c": _CELL_FLOAT_C}
        if target == "host":
            out["fastgrnn_main.c"] = _MAIN_FLOAT_C
    else:
        out = {"fastgrnn_model.h": _header_int(img, plan, target),
               "fastgrnn_cell.c": _CELL_INT_C}
        if target == "host":
            out["fastgrnn_main.c"] = _MAIN_INT_C
    return out


def write_sources(img: DeployImage, outdir: str, target: str = "host",
                  engine: str = "float") -> list[str]:
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for name, src in generate_sources(img, target, engine).items():
        p = os.path.join(outdir, name)
        with open(p, "w") as f:
            f.write(src)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# Host build + drive
# ---------------------------------------------------------------------------

def find_cc() -> str | None:
    for cc in ("cc", "gcc", "clang"):
        p = shutil.which(cc)
        if p:
            return p
    return None


def compile_host(img: DeployImage, workdir: str, engine: str = "float",
                 numeric_counters: bool = False) -> str:
    """Write host sources into ``workdir`` and compile with the system C
    compiler.  ``-ffp-contract=off`` pins the float engine to the scalar
    IEEE-754 op sequence (no FMA contraction — the same property the
    step kernel K1 gets from ``nvcc --fmad=false``).
    ``numeric_counters=True`` builds the integer engine with
    ``-DFG_NUMERIC_COUNTERS`` (per-site saturation counters + driver
    mode 2); counters off is the default and compiles the macro to
    ``((void)0)``, so the plain binary is byte-for-byte the historical
    one.  Returns the binary path; raises if no compiler is found."""
    cc = find_cc()
    if cc is None:
        raise RuntimeError("no C compiler (cc/gcc/clang) on PATH")
    if numeric_counters and engine != "int":
        raise ValueError("numeric counters are int-engine only")
    write_sources(img, workdir, target="host", engine=engine)
    binary = os.path.join(workdir,
                          f"fastgrnn_{engine}" + ("_nc" if numeric_counters
                                                  else ""))
    cmd = [cc, "-O2", "-std=c99", "-ffp-contract=off", "-Wall", "-Werror",
           *(["-DFG_NUMERIC_COUNTERS"] if numeric_counters else []),
           os.path.join(workdir, "fastgrnn_cell.c"),
           os.path.join(workdir, "fastgrnn_main.c"),
           "-o", binary]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cc failed:\n{res.stderr}")
    return binary


class CHostModel:
    """Drive a compiled host binary over stdin/stdout for parity runs."""

    def __init__(self, binary: str, H: int, C: int, engine: str = "float"):
        self.binary = binary
        self.H, self.C = H, C
        self.engine = engine

    def _run(self, xq: np.ndarray, mode: int) -> bytes:
        xq = np.ascontiguousarray(xq, dtype="<i2")
        n, t, d = xq.shape
        payload = (IO_MAGIC + struct.pack("<iiii", mode, n, t, d)
                   + xq.tobytes())
        res = subprocess.run([self.binary], input=payload,
                             capture_output=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"C engine failed: {res.stderr.decode(errors='replace')}")
        return res.stdout

    def predict_batch(self, xq: np.ndarray) -> np.ndarray:
        """(N, T, d) int16 pre-quantized windows -> (N,) int32 argmax."""
        out = self._run(xq, mode=0)
        return np.frombuffer(out, "<i4", count=xq.shape[0]).copy()

    def trace(self, xq: np.ndarray):
        """(N, T, d) -> (traces, logits, preds).  Integer engine: int16
        traces + int32 logits; float engine: f32 traces + f32 logits."""
        n, t, _ = xq.shape
        out = self._run(xq, mode=1)
        H, C = self.H, self.C
        sdt, ldt = ("<i2", "<i4") if self.engine == "int" else ("<f4", "<f4")
        ssz = 2 if self.engine == "int" else 4
        per = t * H * ssz + C * 4 + 4
        if len(out) != n * per:
            raise RuntimeError(f"short C output: {len(out)} != {n * per}")
        traces = np.zeros((n, t, H), np.int16 if ssz == 2 else np.float32)
        logits = np.zeros((n, C), np.int32 if self.engine == "int" else np.float32)
        preds = np.zeros((n,), np.int32)
        for w in range(n):
            off = w * per
            traces[w] = np.frombuffer(out, sdt, count=t * H,
                                      offset=off).reshape(t, H)
            off += t * H * ssz
            logits[w] = np.frombuffer(out, ldt, count=C, offset=off)
            preds[w] = np.frombuffer(out, "<i4", count=1,
                                     offset=off + C * 4)[0]
        return traces, logits, preds

    def counters(self, xq: np.ndarray):
        """(N, T, d) -> (preds, counts) via driver mode 2.  ``counts`` is
        the (FG_NUM_SITES,) uint64 cumulative per-site saturation vector
        (window loop accumulates; ``fastgrnn_reset`` does not clear it —
        same semantics as the qvm's :class:`NumericsMonitor`).  Requires
        a ``numeric_counters=True`` build; the plain binary dies with a
        clear message."""
        n = xq.shape[0]
        out = self._run(xq, mode=2)
        preds = np.frombuffer(out, "<i4", count=n).copy()
        tail = len(out) - n * 4
        if tail <= 0 or tail % 8:
            raise RuntimeError(f"bad counter payload: {tail} bytes")
        counts = np.frombuffer(out, "<u8", count=tail // 8,
                               offset=n * 4).copy()
        return preds, counts
