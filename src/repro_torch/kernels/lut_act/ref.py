"""Plain torch oracle for the LUT activation kernel = core/lut.py lut_eval."""
from repro_torch.core.lut import lut_eval, make_lut, INPUT_MIN, INPUT_MAX, LUT_SIZE  # noqa: F401


def lut_act_ref(table, x, lo=INPUT_MIN, hi=INPUT_MAX, mode="nearest"):
    return lut_eval(table, x, lo=lo, hi=hi, mode=mode)
