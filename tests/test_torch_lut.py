"""Port parity, LUT activations: ``repro_torch.core.lut`` and the LUT
kernel's entry points (``repro_torch.kernels.lut_act``, CPU plain path)
against the reference ``repro.core.lut`` and its Pallas kernel in
interpret mode, on the same numpy inputs; plus a mirror of
``tests/test_lut.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.kernels.lut_act import ops as jops
from repro_torch.core import lut
from repro_torch.kernels.lut_act import ops
from repro_torch.kernels.lut_act.kernel import LUTAct

FNS = ["sigmoid", "tanh", "silu", "gelu", "softplus"]

# the edges of the domain and of the buckets, and the special values whose
# result the plain version defines (NaN: table[0] nearest, NaN lerp)
EDGES = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 8.0, -8.0, 7.9999995,
                  -7.9999995, 8.000001, -8.000001, -7.9375, 0.0625, 3.03125,
                  1e30, -1e30], np.float32)


def as_bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("fn", FNS)
def test_make_lut_bitwise(fn):
    np.testing.assert_array_equal(as_bits(lut.make_lut(fn).numpy()),
                                  as_bits(jlut.make_lut(fn)))


@pytest.mark.parametrize("fn", ["sigmoid", "tanh"])
def test_make_lut_q15_bitwise(fn):
    got = lut.make_lut_q15(fn).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, jlut.make_lut_q15(fn))


def test_make_lut_q15_refuses_unbounded():
    for fn in sorted(lut._LINEAR_TAILS):
        with pytest.raises(ValueError):
            lut.make_lut_q15(fn)


def test_constants_match_reference():
    assert lut.BUCKET_WIDTH == jlut.BUCKET_WIDTH
    assert lut.LUT_INPUT_SCALE == jlut.LUT_INPUT_SCALE
    assert lut._LINEAR_TAILS == jlut._LINEAR_TAILS


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("mode", ["nearest", "lerp"])
@pytest.mark.parametrize("shape", [(33,), (7, 129), (2, 3, 64)])
def test_lut_eval_and_lut_act_vs_reference(fn, mode, shape):
    x = (np.random.default_rng(0).normal(size=shape) * 5).astype(np.float32)
    lt = fn in lut._LINEAR_TAILS
    ref = np.asarray(jlut.lut_eval(jnp.asarray(jlut.make_lut(fn)),
                                   jnp.asarray(x), mode=mode, linear_tail=lt))
    ref_k = np.asarray(jops.lut_act(jnp.asarray(x), fn, mode=mode))
    got = lut.lut_eval(lut.make_lut(fn), torch.from_numpy(x), mode=mode,
                       linear_tail=lt).numpy()
    got_k = ops.lut_act(torch.from_numpy(x), fn, mode=mode).numpy()
    # atol 1e-6: the reference's own kernel-vs-oracle bound
    for a in (got, got_k):
        assert a.shape == shape
        np.testing.assert_allclose(a, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a, ref_k, rtol=0, atol=1e-6)
    # the CPU entry point is the plain version itself
    np.testing.assert_array_equal(as_bits(got_k), as_bits(got))


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("mode", ["nearest", "lerp"])
def test_lut_eval_edges_and_special_values(fn, mode):
    lt = fn in lut._LINEAR_TAILS
    ref = np.asarray(jlut.lut_eval(jnp.asarray(jlut.make_lut(fn)),
                                   jnp.asarray(EDGES), mode=mode,
                                   linear_tail=lt))
    got = lut.lut_eval(lut.make_lut(fn), torch.from_numpy(EDGES), mode=mode,
                       linear_tail=lt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, equal_nan=True)
    t = lut.make_lut(fn).numpy()
    assert got[0] == t[0] if mode == "nearest" else np.isnan(got[0])
    assert got[1] == (np.inf if lt else t[-1])
    assert got[2] == (0.0 if lt else t[0])


@pytest.mark.parametrize("fn", ["sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("mode", ["nearest", "lerp"])
def test_bfloat16_dtype_kept_and_matches_reference(fn, mode):
    x = np.linspace(-10, 10, 257).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = ops.lut_act(xb, fn, mode=mode)
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    ref = jops.lut_act(jnp.asarray(xb.float().numpy(), jnp.bfloat16), fn,
                       mode=mode)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=1e-6)


def test_lut_act_rejects_other_dtypes_and_modes():
    with pytest.raises(TypeError):
        ops.lut_tanh(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.lut_tanh(torch.zeros(4), mode="cubic")
    with pytest.raises(ValueError):
        lut.lut_eval(lut.make_lut("tanh"), torch.zeros(4), mode="cubic")


def test_cpu_path_launches_nothing():
    before = LUTAct.launches
    act = LUTAct()
    for fn in FNS:
        act(torch.linspace(-9, 9, 100), fn)
    assert LUTAct.launches == before


def test_tables_are_made_once_for_every_instance():
    cpu = torch.device("cpu")
    t = LUTAct.table("tanh", lut.INPUT_MIN, lut.INPUT_MAX, cpu)
    ops.lut_tanh(torch.zeros(4))
    assert LUTAct().table("tanh", lut.INPUT_MIN, lut.INPUT_MAX, cpu) is t
    assert torch.equal(t, lut.make_lut("tanh"))


def test_lut_sigmoid_tanh_helpers_match_reference():
    x = np.linspace(-12, 12, 999).astype(np.float32)
    for mode in ("nearest", "lerp"):
        np.testing.assert_array_equal(
            as_bits(lut.lut_sigmoid(torch.from_numpy(x), mode).numpy()),
            as_bits(ops.lut_sigmoid(torch.from_numpy(x), mode=mode).numpy()))
        np.testing.assert_allclose(
            lut.lut_tanh(torch.from_numpy(x), mode).numpy(),
            np.asarray(jlut.lut_tanh(jnp.asarray(x), mode)), rtol=0,
            atol=1e-6)


# ---- mirror of tests/test_lut.py -------------------------------------------

def test_table_values_match_appendix_c():
    t = lut.make_lut("sigmoid")
    bw = 16.0 / 256
    for i in [0, 17, 128, 255]:
        x = -8.0 + (i + 0.5) * bw          # bucket-center sampling
        assert abs(float(t[i]) - 1 / (1 + math.exp(-x))) < 1e-6


def test_saturation_exact_in_tails():
    for fn, f in [("sigmoid", lambda x: 1 / (1 + np.exp(-x))),
                  ("tanh", np.tanh)]:
        t = lut.make_lut(fn)
        for x in [9.0, 20.0, -9.0, -100.0]:
            got = float(lut.lut_eval(t, torch.tensor(x)))
            assert abs(got - f(x)) < 2e-3   # table[0]/[255] vs true tail


def test_flash_budget_2kb():
    assert lut.flash_bytes() == 2048 == jlut.flash_bytes()


def test_max_error_small_inside_domain():
    for fn in ("sigmoid", "tanh"):
        e_near = lut.max_abs_error(fn, "nearest")
        e_lerp = lut.max_abs_error(fn, "lerp")
        assert e_near <= 0.04, (fn, e_near)
        assert e_lerp < e_near / 10         # lerp strictly better
        assert e_lerp < 5e-4, (fn, e_lerp)
        assert abs(e_near - jlut.max_abs_error(fn, "nearest")) < 1e-6
        assert abs(e_lerp - jlut.max_abs_error(fn, "lerp")) < 1e-6


def test_linear_tail_functions():
    y = lut.LUTActivations(mode="nearest")("silu", torch.tensor([-20.0, 20.0]))
    assert abs(float(y[0]) - 0.0) < 1e-6
    assert abs(float(y[1]) - 20.0) < 1e-6


def test_monotonicity_nearest():
    xs = torch.linspace(-8, 8, 4096)
    for fn in ("sigmoid", "tanh"):
        ys = lut.lut_eval(lut.make_lut(fn), xs).numpy()
        assert np.all(np.diff(ys) >= 0)
