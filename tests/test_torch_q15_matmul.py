"""Port parity, the quantized matmul (K5): the port's ``q15_matmul`` (its
plain version on the CPU) against the reference's Pallas ``q15_matmul``
in interpret mode (as ``tests/test_kernels.py`` runs it) and against the
float32 oracle ``q15_matmul_ref``, on the same numpy inputs; lead dims,
``quantized_dense`` with a bias, and the bfloat16 output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.q15_matmul.ops import q15_matmul as j_q15_matmul
from repro.kernels.q15_matmul.ops import quantized_dense as j_quantized_dense
from repro.kernels.q15_matmul.ref import q15_matmul_ref as j_q15_matmul_ref
from repro_torch.kernels.q15_matmul import ops
from repro_torch.kernels.q15_matmul.kernel import Q15Matmul, plain
from repro_torch.kernels.q15_matmul.ref import q15_matmul_ref

# 1e-5 x max|out|: the port's plain version and the reference's kernel
# compute the same float32 products of the same bfloat16 values and differ
# only in the order of the float32 sums
REL = 1e-5
ORACLE_REL = 2e-2     # the reference's kernel-vs-oracle bound (bf16 tiles)

DTYPES = {"int8": (np.int8, jnp.int8, 120), "int16": (np.int16, jnp.int16,
                                                      30000)}


def inputs(seed, m, k, n, dtype):
    np_dt, _, hi = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-hi, hi, (k, n)).astype(np_dt)
    return x, wq


def rel_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                + 1e-9)


@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (64, 96, 130),
                                   (200, 256, 128), (1, 128, 256)])
def test_q15_matmul_vs_reference_kernel_and_oracle(dtype, m, k, n):
    x, wq = inputs(2, m, k, n, dtype)
    s = 0.0021
    want = np.asarray(j_q15_matmul(jnp.asarray(x), jnp.asarray(wq), s))
    oracle = np.asarray(j_q15_matmul_ref(jnp.asarray(x), jnp.asarray(wq), s))
    got = ops.q15_matmul(torch.from_numpy(x), torch.from_numpy(wq), s)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert rel_err(got.numpy(), want) < REL
    assert rel_err(got.numpy(), oracle) < ORACLE_REL
    # the port's own oracle is the reference's, bit for bit in float32
    own = q15_matmul_ref(torch.from_numpy(x), torch.from_numpy(wq), s)
    assert rel_err(own.numpy(), oracle) < REL


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_q15_matmul_lead_dims(dtype):
    np_dt, _, hi = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    wq = rng.integers(-hi, hi, (64, 32)).astype(np_dt)
    want = np.asarray(j_q15_matmul(jnp.asarray(x), jnp.asarray(wq), 0.01))
    got = ops.q15_matmul(torch.from_numpy(x), torch.from_numpy(wq), 0.01)
    assert got.shape == (2, 5, 32)
    assert rel_err(got.numpy(), want) < REL


def test_quantized_dense_with_bias():
    x, wq = inputs(4, 6, 48, 40, "int16")
    b = np.random.default_rng(5).normal(size=40).astype(np.float32)
    s = np.float32(0.0007)
    want = np.asarray(j_quantized_dense(
        {"w": jnp.asarray(wq), "b": jnp.asarray(b)}, {"w": jnp.asarray(s)},
        jnp.asarray(x)))
    got = ops.quantized_dense({"w": torch.from_numpy(wq),
                               "b": torch.from_numpy(b)},
                              {"w": torch.tensor(s)}, torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < REL


def test_bf16_output_is_the_float32_product_rounded():
    x, wq = inputs(6, 8, 96, 130, "int16")
    want = np.asarray(j_q15_matmul(jnp.asarray(x), jnp.asarray(wq), 0.0021,
                                   out_dtype=jnp.bfloat16)).astype(np.float32)
    got = ops.q15_matmul(torch.from_numpy(x), torch.from_numpy(wq), 0.0021,
                         out_dtype=torch.bfloat16)
    f32 = ops.q15_matmul(torch.from_numpy(x), torch.from_numpy(wq), 0.0021)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    # the reference's bf16 output, within its float32 bound plus one
    # bfloat16 rounding step
    ulp = np.ldexp(np.ones_like(want), np.frexp(want)[1] - 8)
    lim = REL * float(np.abs(f32.numpy()).max()) + ulp
    assert (np.abs(got.float().numpy() - want) <= lim).all()


def test_scale_is_rounded_through_float32():
    s = ops.as_scale(0.0021, "cpu")
    assert s.dtype == torch.float32 and s.shape == ()
    assert float(s) == float(np.float32(0.0021))
    assert ops.as_scale(torch.tensor([0.5]), "cpu").shape == ()


def test_plain_version_is_what_cpu_tensors_run():
    x, wq = inputs(7, 3, 40, 24, "int8")
    s = torch.tensor(0.003)
    before = Q15Matmul.launches
    got = Q15Matmul()(torch.from_numpy(x), torch.from_numpy(wq), s)
    assert torch.equal(got, plain(torch.from_numpy(x), torch.from_numpy(wq),
                                  s))
    assert Q15Matmul.launches == before      # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "inner", "scale"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(2, 8)
    wq = torch.zeros(8, 4, dtype=torch.int16)
    s = torch.tensor(1.0)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "w_dtype":
        wq = wq.int()
    elif bad == "inner":
        wq = torch.zeros(9, 4, dtype=torch.int16)
    else:
        s = torch.tensor([1.0, 2.0])
    with pytest.raises((TypeError, ValueError)):
        Q15Matmul()(x, wq, s)


def test_plan_asks_the_card_only():
    """Which kernel a launch would run is the card's launcher's answer
    (``chip_smoke.py`` checks every plan there); a CPU tensor has none."""
    wq = torch.zeros(8, 16, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        Q15Matmul().plan(wq, 8)
