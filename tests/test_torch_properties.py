"""Property-based parity (hypothesis): the seven invariants of
``tests/test_properties.py``, each drawn once and run through the port and
the reference on the same inputs — bitwise where the reference is bitwise,
at the reference's tolerance elsewhere.  Derandomized, so every run draws
the same examples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import compression as jcomp
from repro.core import fastgrnn as jfg
from repro.core import lut as jlut
from repro.core import quantization as jq
from repro.core import warmup as jwarmup
from repro_torch.core import compression as comp
from repro_torch.core import fastgrnn as fg
from repro_torch.core import quantization as q
from repro_torch.core import warmup
from repro_torch.kernels.lut_act.ref import lut_act_ref, make_lut

_settings = settings(max_examples=25, deadline=None, derandomize=True)


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@_settings
@given(rows=st.integers(1, 12), cols=st.integers(1, 12),
       frac=st.floats(0.0, 1.0), seed=st.integers(0, 1000))
def test_topk_mask_count_invariant(rows, cols, frac, seed):
    x = np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)
    keep = int(round(rows * cols * frac))
    m = comp.topk_mask(torch.from_numpy(x), keep).numpy()
    np.testing.assert_array_equal(
        m, np.asarray(jcomp.topk_mask(jnp.asarray(x), keep)))
    assert int(m.sum()) == keep
    kept, dropped = np.abs(x)[m], np.abs(x)[~m]
    if kept.size and dropped.size:
        assert kept.min() >= dropped.max() - 1e-6


@_settings
@given(scale=st.floats(1e-3, 100.0), seed=st.integers(0, 1000),
       bits_=st.sampled_from([8, 16]))
def test_quantize_roundtrip_error_bound(scale, seed, bits_):
    qmax = (1 << (bits_ - 1)) - 1
    w = (np.random.default_rng(seed).normal(size=(17,)) * scale).astype(np.float32)
    qi, s = q.quantize_tensor(torch.from_numpy(w), qmax)
    deq = q.dequantize_tensor(qi, s).numpy()
    jqi, js = jq.quantize_tensor(jnp.asarray(w), qmax)
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    assert np.float32(s) == np.float32(js)
    np.testing.assert_array_equal(
        bits(deq), bits(jq.dequantize_tensor(jqi, js)))
    assert np.max(np.abs(deq - w)) <= float(s) / 2 * 1.001 + 1e-12
    assert np.max(np.abs(qi.numpy())) <= qmax + 1


@_settings
@given(x=st.floats(-50, 50))
def test_lut_bounded_and_saturates(x):
    t = make_lut("tanh")
    y = lut_act_ref(t, torch.tensor([x], dtype=torch.float32))
    jy = jlut.lut_eval(jnp.asarray(jlut.make_lut("tanh")),
                       jnp.asarray([x], jnp.float32))
    np.testing.assert_array_equal(bits(y.numpy()), bits(jy))
    y = float(y[0])
    assert -1.0 <= y <= 1.0
    if abs(x) >= 8:
        assert abs(y - np.tanh(x)) < 2e-3


@_settings
@given(seed=st.integers(0, 500), T=st.integers(2, 40))
def test_stabilization_step_invariants(seed, T):
    preds = np.random.default_rng(seed).integers(0, 3, T)
    t = warmup.stabilization_step(preds)
    assert t == jwarmup.stabilization_step(preds)
    assert 1 <= t <= T
    assert (preds[t - 1:] == preds[-1]).all()
    if t > 1:
        assert preds[t - 2] != preds[-1]


@_settings
@given(seed=st.integers(0, 100))
def test_hidden_state_bounded_by_gate_algebra(seed):
    """|h_t| grows at most linearly in t (the two-scalar gate), on the
    reference's initial parameters carried across; the port's trajectory
    within 1e-5 of the reference's."""
    with jax.threefry_partitionable(False):
        jp = jfg.init_params(jfg.FastGRNNConfig(), jax.random.PRNGKey(seed))
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    xs = (np.random.default_rng(seed).normal(size=(30, 1, 3))
          .astype(np.float32) * 5)
    _, traj = fg.run_sequence(p, torch.from_numpy(xs), return_trajectory=True)
    _, jtraj = jfg.run_sequence(jp, jnp.asarray(xs), return_trajectory=True)
    traj = traj.numpy()
    np.testing.assert_allclose(traj, np.asarray(jtraj), rtol=0, atol=1e-5)
    zeta = float(torch.sigmoid(p["zeta"]))
    nu = float(torch.sigmoid(p["nu"]))
    bound = (zeta + nu) * np.arange(1, 31) + 1e-4
    assert (np.abs(traj[:, 0]).max(-1) <= bound).all()


@_settings
@given(m=st.integers(1, 40), k=st.integers(1, 64), n=st.integers(1, 40),
       seed=st.integers(0, 100))
def test_q15_matmul_shape_property(m, k, n, seed):
    from repro.kernels.q15_matmul.ops import q15_matmul as j_q15_matmul
    from repro_torch.kernels.q15_matmul.ops import q15_matmul
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-100, 100, (k, n)).astype(np.int8)
    out = q15_matmul(torch.from_numpy(x), torch.from_numpy(wq), 0.01).numpy()
    assert out.shape == (m, n)
    assert np.isfinite(out).all()
    want = np.asarray(j_q15_matmul(jnp.asarray(x), jnp.asarray(wq), 0.01))
    # the reference's bound for its Pallas kernel (tests/test_kernels.py)
    np.testing.assert_allclose(out, want, rtol=2e-2, atol=2e-2)


@_settings
@given(seed=st.integers(0, 50), b=st.integers(1, 3), s=st.integers(1, 33))
def test_flash_attention_matches_naive(seed, b, s):
    from repro.models.attention import chunked_attention as j_chunked
    from repro_torch.models.attention import (attention_scores,
                                              chunked_attention)
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    qkv = [np.asarray(jax.random.normal(kk, (b, s, 2, 8))) for kk in ks]
    q_, k_, v_ = (torch.from_numpy(np.array(a)) for a in qkv)
    ref = attention_scores(q_, k_, v_, causal=True)
    got = chunked_attention(q_, k_, v_, True, None, 8, 8)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3, atol=2e-5)
    want = np.asarray(j_chunked(*map(jnp.asarray, qkv), True, None, 8, 8))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-5)
