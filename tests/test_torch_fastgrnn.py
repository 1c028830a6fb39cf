"""Port parity, the FP32 FastGRNN cell: ``repro_torch.core.fastgrnn``
against the reference ``repro.core.fastgrnn`` on the same numpy params and
inputs, plus a mirror of ``tests/test_fastgrnn.py`` (paper Eq. (1)-(4),
Table I/IV parameter accounting)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastgrnn as jfg
from repro.core import lut as jlut
from repro_torch.core import fastgrnn as fg
from repro_torch.core import lut
from torchharness import np_cell_params as np_params


def to_torch(p):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in p.items()}


def to_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def gen(seed):
    return torch.Generator().manual_seed(seed)


CASES = [(True, False), (False, False), (True, True)]


@pytest.mark.parametrize("low_rank,alpha", CASES)
@pytest.mark.parametrize("acts", ["exact", "lut"])
def test_cell_step_and_run_sequence_vs_reference(low_rank, alpha, acts):
    p = np_params(1, low_rank=low_rank, alpha=alpha)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    h = (0.5 * rng.normal(size=(5, 16))).astype(np.float32)
    xs = rng.normal(size=(24, 5, 3)).astype(np.float32)
    kw, jkw = {}, {}
    if acts == "lut":
        kw = {"sigma": lut.lut_sigmoid, "tanh": lut.lut_tanh}
        jkw = {"sigma": jlut.lut_sigmoid, "tanh": jlut.lut_tanh}
    got = fg.cell_step(to_torch(p), torch.from_numpy(h), torch.from_numpy(x),
                       **kw).numpy()
    ref = np.asarray(jfg.cell_step(to_jax(p), jnp.asarray(h), jnp.asarray(x),
                                   **jkw))
    # 1e-6: float32 products summed in another order than XLA's
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    hf, traj = fg.run_sequence(to_torch(p), torch.from_numpy(xs),
                               return_trajectory=True, **kw)
    jhf, jtraj = jfg.run_sequence(to_jax(p), jnp.asarray(xs),
                                  return_trajectory=True, **jkw)
    assert traj.shape == (24, 5, 16)
    # a LUT bucket can flip on a 1-ulp difference, so the LUT runs are
    # held to the window kernel's bound (2e-5) over 24 steps
    tol = 1e-6 if acts == "exact" else 2e-5
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), rtol=0, atol=tol)
    logits = fg.forward_window(to_torch(p), torch.from_numpy(xs), **kw)
    jlogits = jfg.forward_window(to_jax(p), jnp.asarray(xs), **jkw)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("low_rank,alpha", CASES)
def test_effective_weights_and_loss_vs_reference(low_rank, alpha):
    p = np_params(3, low_rank=low_rank, alpha=alpha)
    np.testing.assert_allclose(fg.effective_W(to_torch(p)).numpy(),
                               np.asarray(jfg.effective_W(to_jax(p))),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(fg.effective_U(to_torch(p)).numpy(),
                               np.asarray(jfg.effective_U(to_jax(p))),
                               rtol=0, atol=1e-7)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(16, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 6, 8)
    got = float(fg.loss_fn(to_torch(p), torch.from_numpy(xs),
                           torch.from_numpy(ys)))
    ref = float(jfg.loss_fn(to_jax(p), jnp.asarray(xs), jnp.asarray(ys)))
    assert abs(got - ref) < 1e-5
    assert fg.count_params(to_torch(p)) == jfg.count_params(to_jax(p))
    assert fg.count_nonzero(to_torch(p)) == jfg.count_nonzero(to_jax(p))


@pytest.mark.parametrize("kw", [{}, {"rank_w": 2, "rank_u": 8},
                                {"rank_w": 2, "rank_u": 4,
                                 "diag_residual": True}])
def test_config_and_init_shapes_match_reference(kw):
    cfg, jcfg = fg.FastGRNNConfig(**kw), jfg.FastGRNNConfig(**kw)
    assert cfg.low_rank == jcfg.low_rank
    assert cfg.cell_param_count() == jcfg.cell_param_count()
    assert cfg.head_param_count() == jcfg.head_param_count()
    p = fg.init_params(cfg, gen(0))
    jp = jfg.init_params(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("b_z", "b_h", "zeta", "nu", "head_b", "alpha"):
        if k in jp:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    for k in ("W", "U", "W1", "W2", "U1", "U2", "head_w"):
        if k in p:   # N(0, 0.1): same scale, the generators' own draws
            assert 0.05 < float(p[k].std()) < 0.2, k


# ---- mirror of tests/test_fastgrnn.py --------------------------------------

def test_param_count_full_rank_matches_paper_eq4():
    cfg = fg.FastGRNNConfig()          # H=16, d=3
    assert cfg.cell_param_count() == 338           # 48 + 256 + 32 + 2
    assert cfg.head_param_count() == 102           # 16*6 + 6
    assert fg.count_params(fg.init_params(cfg, gen(0))) == 440


def test_param_count_low_rank_matches_table2():
    cfg = fg.FastGRNNConfig(rank_w=2, rank_u=8)
    assert cfg.cell_param_count() == 328
    assert fg.count_params(fg.init_params(cfg, gen(0))) == 430


def test_cell_step_matches_manual_equations():
    p = fg.init_params(fg.FastGRNNConfig(), gen(1))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=3).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    pre = p["W"] @ x + p["U"] @ h
    z = torch.sigmoid(pre + p["b_z"])
    h_t = torch.tanh(pre + p["b_h"])
    zeta = torch.sigmoid(p["zeta"])
    nu = torch.sigmoid(p["nu"])
    expected = (zeta * (1 - z) + nu) * h_t + z * h
    np.testing.assert_allclose(fg.cell_step(p, h, x).numpy(),
                               expected.numpy(), rtol=1e-6, atol=1e-6)


def test_low_rank_equals_dense_product():
    p = fg.init_params(fg.FastGRNNConfig(rank_w=2, rank_u=8), gen(2))
    dense = dict(p)
    dense["W"] = fg.effective_W(p)
    dense["U"] = fg.effective_U(p)
    for k in ("W1", "W2", "U1", "U2"):
        dense.pop(k)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    np.testing.assert_allclose(fg.cell_step(p, h, x).numpy(),
                               fg.cell_step(dense, h, x).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_run_sequence_trajectory_consistent():
    p = fg.init_params(fg.FastGRNNConfig(), gen(3))
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(10, 2, 3))
                          .astype(np.float32))
    h_final, traj = fg.run_sequence(p, xs, return_trajectory=True)
    np.testing.assert_array_equal(traj[-1].numpy(), h_final.numpy())
    h = torch.zeros(2, 16)
    for t in range(10):
        h = fg.cell_step(p, h, xs[t])
    np.testing.assert_allclose(h.numpy(), h_final.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_loss_decreases_with_training_step():
    p = fg.init_params(fg.FastGRNNConfig(rank_w=2, rank_u=8), gen(4))
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.normal(size=(16, 8, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 6, 8))
    p = {k: v.requires_grad_() for k, v in p.items()}
    loss0 = fg.loss_fn(p, xs, ys)
    grads = torch.autograd.grad(loss0, list(p.values()))
    with torch.no_grad():
        p2 = {k: v - 0.05 * g for (k, v), g in zip(p.items(), grads)}
        loss1 = fg.loss_fn(p2, xs, ys)
    assert float(loss1) < float(loss0.detach())


def test_dual_rank_diag_residual():
    """Paper Sec. VI-E direction 1: U_eff = LowRank(r) + diag(alpha)."""
    cfg = fg.FastGRNNConfig(rank_w=2, rank_u=4, diag_residual=True)
    assert cfg.cell_param_count() == 216       # 38 + 128 + 16 + 32 + 2
    p = fg.init_params(cfg, gen(0))
    assert "alpha" in p
    u = fg.effective_U(p)
    np.testing.assert_allclose(torch.diag(u).numpy(),
                               torch.diag(p["U1"] @ p["U2"].T).numpy()
                               + p["alpha"].numpy(), rtol=1e-6)
    dense = {k: v for k, v in p.items() if k not in ("U1", "U2", "alpha")}
    dense["U"] = u
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    np.testing.assert_allclose(fg.cell_step(p, h, x).numpy(),
                               fg.cell_step(dense, h, x).numpy(),
                               rtol=1e-5, atol=1e-5)
