"""Port parity, IHT sparsification: ``repro_torch.core.compression``
against the reference ``repro.core.compression`` on the same numpy inputs.
Mirrors ``tests/test_compression.py`` (Eq. 7, exact top-k count, the
283-nonzero arithmetic, mask freeze, tree masks) and holds every mask to
the reference's bit for bit, ties included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro_torch.core import compression as comp
from torchharness import np_params


def tensors(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def test_cubic_schedule_eq7():
    cfg = comp.IHTConfig(target_sparsity=0.5, ramp_epochs=50)
    jcfg = jcomp.IHTConfig(target_sparsity=0.5, ramp_epochs=50)
    assert comp.sparsity_at_epoch(cfg, 0) == 0.0
    assert abs(comp.sparsity_at_epoch(cfg, 25) - 0.5 * 0.5 ** 3) < 1e-9
    assert comp.sparsity_at_epoch(cfg, 50) == 0.5
    assert comp.sparsity_at_epoch(cfg, 80) == 0.5   # frozen at target
    for e in range(0, 101, 7):
        assert comp.sparsity_at_epoch(cfg, e) == jcomp.sparsity_at_epoch(jcfg, e)


def test_topk_mask_exact_count():
    x = np.random.default_rng(0).standard_normal((37, 11)).astype(np.float32)
    for keep in [0, 1, 50, 200, 37 * 11]:
        m = comp.topk_mask(torch.from_numpy(x), keep)
        assert m.dtype == torch.bool and int(m.sum()) == keep
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(jcomp.topk_mask(jnp.asarray(x), keep)))


def test_topk_mask_keeps_largest():
    x = np.array([[0.1, -5.0, 2.0], [0.0, 3.0, -0.2]], np.float32)
    m = comp.topk_mask(torch.from_numpy(x), 2)
    assert bool(m[0, 1]) and bool(m[1, 1])


@pytest.mark.parametrize("case", ["all_equal", "threshold_tie", "zeros",
                                  "signed_ties", "quantized"])
def test_topk_mask_ties_bitwise(case):
    """Forced ties at the threshold: the stable rank decides, as in the
    reference, at every keep."""
    rng = np.random.default_rng(3)
    x = {
        "all_equal": np.ones((4, 5), np.float32),
        "threshold_tie": np.array([[3, 1, 1, 1], [1, 2, 1, 0.5]], np.float32),
        "zeros": np.array([[0, -0.0, 1, 0], [0, 2, -0.0, 0]], np.float32),
        "signed_ties": np.array([[-1, 1, -1, 1], [2, -2, 1, -1]], np.float32),
        "quantized": (rng.integers(-3, 4, (9, 7)) * 0.25).astype(np.float32),
    }[case]
    for keep in range(x.size + 1):
        got = comp.topk_mask(torch.from_numpy(x), keep).numpy()
        want = np.asarray(jcomp.topk_mask(jnp.asarray(x), keep))
        np.testing.assert_array_equal(got, want, err_msg=f"keep={keep}")
        assert got.sum() == keep


@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("low_rank", [True, False])
def test_compute_masks_bitwise(low_rank, sparsity):
    p = np_params(5, low_rank)
    cfg = comp.IHTConfig(target_sparsity=sparsity)
    got = comp.compute_masks(tensors(p), cfg, sparsity)
    want = jcomp.compute_masks(p, jcomp.IHTConfig(target_sparsity=sparsity),
                               sparsity)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    sp = comp.apply_masks(tensors(p), got)
    jsp = jcomp.apply_masks(p, want)
    for k in jsp:
        np.testing.assert_array_equal(
            sp[k].numpy().view(np.int32),
            np.asarray(jsp[k], np.float32).view(np.int32))
    assert comp.deployed_param_count(p, got) == \
        jcomp.deployed_param_count(p, want)
    assert comp.sparsity_of(sp, leaf_filter=cfg.leaf_filter) == \
        jcomp.sparsity_of(jsp, leaf_filter=cfg.leaf_filter)


def test_deployed_nonzero_arithmetic_283():
    """Paper Table II/X: s=0.5 over the 294 factor weights -> 147 kept;
    +32 biases +2 scalars +102 head = 283 nonzero, 566 B at Q15."""
    params = tensors(np_params(0))
    masks = comp.compute_masks(params, comp.IHTConfig(target_sparsity=0.5),
                               0.5)
    nz = comp.deployed_param_count(params, masks)
    assert nz == 283
    assert nz * 2 == 566                      # deployed bytes
    # the boolean numpy masks an artifact carries count the same
    np_masks = {k: m.numpy() for k, m in masks.items()}
    assert comp.deployed_param_count(params, np_masks) == 283


def test_mask_freeze_semantics():
    params = tensors(np_params(1))
    masks = comp.compute_masks(params, comp.IHTConfig(), 0.5)
    sp = comp.apply_masks(params, masks)
    # re-applying the same mask is idempotent
    sp2 = comp.apply_masks(sp, masks)
    for k in sp:
        np.testing.assert_array_equal(sp[k].numpy(), sp2[k].numpy())
    # and the frozen mask recomputed on the sparse params is the same mask
    again = comp.compute_masks(sp, comp.IHTConfig(), 0.5)
    for k in masks:
        np.testing.assert_array_equal(again[k].numpy(), masks[k].numpy())


def test_tree_masks_for_lm_pytree():
    rng = np.random.default_rng(2)
    tree = {"a": {"w": rng.standard_normal((8, 8)).astype(np.float32)},
            "b": rng.standard_normal(5).astype(np.float32)}
    ttree = {"a": {"w": torch.from_numpy(tree["a"]["w"])},
             "b": torch.from_numpy(tree["b"])}
    masks = comp.compute_masks_tree(ttree, 0.75)
    sp = comp.apply_masks_tree(ttree, masks)
    assert int((sp["a"]["w"] != 0).sum()) == 16     # 25% of 64
    assert int((sp["b"] != 0).sum()) == 5           # 1-D left dense
    jmasks = jcomp.compute_masks_tree(
        {"a": {"w": jnp.asarray(tree["a"]["w"])}, "b": jnp.asarray(tree["b"])},
        0.75)
    np.testing.assert_array_equal(masks["a"]["w"].numpy(),
                                  np.asarray(jmasks["a"]["w"]))
    np.testing.assert_array_equal(masks["b"].numpy(), np.asarray(jmasks["b"]))


def test_tree_path_filter_sees_reference_spelling():
    tree = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    seen, jseen = [], []

    def keep_a(seen):
        def f(name, leaf):
            seen.append(name)
            return name == "['a']['w']"
        return f
    masks = comp.compute_masks_tree(
        {"a": {"w": torch.from_numpy(tree["a"]["w"])},
         "b": torch.from_numpy(tree["b"])}, 0.5, keep_a(seen))
    jmasks = jcomp.compute_masks_tree(tree, 0.5, keep_a(jseen))
    assert sorted(seen) == sorted(jseen) == ["['a']['w']", "['b']"]
    np.testing.assert_array_equal(masks["a"]["w"].numpy(),
                                  np.asarray(jmasks["a"]["w"]))
    assert bool(masks["b"].all())
