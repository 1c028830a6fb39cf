"""The port's meshes against the reference's multi-device semantics
(``tests/test_distributed.py``), in spawned ``gloo`` process groups
(``tests/distharness.py``): each mirror runs the port on every rank of a
mesh of the reference's shape and holds it against the reference computed
here, in the test's process (8 XLA host devices), on the same NumPy
inputs, at the reference's tolerances.  Each spawn has its own 180 s
limit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import distharness as H
import repro.configs as JC
from repro.models import losses as JL
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train.grad_compression import compressed_psum as j_compressed
from repro_torch.pytree import tree_leaves

F32 = H.F32


def reference_params(arch, **over):
    jcfg = JC.reduced(JC.get(arch), **F32, **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def max_diff(a_tree, b_tree) -> float:
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - np.asarray(b, np.float32))))
               for a, b in zip(tree_leaves(a_tree), jax.tree.leaves(b_tree)))


def test_sharded_train_step_matches_single_device(tmp_path):
    """Mirror of :76: a (4, 2) mesh's step within 2e-4 of the reference's
    jitted single-device step (loss within 1e-4), on reduced deepseek-7b
    in float32 from the reference's init; also the Megatron-SP step
    (``seq_parallel``, the ``sp_dense`` layout) at the same tolerances."""
    jcfg, jp, np_params = reference_params("deepseek-7b")
    acfg = JO.AdamConfig(state_dtype="float32")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab_size, (8, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    p1, _, m1 = jax.jit(JR.make_train_step(jcfg, acfg))(
        jp, JO.init(jp, acfg), jax.tree.map(jnp.asarray, batch))
    out = H.run(H.sharded_step, 8, tmp_path, np_params, batch,
                "deepseek-7b", {}, [(False, None), (True, "sp_dense")])[0]
    for params, loss, gnorm in out:
        assert max_diff(params, p1) < 2e-4
        assert abs(loss - float(m1["loss"])) < 1e-4
        assert abs(gnorm - float(m1["grad_norm"])) < 1e-4 * float(
            m1["grad_norm"])


def test_compressed_psum_error_feedback(tmp_path):
    """Mirror of :121 over 8 ranks: int8 bitwise the reference's
    ``shard_map`` result (mean and residual on every rank), within the
    int8 error bound of the true mean, and the residual accounting for
    what was lost; bf16 with the reference's residual bitwise and its sum
    within eight bf16 roundings, as the reference's."""
    g = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    mesh = jax.make_mesh((8,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    want = {}
    for bits in (8, 16):
        red, err = jax.jit(jax.shard_map(
            lambda x, b=bits: j_compressed(x, "data", bits=b), mesh=mesh,
            in_specs=JP("data"), out_specs=(JP("data"), JP("data")),
            check_vma=False))(jnp.asarray(g))
        want[bits] = (np.asarray(red), np.asarray(err))
    got = H.run(H.compressed, 8, tmp_path, g)
    true_mean = g.mean(0)
    for r, out in enumerate(got):
        red, err = out[8]
        assert np.array_equal(red[0], want[8][0][r])
        assert np.array_equal(err[0], want[8][1][r])
        assert np.abs(red[0] - true_mean).max() < np.abs(g).max() / 127 + 1e-6
        # bf16: the residual bitwise; the sum of eight bfloat16 values
        # rounds in the collective's own order, so both packages' means
        # are held to eight bf16 roundings of a partial sum (each within
        # 2^-9 of at most 8 max|g|, over 8) of the true mean
        red16, err16 = out[16]
        assert np.array_equal(err16[0], want[16][1][r])
        bound = 2 ** -6 * np.abs(g).max()
        assert np.abs(red16[0] - true_mean).max() <= bound
        assert np.abs(want[16][0][r] - true_mean).max() <= bound
    total = sum(o[8][1][0] for o in got) / 8 + got[0][8][0][0] - true_mean
    assert np.abs(total).max() < 1e-5


def test_vocab_parallel_ce_matches_plain(tmp_path):
    """Mirror of :151 over a (2, 4) mesh: the loss and the weight's
    gradient within 1e-4 of the reference's plain path."""
    rng = np.random.default_rng(0)
    B, S, D, V = 4, 8, 16, 32
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(V, D)).astype(np.float32)
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    plain = float(JL.vocab_parallel_ce(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(y), mesh=None, tied=True,
        z_loss=1e-4, compute_dtype=jnp.float32))
    g1 = np.asarray(jax.grad(lambda w: JL.vocab_parallel_ce(
        jnp.asarray(x), w, jnp.asarray(y), mesh=None, tied=True, z_loss=0.0,
        compute_dtype=jnp.float32))(jnp.asarray(w)))
    for loss, g in H.run(H.vocab_ce, 8, tmp_path, x, w, y):
        assert abs(loss - plain) < 1e-4
        assert np.abs(g - g1).max() < 1e-4


def test_pipeline_matches_sequential(tmp_path):
    """Mirror of :181: a 4-stage GPipe of 6 microbatches within 1e-5 of the
    stages applied in turn, on every rank."""
    rng = np.random.default_rng(0)
    P_, M, b, d = 4, 6, 3, 8
    ws = (rng.normal(size=(P_, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, b, d)).astype(np.float32)
    ref = jnp.asarray(x)
    for s in range(P_):
        ref = jnp.tanh(ref @ jnp.asarray(ws[s]))
    for out in H.run(H.pipeline, P_, tmp_path, ws, x):
        assert np.abs(out - np.asarray(ref)).max() < 1e-5


def test_checkpoint_elastic_resharding(tmp_path):
    """Mirror of :208 over 4 ranks: a tree saved from a (4,) mesh restores
    onto a (2, 2) mesh with the asked placements, each rank's block and
    the whole exact."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for r, (placed, block, full) in enumerate(
            H.run(H.reshard, 4, tmp_path)):
        assert placed
        i, j = divmod(r, 2)
        assert np.array_equal(block, w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        assert np.array_equal(full, w)


def test_sp_dense_and_splitkv_match_reference(tmp_path):
    """Mirror of :232 over a (2, 4) mesh: Megatron-SP ``train_loss`` at
    both KV layouts (4 KV heads: sharded; 2: every rank computes them)
    within 1e-4 of the reference's plain loss; split-KV decode of
    reduced minitron-4b (1 KV head) within 1e-3 of the reference's
    ``forward`` at each of 8 tokens.  Also the mamba families' sequence
    parallelism (context-parallel SSD; the hybrid's shared block on the
    gathered sequence): loss within 1e-4 and gradients within 1e-4 x
    max|g| of the reference's plain ``train_loss``."""
    dense, want = [], []
    for kv in (4, 2):
        jcfg, jp, np_params = reference_params("deepseek-7b", num_heads=4,
                                               num_kv_heads=kv)
        toks = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (4, 32)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        want.append(float(JT.train_loss(jcfg, jp, jax.tree.map(
            jnp.asarray, batch))[0]))
        dense.append((kv, np_params, batch))
    jcfg, jp, np_params = reference_params("minitron-4b", num_heads=4,
                                           num_kv_heads=1)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    full = np.asarray(JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})[0])
    mamba, mwant = [], []
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        jcfg_m, jpm, np_m = reference_params(arch)
        toks_m = np.random.default_rng(4).integers(
            0, jcfg_m.vocab_size, (4, 32)).astype(np.int32)
        bm = {"tokens": toks_m, "labels": toks_m}
        (loss, _), g = jax.value_and_grad(
            lambda p: JT.train_loss(jcfg_m, p, jax.tree.map(jnp.asarray, bm)),
            has_aux=True)(jpm)
        mamba.append((arch, np_m, bm))
        mwant.append((float(loss), [np.asarray(t) for t in jax.tree.leaves(g)]))
    for r, (sp, logits, ssm) in enumerate(
            H.run(H.seq_parallel, 8, tmp_path, dense, (np_params, toks),
                  mamba)):
        for got, ref in zip(sp, want):
            assert abs(got - ref) < 1e-4, (got, ref)
        row = r // 4                       # data rank: one row each
        assert np.abs(logits[0] - full[row]).max() < 1e-3
        for (loss, grads), (wl, wg) in zip(ssm, mwant):
            assert abs(loss - wl) < 1e-4
            for a, b in zip(grads, wg):
                assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(),
                                                         1e-6)


def test_one_by_one_mesh_is_the_no_mesh_step_bitwise(tmp_path):
    """A 1 x 1 mesh: three ``make_train_step`` steps give the no-mesh
    step's losses, gradient norms and parameters bit for bit, and the
    split-KV decode gives the plain decode's logits bit for bit."""
    runs, decs = H.run(H.one_by_one, 1, tmp_path, "qwen2-1.5b", 3)[0]
    (l0, p0), (l1, p1) = runs
    assert all(np.array_equal(a, b) for x, y in zip(l0, l1)
               for a, b in zip(x, y))
    assert all(np.array_equal(a, b)
               for a, b in zip(tree_leaves(p0), tree_leaves(p1)))
    assert all(np.array_equal(a, b) for a, b in zip(*decs))


def test_launcher_trains_on_a_host_mesh(tmp_path):
    """``python -m repro_torch.launch.train --mesh host`` over 2 ranks:
    the step's history on every rank, finite losses, the first one (before
    any update) the single-process run's within 1e-5, and a checkpoint
    rank 0 wrote; run again to 3 steps, every rank restores its blocks
    from it (the DTensor parameters and moments) and trains step 2 within
    1e-4 of the single-process run's."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--seq", "16", "--global-batch", "4", "--checkpoint-every", "2"]
    hists = H.run(H.launcher, 2, tmp_path,
                  argv + ["--steps", "2", "--ckpt-dir", str(tmp_path / "m")],
                  ["--steps", "3"])
    single = launch_train.main(argv + ["--steps", "3", "--ckpt-dir",
                                       str(tmp_path / "one")])
    assert ckpt.latest_step(str(tmp_path / "m")) == 3
    for first, resumed in hists:
        assert [h["step"] for h in first] == [0, 1]
        assert [h["step"] for h in resumed] == [2]
        assert all(np.isfinite(h["loss"]) for h in first + resumed)
        assert abs(first[0]["loss"] - single[0]["loss"]) < 1e-5
        assert abs(resumed[0]["loss"] - single[2]["loss"]) < 1e-4
        assert first[1]["loss"] == hists[0][0][1]["loss"]
