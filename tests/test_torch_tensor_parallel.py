"""The mesh path on a rank's own blocks against the reference, over 8
``gloo`` ranks (``tests/distharness.py``) on a (2, 4) (data, model) mesh,
and its per-rank memory on a fake mesh (``launch.dryrun``).

The parameters are DTensors placed by ``sharding.param_pspecs`` (mode
None: FSDP over ``data``, tensor and expert parallelism over ``model``),
carried across from the reference's own init.  Each step computes on the
rank's blocks: each layer gathers its weights' ``data`` dims at use and
never their ``model`` blocks.  Every case below comes from one spawn of
8 ranks (``distharness.tensor_parallel``); the reference's numbers are
computed here, in the test's process, on the same NumPy inputs.

The memory cases trace a reduced dense ``train_4k`` step as rank 0 of a
fake 2 x 4 mesh (``dryrun.trace_step``) at L and 2L layers: what L more
layers add to the peak is bounded by their blocks, moments, gradients and
saved residual spans, and no ``data`` all-gather is larger than one
layer's block."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import distharness as H
import repro.configs as JC
from repro.compress import tree as JQ
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.pytree import tree_leaves

DENSE = {"kv4": {"num_heads": 4, "num_kv_heads": 4},    # K/V by heads
         "kv2": {"num_heads": 4, "num_kv_heads": 2}}    # every rank's K/V


def reference_params(arch, **over):
    jcfg = JC.reduced(JC.get(arch), **H.F32, **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def tokens(jcfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, shape).astype(np.int32)


def reference_grads(jcfg, jp, batch, shards=1):
    """The reference's ``train_loss`` on each of ``shards`` equal blocks of
    the batch's rows (the rows a (2, 4) mesh's data ranks route, where
    the MoE's per-shard routing and router losses make the mesh step the
    mean of the shards'), as the mesh step combines them: the mean loss,
    the mean gradient's leaves, and its norm."""
    n = next(iter(batch.values())).shape[0] // shards
    losses, grads = [], None
    for i in range(shards):
        b = {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batch.items()}
        (loss, _), g = jax.value_and_grad(
            lambda p: JT.train_loss(jcfg, p, b), has_aux=True)(jp)
        g = [np.asarray(t, np.float64) / shards for t in jax.tree.leaves(g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        losses.append(float(loss))
    gnorm = math.sqrt(sum(float(np.sum(np.square(t))) for t in grads))
    return sum(losses) / shards, grads, gnorm


def prefill_reference(jcfg, jp, batch):
    logits, cache = JT.prefill(jcfg, jp, jax.tree.map(jnp.asarray, batch))
    return tuple(np.asarray(t) for t in (logits, cache["k"], cache["v"]))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The cases, what the reference says of each, and every rank's
    results from one 8-rank spawn."""
    cases, want = {}, {}
    acfg = JO.AdamConfig(state_dtype="float32")
    for kv, over in DENSE.items():
        jcfg, jp, npp = reference_params("deepseek-7b", **over)
        batch = {"tokens": tokens(jcfg, (8, 16), 0),
                 "labels": tokens(jcfg, (8, 16), 1)}
        p1, _, m1 = jax.jit(JR.make_train_step(jcfg, acfg))(
            jp, JO.init(jp, acfg), jax.tree.map(jnp.asarray, batch))
        cases[f"train_{kv}"] = ("train", "deepseek-7b", over, (npp, batch))
        want[f"train_{kv}"] = (p1, m1, reference_grads(jcfg, jp, batch))
        pb = {"tokens": tokens(jcfg, (4, 16), 2)}
        cases[f"prefill_{kv}"] = ("prefill", "deepseek-7b", over, (
            npp, pb, prefill_reference(jcfg, jp, pb)))
    # decode: dense by heads, int8 weights, minitron's split-KV, and the
    # same 1 KV head decoded without split-KV (the cache's sequence
    # gathered, every rank on every KV head) at 4 q heads (one a rank)
    # and at 2 (each rank's q columns less than a head: q gathered)
    jcfg, jp, npp = reference_params("deepseek-7b", **DENSE["kv4"])
    toks = tokens(jcfg, (4, 8), 3)
    full = np.asarray(JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})[0])
    cases["decode_dense"] = ("decode", "deepseek-7b", DENSE["kv4"],
                             (npp, toks, {}))
    want["decode_dense"] = full
    q, s = JQ.quantize_tree(jp, 8)
    deq = JQ.dequantize_tree(q, s)
    cases["decode_int8"] = ("decode", "deepseek-7b", DENSE["kv4"], (
        (jax.tree.map(np.asarray, q), jax.tree.map(np.asarray, s)), toks,
        {}))
    want["decode_int8"] = np.asarray(JT.forward(
        jcfg, deq, {"tokens": jnp.asarray(toks)})[0])
    for name, heads, env in (("decode_splitkv", 4, {}),
                             ("decode_no_splitkv", 4, NO_SPLITKV),
                             ("decode_no_splitkv_h2", 2, NO_SPLITKV)):
        over = {"num_heads": heads, "num_kv_heads": 1}
        jcfg, jp, npp = reference_params("minitron-4b", **over)
        cases[name] = ("decode", "minitron-4b", over, (npp, toks, env))
        want[name] = np.asarray(JT.forward(
            jcfg, jp, {"tokens": jnp.asarray(toks)})[0])
    # the mamba families in mode None: 8 heads over 4 ranks, 2 heads (the
    # channels split, every head on every rank), every leaf whole (130
    # channels), and the hybrid (its shared block on its attention heads)
    for name, (arch, over) in MAMBA.items():
        jcfg, jp, npp = reference_params(arch, **over)
        batch = {"tokens": tokens(jcfg, (8, 16), 9),
                 "labels": tokens(jcfg, (8, 16), 10)}
        cases[name] = ("train", arch, over, (npp, batch))
        want[name] = (None, no_mesh_loss(arch, over, npp, batch),
                      reference_grads(jcfg, jp, batch))
    # MoE: 4 experts, one a model rank; capacity 1.0 so that some drop
    over = {"capacity_factor": 1.0}
    jcfg, jp, npp = reference_params("olmoe-1b-7b", **over)
    batch = {"tokens": tokens(jcfg, (8, 16), 4),
             "labels": tokens(jcfg, (8, 16), 5)}
    cases["moe"] = ("train", "olmoe-1b-7b", over, (npp, batch))
    want["moe"] = (no_mesh_per_data_shard("olmoe-1b-7b", over, npp, batch),
                   reference_grads(jcfg, jp, batch, shards=2))
    # vlm: 8 patch positions before 16 tokens; audio: 16 frames
    jcfg, jp, npp = reference_params("internvl2-76b")
    rng = np.random.default_rng(6)
    vb = {"tokens": tokens(jcfg, (8, 16), 7),
          "labels": tokens(jcfg, (8, 16), 8),
          "patch_embeds": rng.normal(size=(8, jcfg.num_patches,
                                           jcfg.d_model)).astype(np.float32)}
    cases["vlm_train"] = ("train", "internvl2-76b", {}, (npp, vb))
    want["vlm_train"] = (None, None, reference_grads(jcfg, jp, vb))
    pb = {k: v[:4] for k, v in vb.items() if k != "labels"}
    cases["vlm_prefill"] = ("prefill", "internvl2-76b", {}, (
        npp, pb, prefill_reference(jcfg, jp, pb)))
    jcfg, jp, npp = reference_params("hubert-xlarge")
    frames = rng.normal(size=(4, 16, jcfg.d_model)).astype(np.float32)
    cases["audio"] = ("encode", "hubert-xlarge", {}, (
        npp, {"frames": frames}, np.asarray(JT.forward(
            jcfg, jp, {"frames": jnp.asarray(frames)})[0])))
    got = H.run(H.tensor_parallel, 8, tmp_path_factory.mktemp("tp"), cases)
    return want, got


NO_SPLITKV = {"REPRO_NO_SPLITKV": "1"}
MAMBA = {"mamba2": ("mamba2-780m", {}),
         "mamba2_h2": ("mamba2-780m", {"mamba_headdim": 64}),
         "mamba2_whole": ("mamba2-780m", {"d_model": 65,
                                          "mamba_headdim": 13}),
         "zamba2": ("zamba2-1.2b", {})}


def no_mesh_loss(arch, over, npp, batch) -> float:
    """The port's no-mesh ``train_loss`` on the whole batch."""
    cfg = C.reduced(C.get(arch), **H.F32, **over)
    p = weights.lm_params_from_numpy(npp, "cpu")
    with torch.no_grad():
        return float(T.train_loss(cfg, p, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})[0])


def no_mesh_per_data_shard(arch, over, npp, batch):
    """The port's no-mesh ``train_loss`` on each data shard's rows (the
    rows a (2, 4) mesh's data ranks route), as the mesh step combines
    them: the mean of the losses, the sum of the dropped assignments, and
    the norm of the mean gradient."""
    cfg = C.reduced(C.get(arch), **H.F32, **over)
    losses, dropped, grads = [], 0, None
    for half in (slice(0, 4), slice(4, 8)):
        p = weights.lm_params_from_numpy(npp, "cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        loss, met = T.train_loss(cfg, p, {k: torch.from_numpy(v[half])
                                          for k, v in batch.items()})
        g = torch.autograd.grad(loss, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        losses.append(float(loss.detach()))
        dropped += int(met["dropped"])
    gnorm = math.sqrt(sum(float(torch.sum(torch.square(t / 2)))
                          for t in grads))
    return sum(losses) / 2, dropped, gnorm


def result(spawned, name):
    want, got = spawned
    return want.get(name), [(r[0][name], r[1]) for r in got]


# test_torch_distributed's bounds against the reference: a loss within
# 1e-4, each gradient leaf within 1e-4 x its max |g|, logits within 1e-3
def close_grads(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-6)


@pytest.mark.parametrize("kv", list(DENSE))
def test_train_step_on_rank_blocks(spawned, kv):
    """A mode-None training step of reduced deepseek-7b (K/V by heads at
    4 KV heads; every rank's KV heads at 2): the parameters, loss and
    gradient norm after one step within 2e-4 of the reference's jitted
    no-mesh step (``test_sharded_train_step_matches_single_device``'s
    bound), the loss within 1e-4 of the reference's ``train_loss``."""
    (p1, m1, (loss, _, _)), ranks = result(spawned, f"train_{kv}")
    for (params, met, _), _ in ranks:
        assert max_diff(params, p1) < 2e-4
        assert abs(met["loss"] - float(m1["loss"])) < 2e-4
        assert abs(met["loss"] - loss) < 1e-4
        assert abs(met["grad_norm"] - float(m1["grad_norm"])) < 2e-4 * max(
            1.0, float(m1["grad_norm"]))


@pytest.mark.parametrize("name", ["train_kv4", "train_kv2", "moe",
                                  "vlm_train", *MAMBA])
def test_gradient_of_each_leaf(spawned, name):
    """Each leaf's gradient of the mesh step (the rank's blocks, summed
    over every axis the leaf is replicated along, gathered whole) within
    1e-4 x its max |g| of ``jax.grad`` of the reference's ``train_loss``
    on the same rows: the replicated leaves (norm scales, biases, the
    router) as well as the ``data`` and ``model`` blocks, so a leaf
    summed over a wrong axis fails here whatever it does to the global
    norm.  For the MoE, the mean of the two data shards' gradients, as
    the step routes each shard on its own."""
    want, ranks = result(spawned, name)
    for (_, _, got), _ in ranks:
        close_grads(got, want[-1][1])


@pytest.mark.parametrize("name", list(MAMBA))
def test_mamba_train_step_on_rank_blocks(spawned, name):
    """A mode-None training step of reduced mamba2-780m and zamba2-1.2b
    (the mode the dry-run takes under ``REPRO_NO_SEQP=1``), each mamba
    layer on the rank's heads and channels (or whole), the hybrid's
    shared block on its attention heads: every rank's loss within 1e-5
    of the reference's ``train_loss`` and of the port's no-mesh loss on
    the same batch, and the gradient norm within 1e-4 relative of the
    reference's (each leaf: :func:`test_gradient_of_each_leaf`)."""
    (_, alone, (loss, _, gnorm)), ranks = result(spawned, name)
    for (_, met, _), _ in ranks:
        assert abs(met["loss"] - loss) < 1e-5
        assert abs(met["loss"] - alone) < 1e-5
        assert abs(met["grad_norm"] - gnorm) <= 1e-4 * gnorm


def max_diff(a_tree, b_tree) -> float:
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - np.asarray(b, np.float32))))
               for a, b in zip(tree_leaves(a_tree), jax.tree.leaves(b_tree)))


def check_prefill(got, want, ref, kv_blocks, shape=None, kv_shape=None):
    """The prefill's logits within 1e-5 of the no-mesh prefill's block and
    1e-3 of the reference's; each K/V block within 1e-5 of the no-mesh
    cache's and 1e-3 of the reference's."""
    assert got.shape == want.shape == ref.shape
    assert shape is None or got.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - ref).max() < 1e-3
    for g, w, r in kv_blocks:
        assert g.shape == w.shape == r.shape
        assert kv_shape is None or g.shape == kv_shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        assert np.abs(g - r).max() < 1e-3


@pytest.mark.parametrize("kv", list(DENSE))
def test_prefill_on_rank_blocks(spawned, kv):
    """The prefill step's logits (the rank's rows and vocab block, as
    ``logits_pspec`` places them) and its K/V cache (the rank's blocks
    under ``cache_pspecs``: by KV heads at 4; at 2, the rank's span of
    the positions), each against the same blocks of the no-mesh
    prefill's and of the reference's ``prefill``
    (:func:`check_prefill`)."""
    _, ranks = result(spawned, f"prefill_{kv}")
    for (got, want, ref, kv_blocks), _ in ranks:
        check_prefill(got, want, ref, kv_blocks)
    shapes = {kv_blocks[0][0].shape for (_, _, _, kv_blocks), _ in ranks}
    assert shapes == ({(2, 2, 16, 1, 16)} if kv == "kv4"
                      else {(2, 2, 4, 2, 16)})


@pytest.mark.parametrize("name", ["decode_dense", "decode_int8",
                                  "decode_splitkv", "decode_no_splitkv",
                                  "decode_no_splitkv_h2"])
def test_decode_on_rank_blocks(spawned, name):
    """Eight decode tokens from an empty cache of the rank's blocks:
    reduced deepseek-7b on its KV heads, the same over int8 weights
    (``make_decode_step_quantized``, the rank's blocks dequantized), and
    reduced minitron-4b (1 KV head) by split-KV (the one token's q, k, v
    cross ``model``, not the weights) and, under ``REPRO_NO_SPLITKV=1``,
    without it (the cache's span gathered whole for the step, every KV
    head on every rank) at 4 q heads and at 2, fewer than the ranks; each
    token's logits, whole over the vocab, within 1e-3 of the reference's
    ``forward`` over the same tokens (for int8, on the reference's
    dequantized tree)."""
    full, ranks = result(spawned, name)
    for (splitkv, logits), rows in ranks:
        assert splitkv is (name == "decode_splitkv")
        assert logits.shape == full[rows].shape
        assert np.abs(logits - full[rows]).max() < 1e-3


def test_moe_expert_parallel_step(spawned):
    """Reduced OLMoE (4 experts, one a ``model`` rank) at capacity 1.0:
    the mesh step's loss within 1e-4 of the port's no-mesh loss on each
    data shard's rows (the rows each data rank routes) and of the
    reference's, the same dropped assignments as the no-mesh step's,
    some of them dropped, and the gradient norm within 1e-4 relative of
    both."""
    ((loss, dropped, gnorm), (rloss, _, rnorm)), ranks = result(spawned,
                                                                "moe")
    assert dropped > 0
    for (_, met, _), _ in ranks:
        assert abs(met["loss"] - loss) < 1e-4
        assert abs(met["loss"] - rloss) < 1e-4
        assert met["dropped"] == dropped
        assert abs(met["grad_norm"] - gnorm) <= 1e-4 * gnorm
        assert abs(met["grad_norm"] - rnorm) <= 1e-4 * rnorm


def test_vlm_with_patches(spawned):
    """Reduced InternVL2 with 8 patch positions before 16 tokens: the
    training step's loss within 1e-4 of the reference's ``train_loss``;
    the prefill's logits (text positions) and K/V blocks (the rank's
    span of 24 positions) against the no-mesh prefill's and the
    reference's (:func:`check_prefill`)."""
    (_, _, (loss, _, _)), ranks = result(spawned, "vlm_train")
    for (_, met, _), _ in ranks:
        assert abs(met["loss"] - loss) < 1e-4
    _, ranks = result(spawned, "vlm_prefill")
    for (got, want, ref, kv_blocks), _ in ranks:
        check_prefill(got, want, ref, kv_blocks, (2, 16, 32),
                      (2, 2, 6, 2, 16))


def test_audio_encoder(spawned):
    """Reduced HuBERT (bidirectional, a head with a bias): the encoder's
    prefill logits, the rank's vocab block with its block of the bias,
    within 1e-5 of the no-mesh forward's and 1e-3 of the reference's
    ``forward``."""
    _, ranks = result(spawned, "audio")
    for (got, want, ref), _ in ranks:
        assert got.shape == want.shape == ref.shape == (2, 16, 32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.abs(got - ref).max() < 1e-3


# ---------------------------------------------------------------------------
# Per-rank memory on a fake 2 x 4 mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_mesh():
    D.fake_group(8)
    try:
        yield make_host_mesh(data=2, model=4)
    finally:
        dist.destroy_process_group()


SEQ, BATCH = 32, 8


def traced(mesh, layers: int):
    """A reduced deepseek-7b ``train_4k`` step of ``layers`` layers traced
    on the fake mesh, each layer recomputed in the backward (``remat``,
    as every full config; ``reduced`` turns it off)."""
    cfg = C.reduced(C.get("deepseek-7b"), **H.F32, num_layers=layers,
                    remat=True)
    shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
    step, args, _ = D.build_cell("deepseek-7b", "train_4k", mesh, cfg=cfg,
                                 shape=shape)
    tracer, _ = D.trace_step(step, args, mesh)
    return cfg, shape, args, tracer


@pytest.mark.parametrize("mode", ["sp_dense", None])
def test_peak_grows_by_layer_blocks(fake_mesh, mode, monkeypatch):
    """A reduced deepseek-7b ``train_4k`` step at 2L layers against L
    (L = 2), Megatron-SP and FSDP x TP: the peak rises by at most L x
    (one layer's local blocks, their Adam moments and gradients, and one
    saved residual span, the rank's rows of its span of the sequence):
    no layer's gathered weights outlive it."""
    if mode is None:
        monkeypatch.setenv("REPRO_NO_SP_DENSE", "1")
    L = 2
    cfg, shape, args, t1 = traced(fake_mesh, L)
    assert sh.parallel_mode(cfg, shape, fake_mesh) == mode
    _, _, _, t2 = traced(fake_mesh, 2 * L)
    layer = sum(t.to_local().numel() * t.to_local().element_size()
                for t in tree_leaves(args[0]["blocks"])) // L
    span = (BATCH // 2) * (SEQ // 4 if mode else SEQ) * cfg.d_model * 4
    rise = t2.peak_bytes - t1.peak_bytes
    assert 0 < rise <= L * (layer * 4 + span), (rise, layer, span)


@pytest.mark.parametrize("mode", ["sp_dense", None])
def test_no_gather_larger_than_a_layer_block(fake_mesh, mode, monkeypatch):
    """Every ``data`` all-gather of the same step gathers at most one
    layer's block of one weight, and the step gathers along ``data``
    only there: the largest one is below one layer's blocks."""
    if mode is None:
        monkeypatch.setenv("REPRO_NO_SP_DENSE", "1")
    cfg, _, args, tracer = traced(fake_mesh, 2)
    layer = max(t.to_local()[0].numel() * t.to_local().element_size()
                for t in tree_leaves(args[0]["blocks"]))
    data = [b for kind, axis, b in tracer.log
            if kind == "all-gather" and axis == "data"]
    assert data and max(data) <= layer
