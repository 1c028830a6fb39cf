"""Port parity, ``repro_torch.models.registry`` (its serving half) and
``repro_torch.models.baselines``, with the models-smoke and engine mirrors.

* Registry: ``input_specs`` and ``abstract_cache`` equal the reference's
  ``ShapeDtypeStruct``s for every arch x ``SHAPES`` entry that
  ``applicable`` allows; ``abstract_params`` has the reference's leaf
  names, shapes and dtypes and ``param_count`` / ``active_param_count``
  the reference's numbers for every full config, all ``meta`` tensors
  (nothing allocated, ``nemotron-4-340b`` included); the prefill, decode
  and quantized decode steps against the reference's on its own trees;
  meshes refused, naming A10's distributed half; the
  training half itself is ``tests/test_torch_lm_train.py``'s.
* Mirror of ``tests/test_models_smoke.py``: a reduced config of every
  arch runs ``forward`` (and ``decode_step`` where it has one) on the
  CPU with finite outputs of the right shapes; the full configs' counts
  in the reference's bands.  (Its train-step case is
  ``tests/test_torch_train_step.py``.)
* Baselines (Table IV): counts 12,518 / 1,280 / 960 and init layouts as
  the reference's; the MLP's logits and loss and the LSTM / GRU
  trajectories within 1e-6 of the reference's on its own parameters.
* Engine mirrors: ``admit_policy="all_free"``
  (``tests/test_serve_engine.py``) and quantized against FP serving
  (``tests/test_decode_consistency.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.compress.tree import quantize_tree as j_quantize_tree
from repro.models import baselines as JB
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.models import baselines as B
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.pytree import tree_leaves
from repro_torch.serve.engine import Engine, ServeConfig

ARCHS = list(C.ARCHS)
F32 = dict(compute_dtype="float32", param_dtype="float32")


def spec_layout(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of ``ShapeDtypeStruct``s,
    arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(spec_layout(v, f"{prefix}/{k}"))
        return out
    if tree is None:
        return {prefix: None}
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


def all_meta(tree) -> bool:
    return all(t.is_meta for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Registry: stand-ins and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_cache_match_reference(arch):
    cfg, jcfg = C.get(arch), JC.get(arch)
    cells = 0
    for name, shape in C.SHAPES.items():
        ok = C.applicable(cfg, shape)
        assert ok == JC.applicable(jcfg, JC.SHAPES[name])
        if not ok[0]:
            continue
        cells += 1
        got, want = R.input_specs(cfg, shape), JR.input_specs(
            jcfg, JC.SHAPES[name])
        assert spec_layout(got) == spec_layout(want), name
        cache = R.abstract_cache(cfg, shape)
        assert spec_layout(cache) == spec_layout(
            JR.abstract_cache(jcfg, JC.SHAPES[name])), name
        assert all_meta(got) and all_meta(cache)
        assert R.step_flops_model(cfg, shape) == JR.step_flops_model(
            jcfg, JC.SHAPES[name])
    assert cells == (4 if cfg.uses_mamba else 2 if cfg.is_encoder else 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_counts_match_reference_without_allocating(arch):
    cfg, jcfg = C.get(arch), JC.get(arch)
    ap = R.abstract_params(cfg)
    assert all_meta(ap)
    assert spec_layout(ap) == spec_layout(JR.abstract_params(jcfg))
    assert R.param_count(cfg) == JR.param_count(jcfg)
    assert R.active_param_count(cfg) == JR.active_param_count(jcfg)
    qp, sc = R.abstract_quantized_params(cfg, 16)
    jqp, jsc = JR.abstract_quantized_params(jcfg, 16)
    assert spec_layout(qp) == spec_layout(jqp)
    assert spec_layout(sc) == spec_layout(jsc)
    assert all_meta(qp) and all_meta(sc)


def test_full_config_parameter_counts_sane():
    """Mirror of the reference's bands (billions, from the source
    papers)."""
    expected = {
        "minitron-4b": (3.5, 5.5), "qwen2-1.5b": (1.2, 2.0),
        "deepseek-7b": (6.0, 8.0), "nemotron-4-340b": (300, 380),
        "olmoe-1b-7b": (6.0, 8.0), "moonshot-v1-16b-a3b": (14, 30),
        "internvl2-76b": (65, 80), "zamba2-1.2b": (0.9, 1.6),
        "hubert-xlarge": (0.7, 1.3), "mamba2-780m": (0.6, 1.0),
    }
    assert set(expected) == set(ARCHS)
    for arch, (lo, hi) in expected.items():
        n = R.param_count(C.get(arch)) / 1e9
        assert lo <= n <= hi, (arch, n)


def test_training_half_and_meshes_are_refused(tmp_path):
    """The training half on one device, and every step over a 1 x 1 mesh
    (a one-rank ``gloo`` group): the train, prefill, decode and
    quantized-decode steps give the no-mesh steps' outputs bit for bit
    (split-KV decoding included), Megatron-SP prefill within 1e-5 (the
    flash path's rounding); sequence parallelism and split-KV decoding
    without a mesh are refused."""
    import distharness
    from repro_torch.launch import sharding as S
    from repro_torch.train import optimizer as opt
    from repro_torch.train.optimizer import AdamConfig
    cfg = C.reduced(C.get("qwen2-1.5b"), compute_dtype="float32",
                    param_dtype="float32")
    acfg = AdamConfig(state_dtype="float32")
    assert all_meta(R.abstract_opt(cfg, AdamConfig()))
    for call in (lambda: R.make_train_step(cfg, acfg, seq_parallel=True),
                 lambda: R.make_prefill_step(cfg, seq_parallel=True),
                 lambda: R.make_decode_step(cfg, splitkv=True),
                 lambda: R.make_decode_step_quantized(cfg, splitkv=True)):
        with pytest.raises(ValueError, match="pass mesh="):
            call()
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    tok = batch["tokens"][:, :1]
    with distharness.one_rank_mesh(tmp_path) as mesh:
        outs = []
        for m, sp in ((None, False), (mesh, False), (mesh, True)):
            p = R.init(cfg, torch.Generator().manual_seed(0))
            pre = R.make_prefill_step(cfg, mesh=m, seq_parallel=sp)(
                p, {"tokens": batch["tokens"]})
            logits = pre[0]
            cache = T.prefill(cfg, p, {"tokens": batch["tokens"]},
                              max_len=16)[1]
            dec = R.make_decode_step(cfg, mesh=m, splitkv=m is not None)(
                p, cache, tok)[0]
            if m is not None:
                p = S.distribute(p, S.named(m, S.param_pspecs(p, m)))
            o = opt.init(p, acfg)
            p, o, met = R.make_train_step(cfg, acfg, mesh=m,
                                          seq_parallel=sp)(p, o, batch)
            outs.append((logits, dec, met["loss"]))
        for i, (logits, dec, loss) in enumerate(outs[1:]):
            if i == 0:
                assert torch.equal(logits, outs[0][0])
                assert torch.equal(dec, outs[0][1])
                assert torch.equal(loss, outs[0][2])
            else:
                torch.testing.assert_close(logits, outs[0][0], rtol=0,
                                           atol=1e-5)
                torch.testing.assert_close(loss, outs[0][2], rtol=0,
                                           atol=1e-5)


# ---------------------------------------------------------------------------
# Registry: the serving steps on the reference's trees
# ---------------------------------------------------------------------------

def reference_tree(arch):
    jcfg = JC.reduced(JC.get(arch), **F32)
    cfg = C.reduced(C.get(arch), **F32)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, jp, cfg, np_params, weights.lm_params_from_numpy(
        np_params, "cpu")


def close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_encoder_prefill_step_is_forward():
    """HuBERT's serving entry point: the encoder's prefill is its
    forward, logits only."""
    jcfg, jp, cfg, _, p = reference_tree("hubert-xlarge")
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    want = JR.make_prefill_step(jcfg)(jp, {"frames": jnp.asarray(x)})
    got = R.make_prefill_step(cfg)(p, {"frames": torch.as_tensor(x)})
    assert isinstance(got, torch.Tensor) and got.shape == (2, 40,
                                                          cfg.vocab_size)
    close(got, want)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-1.2b"])
def test_prefill_and_decode_steps_match_reference(arch):
    """A decoder's prefill step gives (logits, cache sized to the prompt);
    the decode step and the quantized decode step (int8 tree, dequantized
    to bfloat16 each call) continue a prefill into a larger cache, against
    the reference's, at the long-context shape (where the hybrid family
    attends through its sliding window)."""
    jcfg, jp, cfg, np_params, p = reference_tree(arch)
    shape, jshape = C.SHAPES["long_500k"], JC.SHAPES["long_500k"]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    want, jcache = JR.make_prefill_step(jcfg, jshape)(
        jp, {"tokens": jnp.asarray(toks[:, :6])})
    got, cache = R.make_prefill_step(cfg, shape)(
        p, {"tokens": torch.as_tensor(toks[:, :6])})
    close(got, want)
    assert cache["len"] == int(jcache["len"]) == 6
    assert cache["k"].shape == jcache["k"].shape
    jq, js = j_quantize_tree(jp, 8)
    q = weights.lm_params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    s = weights.lm_params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstep, step = JR.make_decode_step(jcfg, jshape), R.make_decode_step(
        cfg, shape)
    jqstep = JR.make_decode_step_quantized(jcfg, jshape, bits=8)
    qstep = R.make_decode_step_quantized(cfg, shape, bits=8)
    window = cfg.sliding_window
    caches = []
    for _ in range(2):
        _, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :6])},
                           max_len=16, window=window)
        _, c = T.prefill(cfg, p, {"tokens": torch.as_tensor(toks[:, :6])},
                         max_len=16, window=window)
        caches.append((jc, c))
    (jcache, cache), (jqcache, qcache) = caches
    for t in range(6, 9):
        tok = toks[:, t:t + 1]
        want, jcache = jstep(jp, jcache, jnp.asarray(tok))
        got, cache = step(p, cache, torch.as_tensor(tok))
        close(got, want)
        want, jqcache = jqstep(jq, js, jqcache, jnp.asarray(tok))
        got, qcache = qstep(q, s, qcache, torch.as_tensor(tok))
        close(got, want)


# ---------------------------------------------------------------------------
# Mirror of tests/test_models_smoke.py
# ---------------------------------------------------------------------------

def smoke_batch(cfg, B=2, S=16):
    """The reference test's batch, drawn with its numpy seed."""
    rng = np.random.default_rng(0)
    b = {}
    if cfg.family == "audio":
        b["frames"] = torch.as_tensor(
            rng.normal(size=(B, S, cfg.d_model)), dtype=torch.float32)
    else:
        b["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (B, S)))
    b["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(B, cfg.num_patches, cfg.d_model)),
            dtype=torch.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_shapes(arch):
    cfg = C.reduced(C.get(arch))
    params = T.init(cfg, torch.Generator().manual_seed(1))
    logits, _, _ = T.forward(cfg, params, smoke_batch(cfg))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", [a for a in ARCHS if C.get(a).has_decode])
def test_reduced_decode_step(arch):
    cfg = C.reduced(C.get(arch))
    params = T.init(cfg, torch.Generator().manual_seed(0))
    cache = T.init_cache(cfg, 2, 24, device="cpu")
    logits, cache2 = T.decode_step(cfg, params, cache,
                                   torch.ones((2, 1), dtype=torch.int32))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert cache2["len"] == 1


# ---------------------------------------------------------------------------
# Table IV baselines
# ---------------------------------------------------------------------------

def test_baseline_counts_and_layouts_match_reference():
    assert B.mlp_param_count() == JB.mlp_param_count() == 12_518
    assert B.lstm_param_count() == JB.lstm_param_count() == 1_280
    assert B.gru_param_count() == JB.gru_param_count() == 960
    g = torch.Generator().manual_seed(0)
    for init, jinit, count in ((B.mlp_init, JB.mlp_init, 12_518),
                               (B.lstm_init, JB.lstm_init, 1_280),
                               (B.gru_init, JB.gru_init, 960)):
        p, jp = init(g), jinit(jax.random.PRNGKey(0))
        assert spec_layout(p) == spec_layout(jp)
        assert sum(t.numel() for t in p.values()) == count
        w = p["w1"] if "w1" in p else p["U_r"] if "U_r" in p else p["U_i"]
        assert 0.05 < float(w.std()) < 0.15


def baseline_inputs(seed=6, T_=128, B_=4, d=3, H=16):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T_, B_, d)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B_, H))).astype(np.float32)
    c0 = (0.1 * rng.standard_normal((B_, H))).astype(np.float32)
    labels = rng.integers(0, 6, B_)
    return xs, h0, c0, labels


def carried(jp):
    """The reference's parameters as float32 CPU tensors, with nonzero
    biases so the bias terms count."""
    rng = np.random.default_rng(7)
    out = {}
    for k, v in jp.items():
        v = np.array(v, np.float32)
        if k.startswith("b"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = v
    return out


def test_mlp_matches_reference():
    xs, _, _, labels = baseline_inputs()
    p = carried(JB.mlp_init(jax.random.PRNGKey(1)))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    want = JB.mlp_forward(jp, jnp.asarray(xs))
    got = B.mlp_forward(tp, torch.as_tensor(xs))
    assert got.shape == (4, 6)
    close(got, want, 1e-6)
    want = JB.mlp_loss(jp, jnp.asarray(xs), jnp.asarray(labels))
    got = B.mlp_loss(tp, torch.as_tensor(xs), torch.as_tensor(labels))
    assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_trajectories_match_reference(cell):
    xs, h0, c0, _ = baseline_inputs()
    jinit, jstep = getattr(JB, f"{cell}_init"), getattr(JB, f"{cell}_step")
    step = getattr(B, f"{cell}_step")
    p = carried(jinit(jax.random.PRNGKey(2)))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    if cell == "lstm":
        jc0 = (jnp.asarray(h0), jnp.asarray(c0))
        c0_ = (torch.as_tensor(h0), torch.as_tensor(c0))
    else:
        jc0, c0_ = jnp.asarray(h0), torch.as_tensor(h0)
    want = JB.rnn_run(jstep, jp, jnp.asarray(xs), jc0)
    got = B.rnn_run(step, tp, torch.as_tensor(xs), c0_)
    assert got.shape == (128, 4, 16)
    close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# Engine mirrors
# ---------------------------------------------------------------------------

def engine_setup(arch="deepseek-7b", batch=4, prompt=8):
    jcfg, jp, cfg, np_params, _ = reference_tree(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (batch, prompt))
    return jcfg, jp, cfg, np_params, toks


def test_window_boundary_policy_matches_continuous_tokens():
    """``admit_policy="all_free"`` (the window-boundary baseline) gives the
    continuous engine's tokens and the reference's, with its policy in the
    scheduler's stats."""
    jcfg, jp, cfg, np_params, toks = engine_setup()
    params = weights.lm_params_from_numpy(np_params, "cpu")
    base = Engine(cfg, params, ServeConfig(max_len=32, max_slots=2,
                                           admit_policy="all_free"),
                  device="cpu")
    cont = Engine(cfg, params, ServeConfig(max_len=32, max_slots=2),
                  device="cpu")
    ref = JEngine(jcfg, jp, JServeConfig(max_len=32, max_slots=2,
                                         admit_policy="all_free"))
    got = base.generate(toks, max_new=8)
    np.testing.assert_array_equal(got, cont.generate(toks, max_new=8))
    np.testing.assert_array_equal(got, ref.generate(toks, max_new=8))
    assert base.stats()["scheduler"]["admit_policy"] == "all_free"
    assert base.stats() == ref.stats()


def test_quantized_serving_engine_close_to_fp():
    """FP and int8 serving both run and emit valid tokens of the same
    shape (random-init logits are near-uniform, so the tokens may
    differ), as in the reference."""
    _, _, cfg, np_params, toks = engine_setup(batch=2, prompt=12)
    params = weights.lm_params_from_numpy(np_params, "cpu")
    fp = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
    q8 = Engine(cfg, params, ServeConfig(max_len=32, quant_bits=8),
                device="cpu")
    a = fp.generate(toks[:, :6], max_new=4)
    b = q8.generate(toks[:, :6], max_new=4)
    assert b.shape == a.shape == (2, 4)
    assert (b >= 0).all() and (b < cfg.vocab_size).all()
    assert q8.qparams["lm_head"]["w"].dtype == torch.int8
