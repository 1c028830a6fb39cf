"""The mamba families' full-sequence path over a mesh, on a rank's own
heads (sharding mode None, the reference's FSDP x TP placements), against
the reference.

A prefill over a (2, 4) (data, model) mesh of 8 ``gloo`` ranks
(``tests/distharness.py``) runs each mamba layer on the rank's heads and
channels and the hybrid's shared block on its attention heads, and hands
the mesh decode the rank's blocks of the cache as ``cache_pspecs`` places
them, in mode None and under sequence parallelism (``ssm_seq``); the
decode takes them with no cut by hand.  On a fake 2 x 4 mesh
(``launch.dryrun``) rank 0's training step and prefill in mode None
gather no parameter over ``model``, a mode-None prefill traces with the
SSD scan's work counted, and an ``ssm_seq`` prefill cell runs each mamba
block on the rank's whole span.  Over a (1, 4) mesh of 4 ``gloo`` ranks
a rank's span shorter than the conv halo computes the model's function
(the reference's does not: ROADMAP C9), and a sequence that ``model``
does not divide raises in both packages.  The mode-None training step's
loss and gradients are held in ``tests/test_torch_tensor_parallel.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import distharness as H
import repro.configs as JC
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import mamba2 as S
from repro_torch.models import registry
from repro_torch.pytree import tree_leaves
from test_torch_dryrun import ModelGathers

# a prompt of 16 positions: 4 a rank under ssm_seq (the spans shorter
# than the conv halo of 3 are test_short_spans_compute_the_model's)
PROMPT, DECODE, MAX_LEN = 16, 3, 20

# (arch, overrides): heads that divide ``model`` (8 heads over 4 ranks),
# the same with 2 groups of B and C (each rank's heads in one of them),
# heads that do not while the channels do (2 heads, 128 channels), every
# leaf whole (130 channels, 10 heads), the hybrid's shared block by K/V
# heads (4) and by split-KV (2 KV heads)
CASES = {"mamba2": ("mamba2-780m", {}),
         "mamba2_g2": ("mamba2-780m", {"mamba_groups": 2}),
         "mamba2_h2": ("mamba2-780m", {"mamba_headdim": 64}),
         "mamba2_whole": ("mamba2-780m", {"d_model": 65,
                                          "mamba_headdim": 13}),
         "zamba2_kv4": ("zamba2-1.2b", {"num_kv_heads": 4}),
         "zamba2_kv2": ("zamba2-1.2b", {"num_kv_heads": 2})}
CHAINS = [(name, False) for name in CASES] + [
    (name, True) for name in ("mamba2", "zamba2_kv4", "zamba2_kv2")]


@pytest.fixture(autouse=True)
def no_process_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def reference_params(arch, **over):
    jcfg = JC.reduced(JC.get(arch), **H.F32, **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def reference_chain(jcfg, jp, prompt, toks):
    """The reference's ``prefill`` logits and ``decode_step`` logits
    (rows x steps x vocab) over a cache of MAX_LEN positions."""
    logits, cache = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)},
                               max_len=MAX_LEN)
    steps = []
    for t in range(toks.shape[1]):
        lg, cache = JT.decode_step(jcfg, jp, cache,
                                   jnp.asarray(toks[:, t:t + 1]))
        steps.append(np.asarray(lg[:, 0]))
    return np.asarray(logits), np.stack(steps, 1)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Every chain of CHAINS from one 8-rank spawn, and the reference's
    logits for each case."""
    cases, want = {}, {}
    rng = np.random.default_rng(11)
    for name, (arch, over) in CASES.items():
        jcfg, jp, npp = reference_params(arch, **over)
        prompt = rng.integers(0, jcfg.vocab_size, (4, PROMPT)).astype(
            np.int32)
        toks = rng.integers(0, jcfg.vocab_size, (4, DECODE)).astype(np.int32)
        want[name] = reference_chain(jcfg, jp, prompt, toks)
        for chain, seqp in CHAINS:
            if chain == name:
                cases[(name, seqp)] = ("chain", arch, over,
                                       (npp, prompt, toks, seqp, MAX_LEN))
    got = H.run(H.tensor_parallel, 8, tmp_path_factory.mktemp("mm"), cases)
    return want, got


@pytest.mark.parametrize("name, seqp", CHAINS)
def test_mesh_prefill_hands_the_mesh_decode_its_cache(chains, name, seqp):
    """``make_prefill_step`` over the mesh, then three
    ``make_decode_step`` steps over the same mesh on the cache it
    returned, in mode None (``seqp`` False: each mamba layer on the
    rank's heads, or on its channels with every head where the heads do
    not divide, or whole) and under ``ssm_seq``: the prefill's logits
    within 1e-5 of the no-mesh prefill's block and 1e-3 of the
    reference's ``prefill``; each cache leaf (the SSM state's heads, the
    conv tails, the shared block's K/V) within 1e-5 of its block of the
    no-mesh prefill's cache under ``cache_pspecs``; each decode step's
    logits within 1e-3 of the reference's ``prefill`` + ``decode_step``
    on the same rows."""
    want, ranks = chains
    ref_logits, ref_steps = want[name]
    vocab = ref_logits.shape[-1]
    for rank, (out, rows) in enumerate(ranks):
        logits, alone, blocks, steps, fill = out[(name, seqp)]
        assert fill == PROMPT + DECODE and blocks
        ref = ref_logits[rows]
        if not seqp:                 # logits_pspec: the rank's vocab block
            n = vocab // 4
            ref = ref[..., (rank % 4) * n:(rank % 4 + 1) * n]
        assert logits.shape == alone.shape == ref.shape
        np.testing.assert_allclose(logits, alone, rtol=1e-5, atol=1e-5)
        assert np.abs(logits - ref).max() < 1e-3
        for got, want_block in blocks:
            assert got.shape == want_block.shape
            np.testing.assert_allclose(got, want_block, rtol=1e-5, atol=1e-5)
        assert steps.shape == ref_steps[rows].shape
        assert np.abs(steps - ref_steps[rows]).max() < 1e-3


def cache_shapes(cfg, mesh, b):
    """Each cache leaf's block shape under ``cache_pspecs`` (the decode's
    placement of a MAX_LEN-position cache of ``b`` rows), by key."""
    shape = ShapeConfig("decode_32k", MAX_LEN, b, "decode")
    acache = registry.abstract_cache(cfg, shape)
    specs = sh.cache_pspecs(cfg, shape, mesh, acache)
    return {k: [D._local_shape(t.shape, s, mesh) for t, s in zip(
        tree_leaves(acache[k]), tree_leaves(specs[k]))]
        for k in acache if k != "len"}


@pytest.fixture
def fake_mesh():
    D.fake_group(8)
    return make_host_mesh(data=2, model=4)


GATHER_CASES = [c for c in CASES if c not in ("mamba2_g2", "mamba2_whole")]


@pytest.mark.parametrize("name", GATHER_CASES)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_mode_none_gathers_no_parameter_over_model(fake_mesh, name, kind,
                                                   monkeypatch):
    """Rank 0's collective log of one mode-None training step and one
    mode-None prefill (``REPRO_NO_SEQP=1``) of a reduced mamba family on
    a fake 2 x 4 mesh, the parameters DTensors placed by
    ``param_pspecs``: no all-gather over ``model`` takes a parameter's
    storage (the mamba layers compute on the rank's heads and channels;
    only activations cross ``model``), while the norm's and
    ``out_proj``'s sums do cross it; the hybrid's shared block gathers
    its weights' ``data`` dims at use.  A prefill's cache leaves come
    back as the decode's ``cache_pspecs`` blocks."""
    monkeypatch.setenv("REPRO_NO_SEQP", "1")
    arch, over = CASES[name]
    cfg = C.reduced(C.get(arch), **H.F32, **over)
    mesh = fake_mesh
    shape = (ShapeConfig("train_4k", 16, 4, "train") if kind == "train"
             else ShapeConfig("prefill_32k", PROMPT, 4, "prefill"))
    assert sh.parallel_mode(cfg, shape, mesh) is None
    params = registry.init(cfg, torch.Generator().manual_seed(0))
    params = sh.distribute(params, sh.named(mesh, sh.param_pspecs(
        params, mesh, cfg=cfg)))
    leaves = [t.to_local() for t in tree_leaves(params)]
    toks = torch.zeros((4, shape.seq_len), dtype=torch.int32)
    if kind == "train":
        from repro_torch.train import optimizer as opt
        acfg = opt.AdamConfig(state_dtype="float32")
        step = registry.make_train_step(cfg, acfg, mesh=mesh)
        args = (params, opt.init(params, acfg),
                {"tokens": toks, "labels": toks})
    else:
        step = registry.make_prefill_step(cfg, shape, mesh=mesh)
        args = (params, {"tokens": toks[:2]}, MAX_LEN)
    with ModelGathers(mesh, leaves) as counter:
        out = step(*args)
    log = list(zip(counter.log, counter.of_leaf))
    assert [c for c, leaf in log if leaf and c[:2] == ("all-gather",
                                                        "model")] == []
    assert ("all-reduce", "model") in {c[:2] for c, _ in log}
    data_gathers = [leaf for c, leaf in log if c[:2] == ("all-gather",
                                                          "data")]
    assert all(data_gathers)
    assert bool(data_gathers) is (cfg.family == "hybrid")
    if kind == "prefill":
        cache = out[1]
        got = {k: [tuple(t.shape) for t in tree_leaves(v)]
               for k, v in cache.items() if k != "len"}
        assert got == cache_shapes(cfg, mesh, 4)


def test_mode_none_prefill_traces_with_the_scan_counted(fake_mesh,
                                                        monkeypatch):
    """A reduced mamba2-780m ``prefill_32k``-kind cell under
    ``REPRO_NO_SEQP=1`` traces on the fake 2 x 4 mesh as rank 0 on
    ``meta`` stand-ins (the SSD scan kernel's wrapper answers a ``meta``
    input through its plain version's ops), and the traced FLOPs count
    the scan: the wrapper alone on ``meta`` stand-ins at the rank's head
    count counts what ``FlopCounterMode`` counts of the plain version on
    CPU tensors of those shapes, more than zero."""
    from torch.utils.flop_counter import FlopCounterMode
    monkeypatch.setenv("REPRO_NO_SEQP", "1")
    cfg = C.reduced(C.get("mamba2-780m"), **H.F32)
    shape = ShapeConfig("prefill_32k", 64, 4, "prefill")
    step, args, _ = D.build_cell("mamba2-780m", "prefill_32k", fake_mesh,
                                 cfg=cfg, shape=shape)
    tracer, _ = D.trace_step(step, args, fake_mesh)
    b, s, h, p, n = 2, 64, 2, cfg.mamba_headdim, cfg.ssm_state

    def inputs(device):
        return [torch.zeros(sz, device=device) for sz in (
            (b, s, h, p), (b, s, h), (h,), (b, s, 1, n), (b, s, 1, n))]
    scan = D.StepTracer()
    with scan:
        y, state = ssd_ops.ssd_scan(*inputs("meta"), chunk=cfg.ssd_chunk)
    assert (y.device.type, y.shape, state.shape) == (
        "meta", (b, s, h, p), (b, h, n, p))
    plain = FlopCounterMode(display=False)
    with plain:
        ssd_ops.ssd_scan(*inputs("cpu"), chunk=cfg.ssd_chunk)
    assert scan.flops == plain.get_total_flops() > 0
    # the scan of every layer on the rank's 2 heads and 2 rows is traced
    assert tracer.flops > cfg.num_layers * scan.flops


def test_kernel_wrapper_meta_branch_has_no_storage():
    """On ``meta`` inputs the SSD scan wrapper counts no launch and
    returns ``meta`` outputs of the kernel's shapes and dtypes; on CPU
    inputs it gives the plain version as before."""
    torch.manual_seed(0)
    x, B, C_ = (torch.randn(2, 40, k) for k in (4, 3, 3))
    dt = torch.rand(2, 40, 1)
    A = -torch.rand(2, 1)
    before = K.SSDScan.launches
    meta = K.SSDScan()(*(t.to("meta") for t in (x, dt, A, B, C_)), chunk=16)
    cpu = K.SSDScan()(x, dt, A, B, C_, chunk=16)
    assert K.SSDScan.launches == before
    for m, c in zip(meta, cpu):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (c.shape, c.dtype)
    want = K.plain(x, dt, A, B, C_, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(cpu, want))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_seq_prefill_cell_traces_the_rank_span(fake_mesh, arch,
                                                   monkeypatch):
    """A reduced ``prefill_32k``-kind cell (64 tokens, batch 4) under
    ``ssm_seq``, built by ``build_cell`` and traced on the fake 2 x 4 mesh
    as rank 0: every ``mamba_apply_seq`` receives the rank's 2 rows over
    its span of 64 / 4 = 16 positions (the step gets the rows with the
    whole sequence and cuts the span once), and the step's logits cover
    all 64 positions.  ``argument_bytes`` count the reference's
    ``in_shardings`` blocks, the span."""
    cfg = C.reduced(C.get(arch), **H.F32)
    shape = ShapeConfig("prefill_32k", 64, 4, "prefill")
    assert sh.parallel_mode(cfg, shape, fake_mesh) == "ssm_seq"
    seen = []

    def spy(p, xin, *a, **kw):
        seen.append(tuple(xin.shape))
        return apply_seq(p, xin, *a, **kw)
    apply_seq = S.mamba_apply_seq
    monkeypatch.setattr(S, "mamba_apply_seq", spy)
    step, args, arg_bytes = D.build_cell(arch, "prefill_32k", fake_mesh,
                                         cfg=cfg, shape=shape)
    assert tuple(args[1]["tokens"].shape) == (2, 64)
    logits = []

    def traced(*a):
        out = step(*a)
        logits.append(tuple(out[0].shape))
        return out
    D.trace_step(traced, args, fake_mesh)
    assert seen == [(2, 16, cfg.d_model)] * cfg.num_layers
    assert logits == [(2, 64, cfg.vocab_size)]
    params = registry.abstract_params(cfg)
    want = D._local_bytes(params, sh.param_pspecs(
        params, fake_mesh, mode="ssm_seq", cfg=cfg), fake_mesh) + 2 * 16 * 4
    assert arg_bytes == want


SPANS = (1, 2, 3, 4)        # a rank's span over ``model`` = 4
SPAN_ARCHS = ("mamba2-780m", "zamba2-1.2b")
RAGGED_ARCHS = ("deepseek-7b", "mamba2-780m", "zamba2-1.2b")


def span_case(jcfg, jp, rng, span):
    """(prompt (2, 4 x span), 3 decode tokens, cache length) and the
    reference's plain ``forward`` logits over the prompt and the tokens."""
    prompt = rng.integers(0, jcfg.vocab_size, (2, 4 * span)).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (2, DECODE)).astype(np.int32)
    seq = jnp.asarray(np.concatenate([prompt, toks], 1))
    full = np.asarray(JT.forward(jcfg, jp, {"tokens": seq})[0])
    return (prompt, toks, 4 * span + 4), full


@pytest.fixture(scope="module")
def short_spans(tmp_path_factory):
    """One 4-rank spawn (``H.short_spans``): every span of SPANS for each
    arch of SPAN_ARCHS, and a 14-token batch for each of RAGGED_ARCHS;
    beside it, the reference's own results on a (1, 4) mesh of host
    devices in this process."""
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    spans, ragged, ref = [], [], {}
    rng = np.random.default_rng(23)
    for arch in SPAN_ARCHS:
        jcfg, jp, npp = reference_params(arch)
        fwd = jax.jit(lambda p, b, jcfg=jcfg: JT.forward(
            jcfg, p, b, mesh=mesh, seq_parallel=True)[0])
        cases = []
        for span in SPANS:
            case, full = span_case(jcfg, jp, rng, span)
            b = {"tokens": jnp.asarray(case[0])}
            ref[(arch, span)] = (np.asarray(fwd(jp, b)),
                                 np.asarray(JT.forward(jcfg, jp, b)[0]), full)
            cases.append(case)
        spans.append((arch, npp, cases))
    for arch in RAGGED_ARCHS:
        jcfg, jp, npp = reference_params(arch)
        toks = rng.integers(0, jcfg.vocab_size, (2, 14)).astype(np.int32)
        ragged.append((arch, npp, {"tokens": toks, "labels": toks}))
        try:
            jax.jit(lambda p, b, jcfg=jcfg: JT.forward(
                jcfg, p, b, mesh=mesh, seq_parallel=True)[0])(
                jp, {"tokens": jnp.asarray(toks)})
            ref[arch] = None
        except ValueError as e:
            ref[arch] = str(e)
    got = H.run(H.short_spans, 4, tmp_path_factory.mktemp("spans"), spans,
                ragged)
    return ref, got


@pytest.mark.parametrize("arch", SPAN_ARCHS)
def test_short_spans_compute_the_model(short_spans, arch):
    """A rank's span of 1, 2, 3 and 4 positions over ``model`` = 4, reduced
    ``arch`` in float32 from the reference's init.  The port's
    sequence-parallel ``forward`` is within 1e-5 of its no-mesh
    ``forward`` at every span; the sequence-parallel prefill's cache
    blocks (the global conv tails, SSM states and shared-block K/V)
    within 1e-5 of the no-mesh prefill's; three mesh decode steps after
    it within 1e-3 of the reference's ``forward`` over the prompt and the
    tokens; the sequence-parallel ``train_loss``'s gradient, summed over
    the ranks, within 1e-4 x max|g| of the no-mesh one, leaf by leaf.
    The reference's jitted sequence-parallel ``forward`` takes a rank's
    conv context from its predecessor's span alone (ROADMAP C9):
    at spans 1 and 2 it differs from its own plain ``forward`` by more
    than 1e-2 from the first position whose halo reaches back past the
    predecessor (2 and 4), and agrees within 1e-5 before it; at spans 3
    and 4 it is within 1e-5 of the port's."""
    ref, ranks = short_spans
    for span in SPANS:
        ref_sp, ref_plain, full = ref[(arch, span)]
        s = 4 * span
        first = {1: 2, 2: 4}.get(span)
        err = np.abs(ref_sp - ref_plain).max(axis=(0, 2))
        if first is None:
            assert err.max() < 1e-5, (span, err)
        else:
            assert err[:first].max() < 1e-5, (span, err)
            assert err[first:].max() > 1e-2, (span, err)
        for out, _ in ranks:
            sp, plain, (logits, alone, blocks, steps, fill), grads = \
                out[arch][span - 1]
            np.testing.assert_allclose(sp, plain, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(logits, alone, rtol=1e-5, atol=1e-5)
            if first is None:
                np.testing.assert_allclose(sp, ref_sp, rtol=1e-5,
                                           atol=1e-5)
            for got, want in blocks:
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            assert fill == s + DECODE
            assert np.abs(steps - full[:, s:]).max() < 1e-3
            for g, want in zip(*grads):
                assert np.abs(g - want).max() <= 1e-4 * max(
                    np.abs(want).max(), 1e-6), span


@pytest.mark.parametrize("arch", RAGGED_ARCHS)
def test_sequence_model_does_not_divide_raises(short_spans, arch):
    """A 14-token batch over ``model`` = 4: the port's ``forward``,
    ``prefill`` and ``train_loss`` under ``seq_parallel=True`` each raise
    ``ValueError`` naming the length and the axis size, on every rank
    (no truncated result), as the reference's jitted ``forward`` raises
    from its ``shard_map``."""
    ref, ranks = short_spans
    assert ref[arch] is not None and "not evenly divisible" in ref[arch]
    for _, raised in ranks:
        for entry in ("forward", "prefill", "train_loss"):
            kind, msg = raised[(arch, entry)]
            assert kind == "ValueError", (entry, kind, msg)
            assert "14" in msg and "size 4" in msg
