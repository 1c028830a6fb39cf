"""The port's dry-run (``launch/dryrun.py``) against the reference's
(``repro.launch.dryrun``), on the CPU, with nothing model-sized allocated.

Every (arch x shape x mesh) cell's status, skip reason and sharding mode
equal the reference's on a ``jax.sharding.AbstractMesh`` (nothing traced).
Five cells are traced as rank 0 of a fake process group: their analytic
cost equals the reference's ``cell_cost``, and their argument bytes equal
the reference's shard-shape sum over the same specs.  The tracer's FLOPs
and peak bytes equal ``FlopCounterMode``'s and ``MemTracker``'s; the
collectives counted on a fake 2 x 4 mesh equal those of the same step run
for real over 8 ``gloo`` ranks (``tests/distharness.py``); nemotron-4-340b's
training step, on a rank's blocks, is traced without being allocated and
fits the card.  A decode over a cache split on ``model`` (the attention,
mamba and hybrid families, float and int8) gives each rank the
reference's logits and the no-mesh decode's cache blocks, and gathers no
parameter or cache leaf over ``model``."""
import json
import math
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import distharness as H
import repro.configs as JC
from repro.compress import tree as JQ
from repro.launch import analytic as JA
from repro.launch import sharding as JS
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.train.optimizer import AdamConfig as JAdam
from repro_torch import configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamConfig

ALL_CELLS = [(a, s, m) for a in JC.ARCHS for s in JC.SHAPES
             for m in (False, True)]


@pytest.fixture(autouse=True)
def no_process_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def abstract_mesh(multi_pod: bool) -> AbstractMesh:
    return (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))


@pytest.mark.parametrize("arch, shape, multi_pod", ALL_CELLS)
def test_cell_status_and_mode_equal_reference(arch, shape, multi_pod):
    """Skipped cells and their reasons, and each run cell's sharding mode,
    as the reference decides them (``applicable``, ``parallel_mode``)."""
    got = D.plan_cell(arch, shape, multi_pod)
    jcfg, jshape = JC.get(arch), JC.SHAPES[shape]
    ok, reason = JC.applicable(jcfg, jshape)
    assert got["mesh"] == ("2x16x16" if multi_pod else "16x16")
    if not ok:
        assert got == {"arch": arch, "shape": shape, "mesh": got["mesh"],
                       "status": "skipped", "reason": reason}
    else:
        assert "status" not in got
        assert got["parallel_mode"] == JS.parallel_mode(
            jcfg, jshape, abstract_mesh(multi_pod))


def reference_argument_bytes(arch, shape, multi_pod, quant_bits) -> int:
    """The reference's argument bytes per device, without compiling: the
    sum over its step's input leaves of the shard shape under its specs
    (``NamedSharding(AbstractMesh, spec).shard_shape``) times the item
    size."""
    jcfg, jshape = JC.get(arch), JC.SHAPES[shape]
    mesh = abstract_mesh(multi_pod)
    mode = JS.parallel_mode(jcfg, jshape, mesh)
    batch = JR.input_specs(jcfg, jshape)
    bspecs = JS.batch_pspecs(jcfg, jshape, mesh, seq_parallel=mode is not None)
    ap = JR.abstract_params(jcfg)
    ps = JS.param_pspecs(ap, mesh, mode=mode, cfg=jcfg)

    def nbytes(tree, specs):
        leaves = jax.tree.leaves(tree)
        sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(sp)
        return sum(math.prod(NamedSharding(mesh, s).shard_shape(t.shape))
                   * t.dtype.itemsize for t, s in zip(leaves, sp))
    if jshape.kind == "train":
        aopt = JR.abstract_opt(jcfg, JAdam(state_dtype=jcfg.opt_state_dtype))
        return (nbytes(ap, ps) + nbytes(aopt, JS.opt_pspecs(aopt, ps))
                + sum(nbytes(batch[k], bspecs[k]) for k in batch))
    acache = JR.abstract_cache(jcfg, jshape)
    out = (nbytes(acache, JS.cache_pspecs(jcfg, jshape, mesh, acache))
           + nbytes(batch["tokens"], bspecs["tokens"]))
    if quant_bits:
        qp, scales = JR.abstract_quantized_params(jcfg, quant_bits)
        return out + nbytes(qp, ps) + nbytes(
            scales, jax.tree.map(lambda _: JP(), scales))
    return out + nbytes(ap, ps)


TRACED = [("qwen2-1.5b", "train_4k", False, 0),
          ("mamba2-780m", "long_500k", True, 0),
          ("qwen2-1.5b", "decode_32k", False, 0),      # split-KV
          ("qwen2-1.5b", "decode_32k", True, 8),       # REPRO_SERVE_QUANT=8
          ("mamba2-780m", "train_4k", False, 0)]       # ssm_seq


@pytest.mark.parametrize("arch, shape, multi_pod, bits", TRACED)
def test_traced_cell_matches_reference(arch, shape, multi_pod, bits,
                                       monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_QUANT", str(bits))
    rec = D.run_cell(arch, shape, multi_pod)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == (512 if multi_pod else 256)
    jcfg, jshape = JC.get(arch), JC.SHAPES[shape]
    if shape == "decode_32k" and not multi_pod:
        assert JS.use_splitkv(jcfg, jshape, abstract_mesh(False))
    n = JR.param_count(jcfg)
    assert rec["n_params"] == n
    cost = JA.cell_cost(jcfg, jshape, n_params=n,
                        batch_shards=32 if multi_pod else 16,
                        weight_quant_bits=bits)
    assert rec["analytic"] == {
        "flops_fwd_global": cost.flops_fwd,
        "flops_total_global": cost.flops_total,
        "weight_bytes_per_pass": cost.weight_bytes_per_pass,
        "act_bytes": cost.act_bytes, "cache_bytes": cost.cache_bytes,
        "opt_bytes": cost.opt_bytes, "notes": cost.notes}
    assert rec["memory"]["argument_bytes"] == reference_argument_bytes(
        arch, shape, multi_pod, bits)
    # the roofline's collective term is the counted bytes
    total = sum(rec["collective_bytes_by_kind"].values())
    assert total > 0 and rec["collective_bytes_per_device"] == total
    assert rec["roofline"]["t_collective_s"] == total / RL.NVLINK_BYTES_PER_S
    assert set(rec["collective_counts"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["fits_hbm"] is (rec["memory"]["peak_bytes"] <= RL.HBM_BYTES)
    assert rec["traced"]["flops_per_device"] > 0
    json.dumps(rec)


def meta_train_args(cfg, acfg):
    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    p = tree_map(meta, registry.abstract_params(cfg))
    o = tree_map(meta, registry.abstract_opt(cfg, acfg))
    b = {k: torch.empty((4, 32), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}
    return p, o, b


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_tracer_counts_equal_flop_counter_and_mem_tracker(arch):
    """The one-pass tracer's FLOPs and peak bytes equal those of
    ``FlopCounterMode`` and ``MemTracker`` stacked over the same step."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    cfg = C.reduced(C.get(arch), **H.F32)
    acfg = AdamConfig()
    step = registry.make_train_step(cfg, acfg)
    tracer, _ = D.trace_step(step, meta_train_args(cfg, acfg), None)
    args = meta_train_args(cfg, acfg)
    flops, mem = FlopCounterMode(display=False), MemTracker()
    mem.track_external(*[t for a in args for t in tree_leaves(a)])
    with torch.device("meta"), mem, flops:
        step(*args)
    assert tracer.flops == flops.get_total_flops() > 0
    assert {"meta": tracer.peak_bytes} == {
        str(k): v["Total"] for k, v in mem.get_tracker_snapshot("peak")
        .items()}


def test_fake_mesh_collectives_equal_gloo(tmp_path):
    """A reduced qwen2 ``train_4k`` step (Megatron-SP at model 4) counts
    the same collectives, in the same order, with the same operand bytes,
    as rank 0 of a fake 2 x 4 mesh as on 8 real ``gloo`` ranks."""
    arch, seq, batch = "qwen2-1.5b", 32, 8
    cfg = C.reduced(C.get(arch), **H.F32)
    shape = ShapeConfig("train_4k", seq, batch, "train")
    D.fake_group(8)
    mesh = make_host_mesh(data=2, model=4)
    step, args, _ = D.build_cell(arch, "train_4k", mesh, cfg=cfg,
                                 shape=shape)
    tracer, _ = D.trace_step(step, args, mesh)
    dist.destroy_process_group()
    real = H.run(H.collectives, 8, tmp_path, arch, seq, batch)[0]
    kinds = {k for k, _, _ in tracer.log}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    assert tracer.log == real


def test_nemotron_training_step_is_traced_not_allocated():
    """nemotron-4-340b ``train_4k`` at 16 x 16: a rank holds only its
    blocks of the float32 weights, Adam moments and gradients (~16 GB),
    gathers each layer's weights over ``data`` inside the layer, and fits
    the card's 80 GiB; the step is traced with no model-sized
    allocation."""
    rec = D.run_cell("nemotron-4-340b", "train_4k", False)
    assert rec["status"] == "ok", rec.get("traceback")
    peak = rec["memory"]["peak_bytes"]
    assert peak <= RL.HBM_BYTES
    assert rec["fits_hbm"] is True
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    assert rss < peak / 100


def test_cli_writes_records_and_collective_log(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "LOG_DIR", str(tmp_path / "log"))
    out = tmp_path / "d.jsonl"
    assert D.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                   "--both-meshes", "--out", str(out), "--keep-hlo"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" for r in recs)
    for r in recs:
        lines = open(r["collective_log_path"]).read().splitlines()
        assert len(lines) == sum(r["collective_counts"].values())
        kind, axis, nbytes = lines[0].split()
        assert kind in r["collective_counts"] and axis in ("data", "model",
                                                            "pod")
        assert int(nbytes) > 0
    assert not dist.is_initialized()


def test_cli_exits_nonzero_on_an_error_cell(tmp_path, monkeypatch):
    def broken(arch, shape, multi_pod, keep_hlo=False):
        return {"arch": arch, "shape": shape, "status": "error",
                "error": "RuntimeError: boom"}
    monkeypatch.setattr(D, "run_cell", broken)
    assert D.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                   "--out", str(tmp_path / "d.jsonl")]) == 1


def reference_params(arch, **over):
    """The reduced float32 config and the reference's own init, as
    ``test_torch_distributed`` draws them."""
    jcfg = JC.reduced(JC.get(arch), **H.F32, **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("arch, over", [
    ("mamba2-780m", {}),                                # SSM state, conv tail
    ("deepseek-7b", {"num_heads": 4, "num_kv_heads": 4}),   # K/V by heads
    ("zamba2-1.2b", {"num_kv_heads": 4}),       # shared block's K/V by heads
    ("zamba2-1.2b", {"num_kv_heads": 2}),       # shared block by split-KV
    ("mamba2-780m", {"mamba_headdim": 64}),     # 2 heads: channels split
    ("mamba2-780m", {"d_model": 65, "mamba_headdim": 13}),  # all whole
])
def test_mesh_decode_over_a_model_sharded_cache(arch, over, tmp_path):
    """A decode over a cache whose blocks are split over ``model``
    (``cache_pspecs``), from the reference's weights, each rank on its
    blocks of the parameters: the mamba layers on the rank's heads (or,
    at 2 heads over 4 ranks, on its channels with every head's state; at
    130 channels every leaf whole), the hybrid's shared block on its
    heads by K/V heads or over its span of a split-KV cache.  Each rank
    gets the reference's ``prefill`` + ``decode_step`` logits for its
    rows within 1e-3 (``test_torch_distributed``'s decode tolerance),
    and, within 1e-5, the port's no-mesh decode's logits and its block of
    the no-mesh cache."""
    mesh_decode_against_reference(arch, over, 0, tmp_path)


def test_mesh_decode_quantized_over_a_model_sharded_cache(tmp_path):
    """As :func:`test_mesh_decode_over_a_model_sharded_cache` through
    ``make_decode_step_quantized`` over int8 weights (the reference's
    ``quantize_tree``), reduced zamba2 by split-KV: each rank dequantizes
    its blocks; the reference decodes its dequantized tree."""
    mesh_decode_against_reference("zamba2-1.2b", {"num_kv_heads": 2}, 8,
                                  tmp_path)


def mesh_decode_against_reference(arch, over, bits, tmp_path):
    jcfg, jp, np_params = reference_params(arch, **over)
    if bits:
        q, s = JQ.quantize_tree(jp, bits)
        jp = JQ.dequantize_tree(q, s)
        np_params = tuple(jax.tree.map(np.asarray, t) for t in (q, s))
    rng = np.random.default_rng(1)
    prompt, toks = (rng.integers(0, jcfg.vocab_size, (4, n)).astype(np.int32)
                    for n in (6, 3))
    _, cache = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)},
                          max_len=16)
    want = []
    for t in range(toks.shape[1]):
        lg, cache = JT.decode_step(jcfg, jp, cache,
                                   jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg))
    for rows, logits, blocks, same_len in H.run(
            H.cache_decode, 8, tmp_path, np_params, arch, over, prompt,
            toks, bits):
        assert same_len and len(logits) == 3 and blocks
        for (got, alone), ref in zip(logits, want):
            assert got.shape == ref[rows].shape
            assert np.abs(got - ref[rows]).max() < 1e-3
        for got, want_block in logits + blocks:
            assert got.shape == want_block.shape
            np.testing.assert_allclose(got, want_block, rtol=1e-5, atol=1e-5)


class ModelGathers(D.CollectiveCounter):
    """:class:`~repro_torch.launch.dryrun.CollectiveCounter` that also
    keeps, for each collective, whether its operand lies in the storage of
    one of ``leaves``."""

    def __init__(self, mesh, leaves):
        super().__init__(mesh)
        self.ptrs = {t.untyped_storage().data_ptr() for t in leaves}
        self.of_leaf: list[bool] = []

    def _collective(self, func, args) -> None:
        n = len(self.log)
        super()._collective(func, args)
        if len(self.log) > n:
            operand = args[D._OPS[func._opname][1]]
            self.of_leaf.append(any(t.untyped_storage().data_ptr()
                                    in self.ptrs for t in _tensors(operand)))


def _tensors(x):
    """The tensors of a collective's operand (a tensor or nested lists)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)


@pytest.mark.parametrize("arch, over", [
    ("mamba2-780m", {}),
    ("mamba2-780m", {"mamba_headdim": 64}),
    ("zamba2-1.2b", {"num_kv_heads": 4}),
    ("zamba2-1.2b", {"num_kv_heads": 2}),
])
def test_mesh_decode_gathers_no_parameter_or_cache_leaf_over_model(arch,
                                                                  over):
    """Rank 0's collective log of one decode step of a reduced mamba
    family on a fake 2 x 4 mesh, the parameters DTensors placed by
    ``param_pspecs`` and the cache the rank's blocks under
    ``cache_pspecs``: no all-gather over ``model`` takes a parameter's or
    a cache leaf's storage (only activations cross ``model``: the mamba
    norm's and projections' sums, the logits' vocab blocks, split-KV's
    one token), while the hybrid's shared block still gathers its
    weights' ``data`` dims at use."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import transformer as T
    cfg = C.reduced(C.get(arch), **H.F32, **over)
    shape = ShapeConfig("decode_32k", 16, 4, "decode")
    D.fake_group(8)
    mesh = make_host_mesh(data=2, model=4)
    params = registry.init(cfg, torch.Generator().manual_seed(0))
    params = sh.distribute(params, sh.named(mesh, sh.param_pspecs(
        params, mesh, cfg=cfg)))
    cspecs = sh.cache_pspecs(cfg, shape, mesh,
                             registry.abstract_cache(cfg, shape))
    whole = T.init_cache(cfg, 4, 16, dtype=torch.float32, device="cpu")
    cache = {k: v if k == "len" else tree_map(
        lambda t, s: sh.local_block(t, mesh, s).clone(), v, cspecs[k])
        for k, v in whole.items()}
    cache["len"] = 6
    toks = torch.zeros((2, 1), dtype=torch.int32)
    splitkv = sh.use_splitkv(cfg, shape, mesh)
    step = registry.make_decode_step(cfg, shape, mesh=mesh, splitkv=splitkv)
    leaves = [t.to_local() for t in tree_leaves(params)] + [
        t for t in tree_leaves({k: v for k, v in cache.items()
                                if k != "len"})]
    with torch.no_grad(), ModelGathers(mesh, leaves) as counter:
        step(params, cache, toks)
    assert splitkv is (over.get("num_kv_heads") == 2)
    log = list(zip(counter.log, counter.of_leaf))
    assert [c for c, leaf in log if leaf and c[:2] == ("all-gather",
                                                        "model")] == []
    assert ("all-reduce", "model") in {c[:2] for c, _ in log}
    data_gathers = [leaf for c, leaf in log if c[:2] == ("all-gather",
                                                          "data")]
    assert all(data_gathers)
    assert bool(data_gathers) is (cfg.family == "hybrid")
