"""Spawned ``gloo`` process groups for the port's distributed tests (not a
test module), and the body each rank runs.

``run(body, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), each joining a ``gloo`` group through a
``file://`` rendezvous in ``tmp_path`` (so that parallel test workers
never race for a port) with one intra-op thread, and calls
``body(rank, world, tmp_path, *args)``; each rank's return value comes
back through a file.  The whole run has ``TIMEOUT_S``: a hung collective
fails its test and takes no more of the suite's clock.  The bodies
import only ``torch`` and ``repro_torch``: the spawned processes start
from a fresh import of this module.
"""
import contextlib
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 180
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _entry(rank, world, tmp, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = body(rank, world, tmp, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run(body, world: int, tmp_path, *args) -> list:
    """``body`` on ``world`` ranks; returns each rank's result, in rank
    order.  Raises ``AssertionError`` with the failing ranks' tracebacks,
    or after TIMEOUT_S with every process stopped."""
    tmp = str(tmp_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, tmp, body, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errs = [open(f"{tmp}/rank{r}.err").read() for r in range(world)
            if os.path.exists(f"{tmp}/rank{r}.err")]
    assert not hung, f"ranks {hung} still running after {TIMEOUT_S} s"
    assert not errs and all(p.exitcode == 0 for p in procs), \
        "\n".join(errs) or [p.exitcode for p in procs]
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A ``gloo`` group of this process alone (a ``file://`` rendezvous in
    ``tmp_path``) and its 1 x 1 (data, model) mesh, torn down after."""
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/one",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _full_tree(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.pytree import tree_map
    return tree_map(lambda t: _np(t.full_tensor() if isinstance(t, DTensor)
                                  else t), tree)


def _mesh(*shape, names=None):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def sharded_step(rank, world, tmp, np_params, batch, arch, over, modes):
    """One ``make_train_step`` step over a (4, 2) mesh from the given
    parameters, for each (seq_parallel, sharding mode) of ``modes``.
    Returns [(full parameters, loss, grad_norm)] per mode."""
    from repro_torch import configs as C
    from repro_torch import weights
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt
    cfg = C.reduced(C.get(arch), **F32, **over)
    acfg = opt.AdamConfig(state_dtype="float32")
    mesh = make_host_mesh(data=4, model=2)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for seq_parallel, mode in modes:
        params = weights.lm_params_from_numpy(np_params, "cpu")
        pspecs = sh.param_pspecs(params, mesh, mode=mode, cfg=cfg)
        p = sh.distribute(params, sh.named(mesh, pspecs))
        o = opt.init(p, acfg)
        step = registry.make_train_step(cfg, acfg, mesh=mesh,
                                        seq_parallel=seq_parallel)
        p, o, m = step(p, o, b)
        out.append((_full_tree(p), float(m["loss"]), float(m["grad_norm"])))
    return out


def compressed(rank, world, tmp, g):
    """Each rank's row of ``g`` through ``compressed_psum`` over ``data``,
    int8 and bf16.  Returns {bits: (mean, residual)}."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.grad_compression import compressed_psum
    mesh = make_host_mesh(data=world, model=1)
    mine = torch.from_numpy(g[rank:rank + 1])
    return {bits: tuple(_np(t) for t in compressed_psum(
        mine, "data", mesh=mesh, bits=bits)) for bits in (8, 16)}


def vocab_ce(rank, world, tmp, x, w, y):
    """``vocab_parallel_ce`` over a (2, 4) mesh on the rank's rows and the
    rank's block of the table's vocab: the loss with z-loss 1e-4, and the
    gradient of the loss without, each block's summed over the ranks that
    hold it over the rank count, the blocks gathered whole."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import P, local_block
    from repro_torch.models import losses
    mesh = M.make_host_mesh(data=2, model=4)
    rows = P("data")
    xl = local_block(torch.from_numpy(x), mesh, rows)
    yl = local_block(torch.from_numpy(y), mesh, rows)
    wt = local_block(torch.from_numpy(w), mesh, P("model", None))
    loss = losses.vocab_parallel_ce(xl, wt, yl, mesh=mesh, tied=True,
                                    vocab=w.shape[0], z_loss=1e-4,
                                    compute_dtype=torch.float32)
    wl = wt.clone().requires_grad_()
    l0 = losses.vocab_parallel_ce(xl, wl, yl, mesh=mesh, tied=True,
                                  vocab=w.shape[0], z_loss=0.0,
                                  compute_dtype=torch.float32)
    g, = torch.autograd.grad(l0, [wl])
    g = M.all_gather(M.psum(g, mesh, "data") / world, mesh, "model", 0)
    return float(loss), _np(g)


def pipeline(rank, world, tmp, ws, x):
    """``pipeline_apply`` of tanh(h @ W_s) over a 4-stage mesh."""
    from repro_torch.train.pipeline import pipeline_apply
    mesh = _mesh(world, names=("stage",))
    out = pipeline_apply(lambda w, h: torch.tanh(h @ w),
                         torch.from_numpy(ws[rank:rank + 1]),
                         torch.from_numpy(x), mesh=mesh)
    return _np(out)


def reshard(rank, world, tmp):
    """Save a tree sharded over a (4,) ``data`` mesh; restore it onto a
    (2, 2) mesh.  Returns the restored leaf's placements, its local block
    and its full value."""
    from repro_torch.launch import sharding as sh
    from repro_torch.train import checkpoint as ckpt
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mesh_a = _mesh(4, names=("data",))
    tree_a = sh.distribute(tree, sh.named(mesh_a, {"w": sh.P("data", None)}))
    ckpt.save(f"{tmp}/ckpt", 1, tree_a)
    mesh_b = _mesh(2, 2, names=("data", "model"))
    shard = sh.named(mesh_b, {"w": sh.P("data", "model")})
    out = ckpt.restore(f"{tmp}/ckpt", 1, tree, shardings=shard)
    return (out["w"].placements == shard["w"].placements,
            _np(out["w"].to_local()), _np(out["w"].full_tensor()))


def seq_parallel(rank, world, tmp, dense, splitkv, mamba):
    """Over a (2, 4) mesh: Megatron-SP ``train_loss`` for each (kv heads,
    parameters, batch) of ``dense``; split-KV decode of ``splitkv``
    (parameters, tokens (2, 8)) over a 12-slot cache, 8 tokens; and the
    mamba families' sequence-parallel ``train_loss`` and gradient norm
    for each (arch, parameters, batch) of ``mamba``."""
    from repro_torch import configs as C
    from repro_torch import weights
    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import P, local_block
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_leaves, tree_map
    mesh = M.make_host_mesh(data=2, model=4)
    rows = P("data")

    def mine(batch):
        return {k: local_block(torch.from_numpy(v), mesh, rows)
                for k, v in batch.items()}
    sp = []
    for kv, np_params, batch in dense:
        cfg = C.reduced(C.get("deepseek-7b"), **F32, num_heads=4,
                        num_kv_heads=kv)
        p = weights.lm_params_from_numpy(np_params, "cpu")
        sp.append(float(T.train_loss(cfg, p, mine(batch), mesh=mesh,
                                     seq_parallel=True)[0]))
    np_params, toks = splitkv
    cfg = C.reduced(C.get("minitron-4b"), **F32, num_heads=4, num_kv_heads=1)
    p = weights.lm_params_from_numpy(np_params, "cpu")
    full = T.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    cache = {"len": 0,
             "k": local_block(full["k"], mesh, P(None, "data", "model")),
             "v": local_block(full["v"], mesh, P(None, "data", "model"))}
    tl = local_block(torch.from_numpy(toks), mesh, rows)
    logits = []
    with torch.no_grad():
        for t in range(8):
            lg, cache = T.decode_step(cfg, p, cache, tl[:, t:t + 1],
                                      mesh=mesh, splitkv=True)
            logits.append(_np(lg[:, 0]))
    ssm = []
    for arch, np_params, batch in mamba:
        cfg = C.reduced(C.get(arch), **F32)
        live = tree_map(lambda t: t.requires_grad_(),
                        weights.lm_params_from_numpy(np_params, "cpu"))
        loss = T.train_loss(cfg, live, mine(batch), mesh=mesh,
                            seq_parallel=True)[0]
        leaves = list(tree_leaves(live))
        grads = torch.autograd.grad(loss / world, leaves)
        grads = [M.psum(g, mesh, ("data", "model")) for g in grads]
        ssm.append((float(loss), [_np(g) for g in grads]))
    return sp, np.stack(logits, 1), ssm


def one_by_one(rank, world, tmp, arch, steps):
    """A 1 x 1 mesh against no mesh: ``make_train_step`` over ``steps``
    steps from one init (losses and parameters), and the split-KV decode
    against the plain decode (logits)."""
    from repro_torch import configs as C
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    cfg = C.reduced(C.get(arch), **F32)
    acfg = opt.AdamConfig(state_dtype="float32")
    mesh = make_host_mesh(data=1, model=1)
    rng = np.random.default_rng(3)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                    .astype(np.int32))
                for k in ("tokens", "labels")} for _ in range(steps)]
    runs = []
    for m in (None, mesh):
        p = registry.init(cfg, torch.Generator().manual_seed(0))
        if m is not None:
            p = sh.distribute(p, sh.named(m, sh.param_pspecs(p, m)))
        o = opt.init(p, acfg)
        step = registry.make_train_step(cfg, acfg, mesh=m)
        losses = []
        for b in batches:
            p, o, met = step(p, o, b)
            losses.append((_np(met["loss"]), _np(met["grad_norm"])))
        runs.append((losses, _full_tree(p)))
    p = registry.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6))
                            .astype(np.int32))
    decs = []
    for m in (None, mesh):
        cache = T.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
        out = []
        with torch.no_grad():
            for t in range(6):
                lg, cache = T.decode_step(cfg, p, cache, toks[:, t:t + 1],
                                          mesh=m, splitkv=m is not None)
                out.append(_np(lg))
        decs.append(out)
    return runs, decs


def launcher(rank, world, tmp, argv, more):
    """``launch.train.main`` on a host mesh of every rank, then again with
    ``more`` arguments (which resumes from the first run's checkpoint)."""
    from repro_torch.launch import train as launch_train
    return [[h for h in launch_train.main(a) if "step" in h]
            for a in (argv, argv + more)]


def collectives(rank, world, tmp, arch, seq, batch):
    """One reduced ``make_train_step`` step at seq x batch over a (2, 4)
    (data, model) mesh, in the sharding mode the dry-run gives the cell,
    under ``launch.dryrun.CollectiveCounter``.  Returns its log: (kind,
    mesh axis, operand bytes) per collective."""
    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt
    cfg = C.reduced(C.get(arch), **F32)
    shape = ShapeConfig("train_4k", seq, batch, "train")
    mesh = make_host_mesh(data=2, model=4)
    mode = sh.parallel_mode(cfg, shape, mesh)
    acfg = opt.AdamConfig(state_dtype=cfg.opt_state_dtype)
    params = registry.init(cfg, torch.Generator().manual_seed(0))
    p = sh.distribute(params, sh.named(
        mesh, sh.param_pspecs(params, mesh, mode=mode, cfg=cfg)))
    o = opt.init(p, acfg)
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                             .astype(np.int32)) for k in ("tokens", "labels")}
    step = registry.make_train_step(cfg, acfg, mesh=mesh,
                                    seq_parallel=mode is not None)
    with CollectiveCounter(mesh) as counter:
        step(p, o, b)
    return counter.log


def cache_decode(rank, world, tmp, np_params, arch, over, prompt, toks,
                 bits=0):
    """``registry.make_decode_step(cfg, shape, mesh=...)`` over a (2, 4)
    (data, model) mesh from the given parameters and a cache of the
    rank's blocks under ``cache_pspecs`` (after a prefill of ``prompt``),
    beside the no-mesh decode of the whole cache, one step a column of
    ``toks``.  With ``bits``, ``np_params`` are (int weights, scales), the
    prefill runs on their dequantized tree and both decodes are
    ``make_decode_step_quantized``'s.  Returns the rank's batch rows; per
    step (the rank's logits, the no-mesh logits of its rows); per cache
    leaf (the rank's final block, the same block of the no-mesh cache);
    and whether the fill levels agree."""
    from repro_torch import configs as C
    from repro_torch import weights
    from repro_torch.compress.tree import dequantize_tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_leaves, tree_map
    cfg = C.reduced(C.get(arch), **F32, **over)
    shape = ShapeConfig("decode_32k", 16, prompt.shape[0], "decode")
    mesh = make_host_mesh(data=2, model=4)
    splitkv = sh.use_splitkv(cfg, shape, mesh)
    if bits:
        q, s = (tree_map(torch.from_numpy, t) for t in np_params)
        params = dequantize_tree(q, s)
        qsteps = [registry.make_decode_step_quantized(cfg, shape, bits, **kw)
                  for kw in (dict(mesh=mesh, splitkv=splitkv), {})]
        on_mesh, alone = ((lambda _, c, t, f=f: f(q, s, c, t))
                          for f in qsteps)
    else:
        params = weights.lm_params_from_numpy(np_params, "cpu")
        on_mesh = registry.make_decode_step(cfg, shape, mesh=mesh,
                                            splitkv=splitkv)
        alone = registry.make_decode_step(cfg, shape)
    prompt, toks = torch.from_numpy(prompt), torch.from_numpy(toks)
    with torch.no_grad():
        _, whole = T.prefill(cfg, params, {"tokens": prompt},
                             max_len=shape.seq_len)
    specs = sh.cache_pspecs(cfg, shape, mesh,
                            registry.abstract_cache(cfg, shape))
    mine = {k: v if k == "len" else tree_map(
        lambda t, s: sh.local_block(t, mesh, s).clone(), v, specs[k])
        for k, v in whole.items()}
    rows = sh.batch_pspecs(cfg, shape, mesh)["tokens"]
    my_rows = sh.local_block(torch.arange(prompt.shape[0])[:, None], mesh,
                             rows)[:, 0]
    logits = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            tok = toks[:, t:t + 1]
            lg, mine = on_mesh(params, mine, sh.local_block(tok, mesh, rows))
            lg1, whole = alone(params, whole, tok)
            logits.append((_np(lg), _np(sh.local_block(lg1, mesh, rows))))
    blocks = [(_np(a), _np(sh.local_block(b, mesh, s))) for a, b, s in zip(
        tree_leaves({k: v for k, v in mine.items() if k != "len"}),
        tree_leaves({k: v for k, v in whole.items() if k != "len"}),
        tree_leaves({k: v for k, v in specs.items() if k != "len"}))]
    return _np(my_rows), logits, blocks, mine["len"] == whole["len"]


def _chain(cfg, mesh, np_params, prompt, toks, seq_parallel, max_len):
    """The ``chain`` kind of :func:`tensor_parallel`."""
    from repro_torch import weights
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_leaves
    whole = weights.lm_params_from_numpy(np_params, "cpu")
    prompt, toks = torch.from_numpy(prompt), torch.from_numpy(toks)
    b, s = prompt.shape
    pshape = ShapeConfig("prefill_32k", s, b, "prefill")
    dshape = ShapeConfig("decode_32k", max_len, b, "decode")
    rows = sh.batch_pspecs(cfg, pshape, mesh)["tokens"]
    lspec = (sh.P(rows[0], None, None) if seq_parallel
             else sh.logits_pspec(cfg, pshape, mesh))
    cspec = sh.cache_pspecs(cfg, dshape, mesh,
                            registry.abstract_cache(cfg, dshape))
    prefill = registry.make_prefill_step(cfg, pshape, mesh=mesh,
                                         seq_parallel=seq_parallel)
    decode = registry.make_decode_step(
        cfg, dshape, mesh=mesh, splitkv=sh.use_splitkv(cfg, dshape, mesh))

    def leaves(cache):                  # in the order of cspec's keys
        return [t for k in cspec if k != "len" for t in tree_leaves(cache[k])]
    with torch.no_grad():
        logits, cache = prefill(whole, {"tokens": sh.local_block(
            prompt, mesh, rows)}, max_len=max_len)
        want, wcache = T.prefill(cfg, whole, {"tokens": prompt},
                                 max_len=max_len)
        # copies: the decode writes the cache in place
        blocks = [(_np(g).copy(), _np(sh.local_block(w, mesh, spec)))
                  for g, w, spec in zip(leaves(cache), leaves(wcache),
                                        leaves(cspec))]
        steps = []
        for t in range(toks.shape[1]):
            lg, cache = decode(whole, cache, sh.local_block(
                toks[:, t:t + 1], mesh, rows))
            steps.append(_np(lg[:, 0]))
    return (_np(logits), _np(sh.local_block(want, mesh, lspec)), blocks,
            np.stack(steps, 1), cache["len"])


def short_spans(rank, world, tmp, spans, ragged):
    """Over a (1, 4) (data, model) mesh, whole parameters on every rank.
    For each (arch, parameters, [(prompt, tokens, cache length)]) of
    ``spans``, per prompt (a span a rank of 1, 2, ... positions): the
    sequence-parallel ``forward`` logits and the no-mesh ones, the
    sequence-parallel prefill and mesh decode of :func:`_chain`, and the
    gradient of the sequence-parallel ``train_loss`` on the prompt
    (summed over the ranks) beside the no-mesh one, leaf by leaf.  For
    each (arch, parameters, batch) of ``ragged`` (a sequence ``model``
    does not divide): the name of the exception each of ``forward``,
    ``prefill`` and ``train_loss`` raises under ``seq_parallel=True``,
    or None, and its message."""
    from repro_torch import configs as C
    from repro_torch import weights
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_leaves, tree_map
    mesh = M.make_host_mesh(data=1, model=4)
    out = {}
    for arch, np_params, prompts in spans:
        cfg = C.reduced(C.get(arch), **F32)
        p = weights.lm_params_from_numpy(np_params, "cpu")
        runs = []
        for prompt, toks, max_len in prompts:
            b = {"tokens": torch.from_numpy(prompt)}
            with torch.no_grad():
                sp = T.forward(cfg, p, b, mesh=mesh, seq_parallel=True)[0]
                plain = T.forward(cfg, p, b)[0]
            grads = []
            for on_mesh in (True, False):
                live = tree_map(lambda t: t.clone().requires_grad_(), p)
                loss = T.train_loss(cfg, live, dict(b, labels=b["tokens"]),
                                    mesh=mesh if on_mesh else None,
                                    seq_parallel=on_mesh)[0]
                g = torch.autograd.grad(loss / (world if on_mesh else 1),
                                        list(tree_leaves(live)))
                grads.append([_np(M.psum(t, mesh, "model") if on_mesh
                                  else t) for t in g])
            runs.append((_np(sp), _np(plain),
                         _chain(cfg, mesh, np_params, prompt, toks, True,
                                max_len), grads))
        out[arch] = runs
    raised = {}
    for arch, np_params, batch in ragged:
        cfg = C.reduced(C.get(arch), **F32)
        p = weights.lm_params_from_numpy(np_params, "cpu")
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        entries = {
            "forward": lambda: T.forward(cfg, p, {"tokens": b["tokens"]},
                                         mesh=mesh, seq_parallel=True),
            "prefill": lambda: T.prefill(cfg, p, {"tokens": b["tokens"]},
                                         mesh=mesh, seq_parallel=True),
            "train_loss": lambda: T.train_loss(cfg, p, b, mesh=mesh,
                                               seq_parallel=True)}
        for name, call in entries.items():
            try:
                with torch.no_grad():
                    call()
                raised[(arch, name)] = (None, "")
            except Exception as e:  # noqa: BLE001 - the test reads its kind
                raised[(arch, name)] = (type(e).__name__, str(e))
    return out, raised


@contextlib.contextmanager
def _env(switches: dict):
    """The environment with ``switches`` set, restored after."""
    old = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _whole_grads(params, grads) -> list:
    """Each leaf's gradient block, placed as its DTensor parameter, whole."""
    from torch.distributed.tensor import DTensor
    from repro_torch.pytree import tree_leaves
    return [_np(DTensor.from_local(g, p.device_mesh, p.placements,
                                   shape=p.shape, stride=p.stride())
                .full_tensor())
            for p, g in zip(tree_leaves(params), tree_leaves(grads))]


def tensor_parallel(rank, world, tmp, cases):
    """Every case of ``cases`` ({name: (kind, arch, over, inputs)}) over a
    (2, 4) (data, model) mesh, the parameters DTensors placed by
    ``param_pspecs`` (mode None: FSDP over ``data``, tensor and expert
    parallelism over ``model``), each step computing on the rank's
    blocks.  Kinds:

    * ``train``: (parameters, batch) -> (whole parameters after one
      ``make_train_step`` step, its metrics, each leaf's gradient before
      it, whole);
    * ``prefill``: (parameters, batch, the reference's (logits, k, v)) ->
      ``make_prefill_step``'s logits, then the same block of the no-mesh
      prefill's and of the reference's (``logits_pspec``), and for ``k``
      and ``v`` the cache block, the no-mesh one and the reference's
      (``cache_pspecs``);
    * ``decode``: (parameters or (int weights, scales), tokens (4, 8),
      environment switches) -> whether it took split-KV, and the rank's
      rows' logits at each of 8 ``make_decode_step`` (or
      ``make_decode_step_quantized``) steps from an empty 12-slot cache
      of the rank's blocks, split-KV where ``use_splitkv`` says under the
      switches;
    * ``encode``: (parameters, batch, the reference's logits) -> an
      encoder's ``make_prefill_step`` logits, then the same block of the
      no-mesh forward's and of the reference's;
    * ``chain``: (parameters, prompt, tokens, ``seq_parallel``, cache
      length) -> ``make_prefill_step`` over the mesh on the rank's rows of
      the prompt (``ssm_seq`` or mode None, whole parameters of which
      each rank takes its placement), then ``make_decode_step`` over the
      mesh on the cache the prefill returned, one step a column of
      ``tokens``: the prefill's logits and the same block of the no-mesh
      prefill's (the rank's rows, and the vocab block of
      ``logits_pspec`` in mode None; the vocab whole under ``ssm_seq``),
      per cache leaf after the prefill (its block, the same block of the
      no-mesh prefill's cache under ``cache_pspecs``), the decode's
      logits (rows x steps x vocab) and the fill level after them.
    Returns {name: result}, and the rank's batch rows."""
    from repro_torch import configs as C
    from repro_torch import weights
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_map
    from repro_torch.train import optimizer as opt
    mesh = make_host_mesh(data=2, model=4)
    acfg = opt.AdamConfig(state_dtype="float32")

    def placed(cfg, tree):
        return sh.distribute(tree, sh.named(mesh, sh.param_pspecs(
            tree, mesh, cfg=cfg)))

    def tensors(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    out = {}
    for name, (kind, arch, over, inputs) in cases.items():
        cfg = C.reduced(C.get(arch), **F32, **over)
        if kind == "chain":
            out[name] = _chain(cfg, mesh, *inputs)
            continue
        if kind == "train":
            np_params, batch = inputs
            p = placed(cfg, weights.lm_params_from_numpy(np_params, "cpu"))
            b = tensors(batch)
            grads = registry._sharded_grads(cfg, mesh, False)(p, b)[2]
            grads = _whole_grads(p, grads)
            step = registry.make_train_step(cfg, acfg, mesh=mesh)
            p, _, m = step(p, opt.init(p, acfg), b)
            out[name] = (_full_tree(p), {k: float(v) for k, v in m.items()},
                         grads)
            continue
        if kind in ("prefill", "encode"):
            np_params, batch, ref = inputs
            whole = weights.lm_params_from_numpy(np_params, "cpu")
            b = tensors(batch)
            s = next(iter(b.values())).shape[1] + (
                cfg.num_patches if cfg.family == "vlm" else 0)
            shape = ShapeConfig("prefill_32k", s, 4, "prefill")
            bspec = sh.batch_pspecs(cfg, shape, mesh)
            mine = {k: sh.local_block(v, mesh, bspec[k])
                    for k, v in b.items()}
            step = registry.make_prefill_step(cfg, shape, mesh=mesh)
            lspec = sh.logits_pspec(cfg, shape, mesh)

            def block(t, spec):
                if isinstance(t, np.ndarray):
                    t = torch.from_numpy(t)
                return _np(sh.local_block(t, mesh, spec))
            with torch.no_grad():
                got = step(placed(cfg, whole), mine)
                if kind == "encode":
                    want = T.forward(cfg, whole, b)[0]
                    out[name] = (_np(got), block(want, lspec),
                                 block(ref, lspec))
                    continue
                want = T.prefill(cfg, whole, b)
            cspec = sh.cache_pspecs(cfg, shape, mesh,
                                    registry.abstract_cache(cfg, shape))
            out[name] = (
                _np(got[0]), block(want[0], lspec), block(ref[0], lspec),
                [(_np(got[1][k]), block(want[1][k], cspec[k]),
                  block(r, cspec[k])) for k, r in zip(("k", "v"), ref[1:])])
            continue
        params, toks, switches = inputs
        shape = ShapeConfig("decode_32k", 12, toks.shape[0], "decode")
        with _env(switches):
            splitkv = sh.use_splitkv(cfg, shape, mesh)
        cspec = sh.cache_pspecs(cfg, shape, mesh,
                                registry.abstract_cache(cfg, shape))
        full = T.init_cache(cfg, toks.shape[0], 12, dtype=torch.float32,
                            device="cpu")
        cache = {k: v if k == "len" else sh.local_block(v, mesh, cspec[k])
                 .clone() for k, v in full.items()}
        rows = sh.batch_pspecs(cfg, shape, mesh)["tokens"]
        tl = sh.local_block(torch.from_numpy(toks), mesh, rows)
        if isinstance(params, tuple):            # (int weights, scales)
            q = tree_map(torch.from_numpy, params[0])
            scales = sh.distribute(tree_map(torch.from_numpy, params[1]),
                                   sh.named(mesh, tree_map(lambda _: sh.P(),
                                                           params[1])))
            qstep = registry.make_decode_step_quantized(
                cfg, shape, 8, mesh=mesh, splitkv=splitkv)
            q = placed(cfg, q)

            def step(c, t):
                return qstep(q, scales, c, t)
        else:
            p = placed(cfg, weights.lm_params_from_numpy(params, "cpu"))
            dstep = registry.make_decode_step(cfg, shape, mesh=mesh,
                                              splitkv=splitkv)

            def step(c, t):
                return dstep(p, c, t)
        logits = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, cache = step(cache, tl[:, t:t + 1])
                logits.append(_np(lg[:, 0]))
        out[name] = (splitkv, np.stack(logits, 1))
    rows = sh.local_block(torch.arange(4)[:, None], mesh, sh.P("data"))
    return out, _np(rows[:, 0])
