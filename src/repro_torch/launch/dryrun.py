"""Multi-pod dry-run (reference ``repro.launch.dryrun``): trace every
(architecture x input shape) on the production meshes, in one process on
the CPU, with nothing model-sized allocated.

  single-pod : 16 x 16           (data, model)        = 256 ranks
  multi-pod  : 2 x 16 x 16       (pod, data, model)   = 512 ranks

The reference lowers and compiles each cell on 512 placeholder host
devices and reads memory and cost from XLA.  A torch step has no compiled
program to ask, so this module starts a ``fake`` process group of 256 or
512 ranks (every collective returns at once), builds the step over the
port's own ``launch.mesh.make_production_mesh``, and runs it once as rank
0 on ``meta`` stand-ins (shapes, dtypes, no storage) placed as the
sharding specs say, ``meta`` the default device throughout.  That run
takes the place of ``lower`` + ``compile`` (``trace_s`` in place of
``lower_s`` / ``compile_s``).  One dispatch mode, :class:`StepTracer`,
watches it:

  * every c10d collective rank 0 issues: the port's own
    (``launch/mesh.py``), DTensor's gathers in ``full_tensor`` and the
    reduce-scatters of ``grad_placements=Partial``, by kind (the
    reference's HLO names) and operand bytes.  Their sum is the
    roofline's collective term;
  * the FLOPs, by ``FlopCounterMode``'s formulas
    (``traced.flops_per_device``, in place of ``hlo_raw``); unlike XLA's
    ``cost_analysis`` every loop iteration counts;
  * the bytes of live storages, as ``MemTracker`` counts them, for
    ``memory.peak_bytes`` and ``fits_hbm`` against the card's
    ``roofline.HBM_BYTES``.  ``memory.argument_bytes`` is rank 0's blocks
    of the step's inputs, read from the specs.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES, applicable
from repro_torch.launch import analytic
from repro_torch.launch import roofline as rf
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import MeshShape, make_production_mesh, mesh_shape
from repro_torch.models import registry
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamConfig

LOG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build",
                       "dryrun")

# c10d op name -> (the reference's HLO kind, index of the operand argument).
# The eager ops (``c10d.*``) are what ``torch.distributed`` calls issue, the
# functional ones (``_c10d_functional.*``) what DTensor issues.  A send's
# bytes are counted at the sender; its receive is not a second transfer.
_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "broadcast_": ("broadcast", 0),
}
_NAMESPACES = ("c10d", "_c10d_functional")
_META = torch.device("meta")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Every c10d collective dispatched while it is active: ``log`` holds
    one ``(kind, axis, operand bytes)`` a call, ``axis`` the mesh axis
    whose group it ran over (or the group's name).  Works on real, fake
    and ``meta`` tensors alike."""

    def __init__(self, mesh=None):
        super().__init__()
        self.log: list[tuple[str, str, int]] = []
        self._axes: dict[str, str] = {}
        if mesh is not None:
            for a in mesh_shape(mesh).axis_names:
                self._axes[mesh.get_group(a).group_name] = a

    def _axis(self, args) -> str:
        for a in args:
            name = a if isinstance(a, str) else None
            if isinstance(a, torch.ScriptObject):
                name = dist.ProcessGroup.unbox(a).group_name
            if name is not None:
                return self._axes.get(name, name)
        return "?"

    def _collective(self, func, args) -> None:
        if getattr(func, "namespace", "") in _NAMESPACES:
            hit = _OPS.get(func._opname)
            if hit is not None:
                kind, i = hit
                self.log.append((kind, self._axis(args), _nbytes(args[i])))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._collective(func, args)
        return func(*args, **(kwargs or {}))

    @property
    def counts(self) -> dict:
        out: dict[str, int] = {}
        for kind, _, _ in self.log:
            out[kind] = out.get(kind, 0) + 1
        return out

    @property
    def bytes_by_kind(self) -> dict:
        out: dict[str, int] = {}
        for kind, _, b in self.log:
            out[kind] = out.get(kind, 0) + b
        return out

    @property
    def total_bytes(self) -> int:
        return sum(b for _, _, b in self.log)


class StepTracer(CollectiveCounter):
    """:class:`CollectiveCounter`, and in the same pass the FLOPs and the
    peak of live storage bytes:

      * ``flops``: ``torch.utils.flop_counter``'s formula for each op that
        has one (``FlopCounterMode``'s registry, summed over every call);
      * ``peak_bytes``: the most bytes of distinct storages alive at once,
        among those :meth:`hold` was given and those the ops made
        (``MemTracker``'s accounting: a storage counts from the op that
        made it to its release).

    One dispatch mode in place of three, and an op already seen on
    inputs of the same shapes, strides and dtypes, whose outputs are new
    storages, is answered from its first outputs' metadata instead of
    running its meta kernel again.  ``tools/dryrun_tracer_ab.py`` times
    this against the stacked tools and without the memo, and prints the
    three's FLOPs and peak bytes side by side."""

    def __init__(self, mesh=None):
        super().__init__(mesh)
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self._formulas = flop_registry
        self._storages = WeakIdKeyDictionary()
        self._memo: dict = {}
        self._pure: dict = {}
        self.flops = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def hold(self, tensors) -> None:
        """Count these tensors' storages as alive (the step's inputs)."""
        for t in tensors:
            self._track(t)

    def _released(self, nbytes: int, _ref) -> None:
        self.live_bytes -= nbytes

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        ref = weakref.ref(st, lambda r, n=n: self._released(n, r))
        self._storages[st] = ref
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor in types:
            return NotImplemented      # DTensor desugars to local ops first
        kwargs = kwargs or {}
        self._collective(func, args)
        key = self._key(func, args, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit:
            out = _make(hit)
        else:
            out = func(*args, **kwargs)
            if key is not None and hit is None:
                # an output that shares an input's storage (``_unsafe_view``
                # declares no alias) is never made again from its metadata
                self._memo[key] = (not _shares_storage(out, args)
                                   and _template(out)) or False
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            self._track(t)
        return out

    def _key(self, func, args, kwargs):
        """A key for ``func`` on these inputs' metadata, or None where its
        outputs may alias an input or its result is not only a function
        of the metadata (in-place and view ops, collectives, ops on
        tensors that are not ``meta``)."""
        pure = self._pure.get(func)
        if pure is None:
            schema = func._schema
            pure = not (schema.is_mutable or func.namespace in _NAMESPACES
                        or any(r.alias_info is not None
                               for r in schema.returns))
            self._pure[func] = pure
        if not pure:
            return None
        try:
            return (func, _meta_key(args), _meta_key(tuple(sorted(
                kwargs.items()))))
        except _NotKeyable:
            return None


class _NotKeyable(Exception):
    pass


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta" or type(x) is not torch.Tensor:
            raise _NotKeyable
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise _NotKeyable


def _template(out):
    """What :func:`_make` needs to make ``out`` again: each tensor's shape,
    strides and dtype; None where an output is not a ``meta`` tensor."""
    if isinstance(out, (tuple, list)):
        parts = [_template(o) for o in out]
        return None if any(p is None for p in parts) else (type(out), parts)
    if isinstance(out, torch.Tensor) and out.device.type == "meta" \
            and type(out) is torch.Tensor:
        return (tuple(out.shape), out.stride(), out.dtype)
    return None


def _storages(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        out.add(x.untyped_storage()._cdata)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _storages(v, out)
    return out


def _shares_storage(out, args) -> bool:
    return bool(_storages(out, set()) & _storages(args, set()))


def _make(tpl):
    if isinstance(tpl[0], type):
        return tpl[0](_make(p) for p in tpl[1])
    shape, stride, dtype = tpl
    return torch.empty_strided(shape, stride, dtype=dtype, device=_META)


# ---------------------------------------------------------------------------
# The fake process group and the cells
# ---------------------------------------------------------------------------

# the fake backend on the CPU and on ``meta`` (point-to-point sends look
# their backend up by the tensor's device)
FAKE_BACKEND = "cpu:fake,meta:fake"


def fake_group(world: int) -> None:
    """Make the default process group a ``fake`` one of ``world`` ranks,
    this process rank 0 (any other group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == FAKE_BACKEND
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=world)


def _local_shape(shape, spec, mesh) -> tuple:
    """The rank's block's shape of a tensor of ``shape`` under ``spec``
    (each sharded dimension split evenly over its axes)."""
    sizes = mesh_shape(mesh).shape
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(int(sizes[a]) for a in names)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into "
                             f"{n} blocks over {entry}")
        out[d] //= n
    return tuple(out)


def _local_bytes(tree, specs, mesh) -> int:
    total = 0
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        total += (math.prod(_local_shape(leaf.shape, spec, mesh))
                  * leaf.element_size())
    return total


def _blocks(tree, specs, mesh):
    """Rank 0's blocks of the stand-ins of ``tree`` under ``specs``."""
    return tree_map(lambda t, s: torch.empty(
        _local_shape(t.shape, s, mesh), dtype=t.dtype, device=_META),
        tree, specs)


def _dtensors(tree, specs, mesh):
    """The stand-ins of ``tree`` as DTensors placed by ``specs``, each
    holding rank 0's block."""
    return tree_map(lambda t, s: DTensor.from_local(
        torch.empty(_local_shape(t.shape, s, mesh), dtype=t.dtype,
                    device=_META),
        mesh, sh.NamedSharding(mesh, sh.P(*s)).placements, run_check=False),
        tree, specs)


def _quant_bits(shape) -> int:
    return (int(os.environ.get("REPRO_SERVE_QUANT", "0"))
            if shape.kind == "decode" else 0)


def production_shape(multi_pod: bool) -> MeshShape:
    """The production mesh's axis names and sizes, with no process group."""
    return (MeshShape(("pod", "data", "model"), (2, 16, 16)) if multi_pod
            else MeshShape(("data", "model"), (16, 16)))


def plan_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """A cell's record before any tracing: ``status="skipped"`` and the
    reason where the (arch x shape) does not apply, else the sharding
    mode (``parallel_mode``) its step takes on the production mesh."""
    cfg, shape = configs.get(arch), SHAPES[shape_name]
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, reason = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
    else:
        rec["parallel_mode"] = sh.parallel_mode(cfg, shape,
                                                production_shape(multi_pod))
    return rec


def build_cell(arch: str, shape_name: str, mesh, *, cfg=None, shape=None):
    """-> (step, args, argument_bytes) for one cell: ``args`` are the
    step's inputs as ``meta`` stand-ins, rank 0's blocks placed as the
    specs say (the reference's ``in_shardings``); ``argument_bytes`` is
    their sum over rank 0's blocks.  A sequence-parallel prefill takes
    rank 0's rows with the whole sequence and cuts its span itself, as
    the reference's jitted step sees the global sequence; its
    ``argument_bytes`` still count the ``in_shardings`` blocks (the span).
    ``cfg`` / ``shape`` replace the named config and shape (a reduced
    model on a small mesh)."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    mode = sh.parallel_mode(cfg, shape, mesh)
    seqp = mode is not None
    batch_sds = registry.input_specs(cfg, shape)
    batch_specs = sh.batch_pspecs(cfg, shape, mesh, seq_parallel=seqp)
    aparams = registry.abstract_params(cfg)
    pspecs = sh.param_pspecs(aparams, mesh, mode=mode, cfg=cfg)
    batch_bytes = sum(_local_bytes(batch_sds[k], batch_specs[k], mesh)
                      for k in batch_sds)

    if shape.kind == "train":
        acfg = AdamConfig(state_dtype=cfg.opt_state_dtype)
        aopt = registry.abstract_opt(cfg, acfg)
        ospecs = sh.opt_pspecs(aopt, pspecs)
        step = registry.make_train_step(cfg, acfg, mesh=mesh,
                                        seq_parallel=seqp)
        # the step takes the global batch and cuts its own rows
        args = (_dtensors(aparams, pspecs, mesh),
                _dtensors(aopt, ospecs, mesh), batch_sds)
        return step, args, (_local_bytes(aparams, pspecs, mesh)
                            + _local_bytes(aopt, ospecs, mesh) + batch_bytes)

    if shape.kind == "prefill":
        step = registry.make_prefill_step(cfg, shape, mesh=mesh,
                                          seq_parallel=seqp)
        # the step takes rank 0's rows and cuts its own span
        rows = sh.batch_pspecs(cfg, shape, mesh, seq_parallel=False)
        args = (_dtensors(aparams, pspecs, mesh),
                _blocks(batch_sds, rows, mesh))
        return step, args, _local_bytes(aparams, pspecs, mesh) + batch_bytes

    # decode
    acache = registry.abstract_cache(cfg, shape)
    cspecs = sh.cache_pspecs(cfg, shape, mesh, acache)
    splitkv = sh.use_splitkv(cfg, shape, mesh)
    tokens = _blocks(batch_sds["tokens"], batch_specs["tokens"], mesh)
    cache = _blocks(acache, cspecs, mesh)
    # the port's fill level is an int: one new token after a full cache
    # (the last position written, every earlier one attended)
    cache["len"] = shape.seq_len - 1
    io_bytes = _local_bytes(acache, cspecs, mesh) + batch_bytes
    quant_bits = _quant_bits(shape)
    if quant_bits:
        qp, scales = registry.abstract_quantized_params(cfg, quant_bits)
        sspecs = tree_map(lambda _: sh.P(), scales)
        step = registry.make_decode_step_quantized(cfg, shape, quant_bits,
                                                   mesh=mesh, splitkv=splitkv)
        args = (_dtensors(qp, pspecs, mesh), _dtensors(scales, sspecs, mesh),
                cache, tokens)
        return step, args, (_local_bytes(qp, pspecs, mesh)
                            + _local_bytes(scales, sspecs, mesh) + io_bytes)
    step = registry.make_decode_step(cfg, shape, mesh=mesh, splitkv=splitkv)
    args = (_dtensors(aparams, pspecs, mesh), cache, tokens)
    return step, args, _local_bytes(aparams, pspecs, mesh) + io_bytes


def trace_step(step, args, mesh) -> tuple[StepTracer, float]:
    """Run ``step`` once on its ``meta`` inputs as rank 0, with ``meta``
    the default device (a factory call without a device allocates
    nothing either).  Returns the tracer and the seconds it took."""
    tracer = StepTracer(mesh)
    tracer.hold(t for a in args for t in tree_leaves(a))
    t0 = time.perf_counter()
    with _META, tracer:
        out = step(*args)
    dt = time.perf_counter() - t0
    del out
    return tracer, dt


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             keep_hlo: bool = False) -> dict:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    rec = plan_cell(arch, shape_name, multi_pod)
    if rec.get("status") == "skipped":
        return rec
    mesh_name = rec["mesh"]
    try:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = dist.get_world_size()
        step, args, arg_bytes = build_cell(arch, shape_name, mesh)
        colls, trace_s = trace_step(step, args, mesh)
        del step, args
        flops, peak = colls.flops, colls.peak_bytes
        ms = mesh_shape(mesh).shape
        pods = int(ms.get("pod", 1))
        data = int(ms["data"])
        model = int(ms["model"])
        n_params = registry.param_count(cfg)
        qbits = _quant_bits(shape)
        cost = analytic.cell_cost(cfg, shape, n_params=n_params,
                                  batch_shards=pods * data,
                                  weight_quant_bits=qbits)
        mode = rec["parallel_mode"]
        seqp = mode == "ssm_seq"  # weights replicated only in ssm mode
        roof = rf.Roofline.from_cost(
            cost, shape.kind, pods=pods, data=data, model=model,
            collective_bytes_per_device=float(colls.total_bytes),
            model_flops_global=registry.step_flops_model(cfg, shape),
            weight_shards=1 if seqp else None)
        rec.update(
            status="ok",
            chips=chips,
            trace_s=round(trace_s, 2),
            n_params=n_params,
            analytic={
                "flops_fwd_global": cost.flops_fwd,
                "flops_total_global": cost.flops_total,
                "weight_bytes_per_pass": cost.weight_bytes_per_pass,
                "act_bytes": cost.act_bytes,
                "cache_bytes": cost.cache_bytes,
                "opt_bytes": cost.opt_bytes,
                "notes": cost.notes,
            },
            traced={  # FlopCounterMode's formulas, every iteration counted
                "flops_per_device": flops,
            },
            flops_per_device=roof.flops_per_device,
            bytes_per_device=roof.bytes_per_device,
            collective_bytes_per_device=roof.collective_bytes_per_device,
            collective_counts=colls.counts,
            collective_bytes_by_kind=colls.bytes_by_kind,
            model_flops_global=roof.model_flops_global,
            memory={
                "argument_bytes": arg_bytes,
                "peak_bytes": peak,
            },
            fits_hbm=peak <= rf.HBM_BYTES,
            roofline=roof.row(),
        )
        if keep_hlo:
            os.makedirs(LOG_DIR, exist_ok=True)
            path = os.path.join(
                LOG_DIR, f"collectives_{arch}_{shape_name}_{mesh_name}.txt")
            with open(path, "w") as f:
                for kind, axis, b in colls.log:
                    f.write(f"{kind} {axis} {b}\n")
            rec["collective_log_path"] = path
    except Exception as e:  # a failure here is a bug in the port's sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep-hlo", action="store_true",
                    help="no HLO to keep: write rank 0's collective log "
                         "(kind, axis, bytes a line) under " + LOG_DIR)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    archs = list(configs.ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))

    errors = 0
    out_f = open(args.out, "a") if args.out else None
    try:
        for a, s, m in cells:
            rec = run_cell(a, s, m, keep_hlo=args.keep_hlo)
            errors += rec["status"] == "error"
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    if errors:
        print(f"{errors} of {len(cells)} cells failed", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
