"""Meshes over ``torch.distributed`` (reference ``repro.launch.mesh``), and
the collectives the port's per-rank code runs over a mesh axis.

Axes, as in the reference:

  * ``pod``   — pure data parallelism across pods (gradient all-reduce
                only, compressible by ``train/grad_compression.py``);
  * ``data``  — the FSDP axis (parameters and optimizer state sharded,
                each layer's gathered at use, :func:`gather_layer`);
  * ``model`` — the tensor / sequence parallel axis.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` named with these
axes over an initialised process group (:func:`init_process_group`:
``nccl`` for ``cuda``, ``gloo`` for ``cpu``).  The sharding rules
(``batch_axes``, ``batch_shards``, ``tp_size`` and ``launch/sharding.py``)
read only axis names and sizes, so they take a :class:`MeshShape` as well:
the production meshes' rules are checked on the CPU without 256 processes.

Where the reference runs a function under ``shard_map``, the port runs it
on every rank of the mesh, on the rank's own block of each input, and the
collectives below take the place of ``psum`` / ``pmax`` /
``all_gather`` / ``psum_scatter`` / ``ppermute`` along one axis.  The ones
a gradient flows through are ``torch.autograd.Function``s whose backward
is the collective's transpose (a sum's is a sum, an all-gather's a
reduce-scatter, a shift's the opposite shift), so that the gradient each
rank computes, summed over the ranks, is the gradient of the sum of every
rank's output.  (``torch.distributed.nn.functional`` has the same idea,
but in torch 2.13 it warns on every call, and its all-gather's backward
fails on a subgroup.)  An axis of size 1 communicates nothing.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process group behind it."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """The names and sizes of a ``DeviceMesh`` (or of a ``MeshShape``)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


# ---------------------------------------------------------------------------
# Process groups and meshes
# ---------------------------------------------------------------------------

def init_process_group(device: str = "cuda", *, init_method: str | None = None,
                       rank: int | None = None,
                       world_size: int | None = None) -> torch.device:
    """Start the default process group, ``nccl`` for ``cuda`` and ``gloo``
    for ``cpu``, and return this rank's device.  Without ``init_method``
    it reads torch's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` (``env://``, as ``torchrun`` sets them).  On ``cuda``
    the rank takes card ``LOCAL_RANK`` (else its rank modulo the cards);
    a card asked for and absent raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        resolve_device("cuda")
    if not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" not in os.environ:
            raise ValueError(
                "no process group to join: start one process per rank with "
                "MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE set (torchrun "
                "sets them), or pass init_method")
        dist.init_process_group(
            "nccl" if kind == "cuda" else "gloo",
            init_method=init_method or "env://",
            rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size)
    if kind == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    return torch.device("cpu")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, num_pods: int = 2):
    """(16, 16) over ("data", "model"), or (num_pods, 16, 16) over ("pod",
    "data", "model"); raises unless the process group has that many
    ranks."""
    shape = (num_pods, 16, 16) if multi_pod else (16, 16)
    names = AXES if multi_pod else AXES[1:]
    return _make_mesh(shape, names)


def make_host_mesh(data: int | None = None, model: int = 1):
    """A (data, model) mesh over every rank of the process group."""
    n = dist.get_world_size()
    data = data if data is not None else max(1, n // model)
    return _make_mesh((data, model), AXES[1:])


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh).axis_names)


def batch_shards(mesh) -> int:
    shape = mesh_shape(mesh).shape
    return int(math.prod(shape[a] for a in batch_axes(mesh)))


def tp_size(mesh) -> int:
    shape = mesh_shape(mesh).shape
    return int(shape["model"]) if "model" in shape else 1


# ---------------------------------------------------------------------------
# Per-rank collectives along mesh axes
# ---------------------------------------------------------------------------

def _names(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh).shape
    return int(math.prod(shape[a] for a in _names(axes)))


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (several axes: row-major, the first
    one major, as a tuple of names shards a dimension)."""
    idx = 0
    for a in _names(axes):
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


# torch 2.13 renames reduce_scatter_tensor (and warns on the old name)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _group(mesh, axis):
    return mesh.get_group(axis)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The blocks of every rank of ``group``, concatenated along ``dim``;
    backward: the sum over the ranks of the gradient, each rank keeping
    its own block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the ranks of ``group``, split along ``dim`` into one
    block a rank (``psum_scatter(..., tiled=True)``); backward: the
    all-gather of the blocks."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        xs = x.movedim(dim, 0).contiguous()
        out = torch.empty((xs.shape[0] // n,) + xs.shape[1:], dtype=x.dtype,
                          device=x.device)
        _reduce_scatter(out, xs, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    """Each rank's ``x`` to the next rank of ``group`` (the last one's goes
    nowhere); the first rank receives zeros.  ``step`` -1 shifts the other
    way, which is the backward."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        n, me = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        if 0 <= me + step < n:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, me + step)))
        if 0 <= me - step < n:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, me - step)))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    @staticmethod
    def backward(ctx, g):
        return _Shift.apply(g, ctx.group, -ctx.step), None, None


def psum(x, mesh, axes):
    """The sum of ``x`` over the ranks along ``axes`` (one axis after the
    other, as the reference's ``_psum``), differentiable."""
    for a in _names(axes):
        if axis_size(mesh, a) > 1:
            x = _AllReduce.apply(x, _group(mesh, a))
    return x


def pmean(x, mesh, axes):
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def pmax(x, mesh, axes):
    """The elementwise max over the ranks along ``axes``; no gradient
    (the reference stops it, and ``pmax`` has no AD rule there)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    for a in _names(axes):
        if axis_size(mesh, a) > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(mesh, a))
    return x


def all_gather(x, mesh, axis: str, dim: int):
    """Every rank's block along ``axis``, concatenated on ``dim`` in rank
    order (``all_gather(..., tiled=True)``), differentiable."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllGather.apply(x, _group(mesh, axis), dim)


def stack_gather(x, mesh, axis: str):
    """Every rank's ``x`` along ``axis``, stacked on a new leading dim
    (``all_gather(..., tiled=False)``), differentiable."""
    return all_gather(x[None], mesh, axis, 0)


def psum_scatter(x, mesh, axis: str, dim: int):
    """The sum over ``axis``, each rank keeping its block of ``dim``
    (``psum_scatter(..., tiled=True)``), differentiable."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceScatter.apply(x, _group(mesh, axis), dim)


def gather_layer(tree, specs, mesh, keep=("model",)):
    """One layer's blocks, each leaf gathered along every dimension its
    spec places on a mesh axis outside ``keep`` (the FSDP gather over
    ``data``, the reference's ``gather_w``); the ``model`` blocks stay the
    rank's own.  ``tree``: the rank's blocks of one layer (the stacked
    leaves' ``[i]``), or unstacked leaves; ``specs``: the matching specs
    of ``launch.sharding.param_pspecs`` (a stacked leaf's spec has the
    layer dimension first, replicated), or None for blocks that are
    whole along every axis outside ``keep``.  Differentiable: each
    gather's backward reduce-scatters the gradient to the rank's own
    block, so a gathered weight lives only as long as the layer that
    gathered it (under remat, the backward gathers it again)."""
    from repro_torch.pytree import tree_map
    if specs is None:
        return tree
    mesh_axes = mesh_shape(mesh).axis_names

    def one(t, spec):
        off = len(spec) - t.ndim
        for dim, entry in enumerate(spec[off:]):
            if entry is None:
                continue
            # a dimension split over several axes, the first one major:
            # the minor axis's blocks are joined first
            for a in reversed(_names(entry)):
                if a not in keep and a in mesh_axes:
                    t = all_gather(t, mesh, a, dim)
        return t
    return tree_map(one, tree, specs)


def shift_next(x, mesh, axis: str):
    """``ppermute`` over the pairs (i, i + 1): each rank receives its
    predecessor's ``x``, the first rank zeros; differentiable."""
    if axis_size(mesh, axis) == 1:
        return torch.zeros_like(x)
    return _Shift.apply(x, _group(mesh, axis), 1)
