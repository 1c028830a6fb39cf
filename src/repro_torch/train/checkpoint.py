"""Checkpoints in the reference's on-disk format (reference
``repro.train.checkpoint``).

One directory per step, ``<dir>/step_<n:08d>``, holding

  * ``manifest.json`` — step, each leaf's shape and dtype, user metadata;
  * ``arrays.npz``    — every leaf as a full array, keyed by its path as
    ``jax.tree_util.keystr`` spells it (``['params']['embed']['table']``).

A checkpoint the reference wrote restores here, and one written here
restores in the reference (bfloat16 leaves aside, see below).
Durability: the step is written to ``<dir>.tmp`` and renamed into place;
``keep_last`` older steps are removed only after the rename.  Leaves are
written one at a time, as ``np.savez`` writes them (a stored zip member
``<key>.npy`` each), so the host holds one leaf at a time, and
``restore`` reads only the leaves of the tree it is given.

bfloat16 leaves: numpy has no bfloat16.  The reference's leaves are
``ml_dtypes`` arrays, which ``np.savez`` stores under the void descriptor
``|V2``; this module writes a ``torch.bfloat16`` leaf's 16-bit patterns
under the same descriptor and reads a ``|V2`` leaf back as those bits,
exactly.  (The reference's own ``restore`` cannot read such a leaf:
``astype`` has no cast from ``|V2``, ROADMAP C7.)

``restore`` takes a tree of tensors, or of ``meta`` stand-ins
(``models.registry.abstract_params``), as the reference takes
``ShapeDtypeStruct``s; each leaf lands on ``device`` (default: the given
leaf's own device; a ``meta`` leaf needs ``device``).

Elastic resharding, as in the reference: the files hold full logical
arrays, so a tree sharded over one mesh restores onto another.  ``save``
of a tree with DTensor leaves is called on every rank: each leaf is
gathered whole and rank 0 writes it.  ``restore`` with ``shardings`` (a
matching tree of ``launch.sharding.NamedSharding``) gives each rank a
DTensor holding its own block of each leaf; a DTensor in ``like_tree``
restores onto its own mesh and placements.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import zipfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device

_BF16_DESCR = np.dtype("V2")
# the default home of checkpoints: the package's build directory, which
# git ignores
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "checkpoints")


def _flatten(tree, path: str = ""):
    """(keystr path, leaf) of every leaf of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_DESCR)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save(directory: str, step: int, tree, metadata: dict | None = None,
         keep_last: int = 3) -> str:
    """Atomically persist ``tree`` (a nested dict of tensors) at
    ``directory/step_<n>``; returns that path.  A tree with DTensor leaves
    is saved by every rank together (see the module docstring)."""
    sharded = any(isinstance(t, DTensor) for _, t in _flatten(tree))
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves = {}
    if writer:
        os.makedirs(tmp, exist_ok=True)
        zf = zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                             compression=zipfile.ZIP_STORED, allowZip64=True)
    with zf if writer else contextlib.nullcontext():
        for key, t in _flatten(tree):
            if isinstance(t, DTensor):
                t = t.full_tensor()
            if not writer:
                continue
            leaves[key] = {"shape": list(t.shape), "dtype": _dtype_name(t)}
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(t),
                                          allow_pickle=False)
    if writer:
        manifest = {"step": step, "leaves": leaves,
                    "metadata": metadata or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep_last)
    if sharded:
        dist.barrier()
    return final


def _gc(directory: str, keep_last: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A leaf as read from the file -> a CPU tensor, bit for bit; a
    ``|V2`` leaf is a bfloat16's 16-bit patterns."""
    arr = np.require(arr, requirements="C")      # keeps a 0-dim leaf 0-dim
    if arr.dtype == _BF16_DESCR:
        if dtype_name != "bfloat16":
            raise ValueError(f"a |V2 leaf recorded as {dtype_name!r}: only "
                             "bfloat16 is stored so")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, step: int, like_tree, shardings=None, *,
            device: str | torch.device | None = None):
    """The checkpoint at ``step`` in the structure, shapes and dtypes of
    ``like_tree`` (tensors or ``meta`` stand-ins), each leaf cast to its
    like's dtype and placed on ``device`` or else on the like leaf's own
    device (with ``shardings``: on the mesh's device, as a DTensor of this
    rank's block).  A shape that differs raises ``ValueError``."""
    from repro_torch.launch.sharding import local_block
    dev = None if device is None else resolve_device(device)
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        recorded = json.load(f)["leaves"]

    def leaf_device(key, leaf):
        if dev is not None:
            return dev
        if leaf.is_meta:
            raise ValueError(f"restore: {key} is a meta stand-in; pass "
                             "device=")
        return leaf.device

    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, leaf in _flatten(like_tree):
            arr = z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} shape {arr.shape} "
                                 f"!= expected {tuple(leaf.shape)}")
            t = _to_tensor(arr, recorded[key]["dtype"])
            if isinstance(leaf, DTensor) and key not in placed:
                # onto the like leaf's own mesh and placements
                out[key] = distribute_tensor(
                    t.to(device=dev or leaf.device, dtype=leaf.dtype),
                    leaf.device_mesh, leaf.placements, src_data_rank=None)
            elif key in placed:
                sh = placed[key]
                mdev = dev or _mesh_device(sh.mesh)
                block = local_block(t, sh.mesh, sh.spec).to(
                    device=mdev, dtype=leaf.dtype).contiguous()
                out[key] = DTensor.from_local(block, sh.mesh, sh.placements,
                                              run_check=False)
            else:
                out[key] = t.to(device=leaf_device(key, leaf),
                                dtype=leaf.dtype)
    return _unflatten(like_tree, out)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _unflatten(like_tree, flat: dict, path: str = ""):
    if isinstance(like_tree, dict):
        return {k: _unflatten(v, flat, f"{path}[{k!r}]")
                for k, v in like_tree.items()}
    return flat[path]


def read_metadata(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)["metadata"]
