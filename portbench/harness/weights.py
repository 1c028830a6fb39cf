"""Random weights from ``--seed``, made on the device in a few large calls.

The tree's layout (leaf paths, shapes and dtypes) is the one the port
takes, written into the configuration's file under ``layout`` by
:func:`layout` (``python3 portbench/harness/weights.py <config file>``;
a CPU test holds it to ``repro_torch.models.transformer.init`` on
``meta`` stand-ins, which a run does not call: on the card that path
imports ``torch._dynamo``, about 10 s of set-up).  Each leaf, stacked
over the layers where the port stacks it, is drawn in one call from one
``torch.Generator`` on the device, by a rule on its name: the same
distributions as the port's initialisers (truncated normals at
``1/sqrt(d_in)`` for dense weights, 0.1 for the depthwise conv, 0.02 for
the embedding; the Mamba-2 ``A_log`` ramp, ``D`` and norms at one,
biases at zero).  The program and the reference get the same tensors.
"""
from __future__ import annotations

import math

import torch


def _draw(gen, shape, std, dtype, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t.mul_(std)).to(dtype)


def _leaf(path: tuple, shape: tuple, dtype, gen, device):
    name = path[-1]
    full = lambda v: torch.full(shape, v, dtype=dtype, device=device)
    if name == "table":
        return _draw(gen, shape, 0.02, dtype, device)
    if name in ("conv_x", "conv_B", "conv_C"):
        return _draw(gen, shape, 0.1, dtype, device)
    if name == "A_log":
        ramp = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                        dtype=torch.float32, device=device))
        return ramp.expand(shape).to(dtype).contiguous()
    if name in ("D", "scale"):
        return full(1.0)
    if name in ("dt_bias", "b", "bias") or name.endswith("_b"):
        return full(0.0)
    if len(shape) >= 2 and dtype.is_floating_point:
        return _draw(gen, shape, 1.0 / math.sqrt(shape[-2]), dtype, device)
    raise KeyError(f"no initialiser rule for leaf {'/'.join(path)} "
                   f"{shape} {dtype}")


def init_params(layout: dict, seed: int, device) -> dict:
    """The tree of ``layout`` (``{"a/b/c": [shape, dtype]}``), drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for key, (shape, dtype) in layout.items():
        path = tuple(key.split("/"))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _leaf(path, tuple(shape), getattr(torch, dtype),
                               gen, device)
    return tree


def layout(cfg) -> dict:
    """The port's parameter tree for ``cfg`` as ``{"a/b/c": [shape,
    dtype]}``, from ``transformer.init`` on ``meta`` stand-ins."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    return {"/".join(p): [list(t.shape), str(t.dtype).removeprefix("torch.")]
            for p, t in leaves(T.init(cfg, L.SHAPE_ONLY))}


def leaves(tree, path=()):
    """``(path, tensor)`` for every leaf, in the tree's key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


if __name__ == "__main__":
    import json
    import sys
    from pathlib import Path

    sys.path[:0] = [str(Path(__file__).resolve().parents[2] / "src"),
                    str(Path(__file__).resolve().parents[2])]
    from portbench.harness.manifest import model_config
    path = Path(sys.argv[1])
    body = json.loads(path.read_text())
    body["layout"] = layout(model_config(body))
    path.write_text(json.dumps(body, indent=2) + "\n")
