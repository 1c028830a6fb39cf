"""The port's sharding rules (``launch/sharding.py``, ``launch/mesh.py``)
against the reference's, spec by spec, for every arch, on the port's
``meta`` stand-ins (``registry.abstract_params`` / ``abstract_opt`` /
``abstract_cache``) against the reference's ``eval_shape``s, over meshes
(4, 2), (2, 4), (16, 16) and (2, 16, 16): shape-only meshes on both sides
(``MeshShape``; ``jax.sharding.AbstractMesh``), so no process starts."""
import jax
import pytest
from jax.sharding import AbstractMesh

import repro.configs as JC
from repro.launch import mesh as JM
from repro.launch import sharding as JS
from repro.models import registry as JR
from repro.train.optimizer import AdamConfig as JAdam
from repro_torch import configs as C
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models import registry as R
from repro_torch.train.optimizer import AdamConfig

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    sizes, names = MESHES[name]
    return M.MeshShape(names, sizes), AbstractMesh(sizes, names)


def keyed_port(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(keyed_port(v, f"{path}[{k!r}]"))
        return out
    return {path: tuple(tree)}


def keyed_ref(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_spec_functions_equal_reference(arch, mesh):
    pm, jm = meshes(mesh)
    cfg, jcfg = C.get(arch), JC.get(arch)
    ap, jap = R.abstract_params(cfg), JR.abstract_params(jcfg)
    assert (M.batch_axes(pm), M.batch_shards(pm), M.tp_size(pm)) == (
        JM.batch_axes(jm), JM.batch_shards(jm), JM.tp_size(jm))
    for kw in ({}, {"seq_parallel": True}, {"mode": "sp_dense", "cfg": cfg}):
        jkw = dict(kw, cfg=jcfg) if "cfg" in kw else kw
        got = S.param_pspecs(ap, pm, **kw)
        want = JS.param_pspecs(jap, jm, **jkw)
        assert keyed_port(got) == keyed_ref(want)
    got = S.opt_pspecs(R.abstract_opt(cfg, AdamConfig()),
                       S.param_pspecs(ap, pm))
    want = JS.opt_pspecs(JR.abstract_opt(jcfg, JAdam()),
                         JS.param_pspecs(jap, jm))
    assert keyed_port(got) == keyed_ref(want)
    for name, shape in C.SHAPES.items():
        jshape = JC.SHAPES[name]
        for sp in (False, True):
            assert keyed_port(S.batch_pspecs(cfg, shape, pm, seq_parallel=sp)) \
                == keyed_ref(JS.batch_pspecs(jcfg, jshape, jm,
                                             seq_parallel=sp))
        assert S.use_splitkv(cfg, shape, pm) == JS.use_splitkv(jcfg, jshape,
                                                               jm)
        assert S.use_seq_parallel(cfg, shape, pm) == JS.use_seq_parallel(
            jcfg, jshape, jm)
        assert S.parallel_mode(cfg, shape, pm) == JS.parallel_mode(
            jcfg, jshape, jm)
        assert tuple(S.logits_pspec(cfg, shape, pm)) == tuple(
            JS.logits_pspec(jcfg, jshape, jm))
        if shape.kind == "decode" and JC.applicable(jcfg, jshape)[0]:
            got = S.cache_pspecs(cfg, shape, pm, R.abstract_cache(cfg, shape))
            want = JS.cache_pspecs(jcfg, jshape, jm,
                                   JR.abstract_cache(jcfg, jshape))
            assert keyed_port(got) == keyed_ref(want)


def test_named_placements_and_local_blocks():
    """``named`` puts Shard(i) on each mesh axis a spec names for tensor
    dim i (a tuple of axes: each of them, the first major) and Replicate
    elsewhere; a spec is a tuple in the reference's spelling."""
    from torch.distributed.tensor import Replicate, Shard
    pm, _ = meshes("2x16x16")
    s = S.named(pm, {"w": S.P(("pod", "data"), None, "model"),
                     "b": S.P(None)})
    assert s["w"].placements == (Shard(0), Shard(0), Shard(2))
    assert s["b"].placements == (Replicate(),) * 3
    assert S.P("data", None) == ("data", None)
    assert repr(S.P("data", None)) == "P('data', None)"
