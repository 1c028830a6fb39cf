"""Shared helpers of the port's LM training parity tests (not a test
module): the reference models-smoke batch, reduced float32 configs of
both packages on the reference's own initialised tree, and the port's
value and gradient of ``transformer.train_loss``."""
import jax
import numpy as np
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.models import transformer as T
from repro_torch.pytree import tree_leaves, tree_map

F32 = dict(compute_dtype="float32", param_dtype="float32")


def smoke_batch(cfg, B=2, S=16):
    """``tests/test_models_smoke.py``'s ``_batch``."""
    rng = np.random.default_rng(0)
    b = {}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def reference_setup(arch, **over):
    jcfg = JC.reduced(JC.get(arch), **F32, **over)
    cfg = C.reduced(C.get(arch), **F32, **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    p = weights.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, p


def keyed(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(keyed(v, f"{path}/{k}"))
        return out
    return {path: tree}


def port_value_and_grad(cfg, p, batch):
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    loss, metrics = T.train_loss(cfg, live, batch)
    leaves = list(tree_leaves(live))
    grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), live))
