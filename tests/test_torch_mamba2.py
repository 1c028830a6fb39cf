"""Port parity, the Mamba-2 block (``repro_torch.models.mamba2``) against
the reference's ``repro.models.mamba2`` in float32 on the same numpy
inputs and on the reference's own initialised parameters (carried across
by ``weights.lm_params_from_numpy``): the decode step, the causal conv,
the full block through both scans (its own ``ssd_chunked`` and the SSD
scan kernel's entry point) and the one-token decode, within 1e-5; the init
layout of both families (``ssm``, ``hybrid``) against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.pytree import tree_leaves

ATOL = 1e-5         # float32, the same algorithm in both packages
ARCHS = ["mamba2-780m", "zamba2-1.2b"]


def rng(seed):
    return np.random.default_rng(seed)


def normal(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def layer0(arch):
    """(reference cfg, port cfg, reference layer-0 mamba params, the same
    as the port's tensors), float32 at reduced width."""
    kw = dict(compute_dtype="float32", param_dtype="float32")
    jcfg, cfg = JC.reduced(JC.get(arch), **kw), C.reduced(C.get(arch), **kw)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["mamba"])
    # dt_bias, D and the conv biases start at 0, 1 and 0: give them a
    # spread
    r = rng(3)
    jl = dict(jl, dt_bias=jnp.asarray(normal(r, *jl["dt_bias"].shape)),
              D=jnp.asarray(normal(r, *jl["D"].shape)),
              conv_x_b=jnp.asarray(0.1 * normal(r, *jl["conv_x_b"].shape)))
    return jcfg, cfg, jl, weights.lm_params_from_numpy(
        jax.tree.map(np.asarray, jl), "cpu")


def test_ssd_decode_step_matches_reference():
    r = rng(0)
    b, h, p, g, n = 3, 4, 8, 2, 16
    state, x = normal(r, b, h, n, p), normal(r, b, h, p)
    dt = np.logaddexp(normal(r, b, h), 0).astype(np.float32)
    A = -np.exp(normal(r, h))
    B, Cm = normal(r, b, g, n), normal(r, b, g, n)
    want = JM.ssd_decode_step(*map(jnp.asarray, (state, x, dt, A, B, Cm)))
    got = M.ssd_decode_step(*map(torch.from_numpy,
                                 (state, x, dt, A, B, Cm)))
    for g_, w_ in zip(got, want):
        close(g_, w_)


def test_causal_conv_matches_reference():
    r = rng(1)
    u, w, b = normal(r, 2, 9, 12), normal(r, 4, 12), normal(r, 12)
    close(M._causal_conv(*map(torch.from_numpy, (u, w, b))),
          JM._causal_conv(*map(jnp.asarray, (u, w, b))))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan", ["ssd_chunked", "kernel"])
def test_mamba_apply_matches_reference(arch, scan):
    """The full-sequence block over a ragged chunk (S = 45, chunk 32), the
    port's scan either its own ``ssd_chunked`` or the kernel's entry point
    (its plain version here): output, final state and conv tails."""
    jcfg, cfg, jl, pl = layer0(arch)
    xin = normal(rng(2), 2, 45, cfg.d_model)
    want, jst = JM.mamba_apply(jl, jnp.asarray(xin), jcfg, chunk=32,
                               compute_dtype=jnp.float32)
    impl = M.ssd_chunked if scan == "ssd_chunked" else ssd_ops.ssd_scan
    got, st = M.mamba_apply(pl, torch.from_numpy(xin), cfg, chunk=32,
                            compute_dtype=torch.float32, ssm_impl=impl)
    close(got, want)
    close(st["ssm"], jst["ssm"])
    for k in ("x", "B", "C"):
        close(st["conv"][k], jst["conv"][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_matches_reference(arch):
    jcfg, cfg, jl, pl = layer0(arch)
    d_inner, pdim, nh, g, n = M.mamba_dims(cfg)
    r = rng(4)
    xin = normal(r, 3, 1, cfg.d_model)
    conv = {"x": normal(r, 3, 3, d_inner), "B": normal(r, 3, 3, g * n),
            "C": normal(r, 3, 3, g * n)}
    ssm = normal(r, 3, nh, n, pdim)
    want = JM.mamba_decode(jl, jnp.asarray(xin),
                           jax.tree.map(jnp.asarray, conv), jnp.asarray(ssm),
                           jcfg, compute_dtype=jnp.float32)
    tconv = {k: torch.from_numpy(v) for k, v in conv.items()}
    tssm = torch.from_numpy(ssm)
    got = M.mamba_decode(pl, torch.from_numpy(xin), tconv, tssm, cfg,
                         compute_dtype=torch.float32)
    close(got[0], want[0])
    for k in ("x", "B", "C"):
        close(got[1][k], want[1][k])
    close(got[2], want[2])
    # the inputs are not written
    assert np.array_equal(tssm.numpy(), ssm)
    assert np.array_equal(tconv["x"].numpy(), conv["x"])


def test_short_prompt_conv_tail_is_zero_padded():
    """A prompt shorter than CONV_W - 1 leaves zeros before its first input
    in the decode conv's state (ROADMAP C4), so decode continues it as
    the full-sequence conv does."""
    u = torch.arange(1.0, 7.0).reshape(1, 2, 3)
    tail = M._conv_tail(u)
    assert tail.shape == (1, 3, 3)
    assert not tail[:, 0].any() and torch.equal(tail[:, 1:], u)
    long = torch.arange(15.0).reshape(1, 5, 3)
    assert torch.equal(M._conv_tail(long), long[:, -3:])


def leaf_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(leaf_specs(v, name))
        else:
            out[name] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("over", [{}, {"param_dtype": "float32"}],
                         ids=["published", "float32"])
def test_init_tree_matches_reference_layout(arch, over):
    """Names, shapes and dtypes of both families' trees (the reference's
    float32 promotion of full-rank projections, ROADMAP C2, included); the
    reference's deterministic leaves equal."""
    jcfg = JC.reduced(JC.get(arch), **over)
    cfg = C.reduced(C.get(arch), **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    tp = T.init(cfg, torch.Generator().manual_seed(0))
    assert leaf_specs(tp) == leaf_specs(jax.tree.map(np.asarray, jp))
    want = weights.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for name in ("dt_bias", "D", "conv_x_b"):
        assert torch.equal(tp["blocks"]["mamba"][name],
                           want["blocks"]["mamba"][name]), name
    # log(linspace(1, 16, H)): the two libraries' linspace and log may
    # round one float32 ulp apart
    close(tp["blocks"]["mamba"]["A_log"], want["blocks"]["mamba"]["A_log"],
          atol=1e-6)
    assert ("shared" in tp) == (arch == "zamba2-1.2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_carries_mamba_leaves(arch):
    """The published (bfloat16) trees cross bit for bit, every leaf with
    its dtype: the float32 A_log / dt_bias / D and projections, the
    bfloat16 conv weights and norms."""
    jcfg = JC.reduced(JC.get(arch))
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    tp = weights.lm_params_from_numpy(npt, "cpu")
    flat = jax.tree_util.tree_leaves(npt)
    leaves = list(tree_leaves(tp))
    assert len(leaves) == len(flat)
    assert leaf_specs(tp) == leaf_specs(npt)
    dtypes = {str(t.dtype) for t in leaves}
    assert dtypes == {"torch.float32", "torch.bfloat16"}
    for name in ("conv_x", "A_log", "x_proj"):
        t = tp["blocks"]["mamba"][name]
        t = t["w"] if isinstance(t, dict) else t
        a = npt["blocks"]["mamba"][name]
        a = a["w"] if isinstance(a, dict) else a
        assert np.array_equal(t.float().numpy(), a.astype(np.float32))
