"""Port parity, the MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the reference's own initialised
weights (built under ``threefry_partitionable(False)``, ROADMAP C0),
carried across as NumPy, in float32 at ``configs.reduced`` widths (d_model
64, expert d_ff 128, 4 experts, top 2).

``moe_apply`` within 1e-5 for every FFN kind, at the dropping capacity
factor 1.25 and at the no-drop ``num_experts / top_k``; the slot table
(``idx``, ``wgt``, ``filled``) and the top-k experts equal to the values
the reference computes inside ``moe_apply`` (read off its jaxpr), a case
that drops tokens and the banker's-rounding capacity (n = 4, E = 4, k =
2: 2.5 -> 2) included; ``capacity`` equal to the reference's; top-k ties
to the lower expert; the combine bitwise run to run and equal to a
float32 sum in ascending (expert, slot) order; the drop count; two
expert shards summing to the whole layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch import weights
from repro_torch.models import moe as M

D, FF, E, K = 64, 128, 4, 2
KINDS = ["swiglu", "geglu", "relu2", "gelu"]
NO_DROP = E / K
ATOL = 1e-5


def ref_params(kind="swiglu", e=E):
    with jax.threefry_partitionable(False):
        return JM.moe_init(jax.random.PRNGKey(0), D, FF, e, kind,
                           jnp.float32)


def port(jp):
    return weights.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(shape, seed=1, skew=None):
    """Standard normal tokens; with ``skew`` (the reference's params) each
    is pushed along expert 0's router column so that its logit gains 3,
    and expert 0 overflows at capacity factor 1.25."""
    x = np.random.default_rng(seed).standard_normal(shape + (D,))
    if skew is not None:
        w0 = np.asarray(skew["router"]["w"], np.float64)[:, 0]
        x = x + 3.0 * w0 / (w0 @ w0)
    return x.astype(np.float32)


def reference_taps(jp, x, cf, kind="swiglu"):
    """The reference's ``moe_apply`` evaluated equation by equation over
    its jaxpr: returns its ``(y, aux)`` and, read off the equations that
    compute them, its top-k experts and its ``(idx, wgt, filled)`` slot
    table (the three ``(E + 1, cap)`` scatters, spare row cut)."""
    fn = lambda p, x: JM.moe_apply(p, x, top_k=K, capacity_factor=cf,
                                   kind=kind, compute_dtype=jnp.float32)
    closed = jax.make_jaxpr(fn)(jp, jnp.asarray(x))
    jaxpr, env, taps = closed.jaxpr, {}, {"scatter": []}

    def read(v):
        return v.val if hasattr(v, "val") else env[v]
    args = jax.tree.leaves((jp, jnp.asarray(x)))
    for v, a in zip(jaxpr.constvars, closed.consts):
        env[v] = a
    for v, a in zip(jaxpr.invars, args):
        env[v] = a
    for eqn in jaxpr.eqns:
        sub, params = eqn.primitive.get_bind_params(eqn.params)
        out = eqn.primitive.bind(*sub, *map(read, eqn.invars), **params)
        outs = out if eqn.primitive.multiple_results else [out]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
        if eqn.primitive.name == "top_k":
            taps["gate_idx"] = np.asarray(outs[1])
        elif eqn.primitive.name == "scatter":
            taps["scatter"].append(np.asarray(outs[0])[:-1])
    y, aux = jax.tree.unflatten(jax.tree.structure(fn(jp, jnp.asarray(x))),
                                [read(v) for v in jaxpr.outvars])
    idx, wgt, filled = taps["scatter"]
    assert (idx.dtype, wgt.dtype, filled.dtype) == (np.int32, np.float32,
                                                    np.bool_)
    return y, aux, taps["gate_idx"], idx, wgt, filled


def route(p, x, cf):
    xt = torch.as_tensor(x).reshape(-1, D)
    return M.route(p["router"], xt, num_experts_global=E, expert_offset=0,
                   e_loc=E, top_k=K, capacity_factor=cf)


@pytest.mark.parametrize("cf", [1.25, NO_DROP], ids=["cf1.25", "no-drop"])
@pytest.mark.parametrize("kind", KINDS)
def test_moe_apply_matches_reference(kind, cf):
    jp = ref_params(kind)
    x = tokens((2, 12), skew=jp)
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), top_k=K,
                              capacity_factor=cf, kind=kind,
                              compute_dtype=jnp.float32)
    got, aux = M.moe_apply(port(jp), torch.as_tensor(x), top_k=K,
                           capacity_factor=cf, kind=kind,
                           compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 12, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for name in ("aux_loss", "router_z_loss"):
        assert aux[name].dtype == torch.float32
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=ATOL)


# (tokens shape, capacity factor, capacity, whether assignments drop)
TABLES = {
    "drops-at-1.25": ((2, 12), 1.25, 15, True),
    "bankers-rounding": ((1, 4), 1.25, 2, True),
    "no-drop": ((2, 12), NO_DROP, 24, False),
    "decode-tick": ((3, 1), NO_DROP, 3, False),
}


@pytest.mark.parametrize("case", list(TABLES))
def test_slot_table_matches_reference(case):
    shape, cf, cap, drops = TABLES[case]
    jp = ref_params()
    x = tokens(shape, seed=2, skew=jp)
    _, _, gate_idx, idx, wgt, filled = reference_taps(jp, x, cf)
    r = route(port(jp), x, cf)
    assert r.cap == cap == idx.shape[1] == JM.capacity(
        x.shape[0] * x.shape[1], K, E, cf)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.filled.numpy(), filled)
    # the port's weights are the float64 routing rounded once to float32;
    # the reference's are float32 throughout (softmax, sum, division): a
    # few float32 roundings apart on weights in [0, 1]
    np.testing.assert_allclose(r.wgt.numpy(), wgt, rtol=0, atol=1e-7)
    assert bool((~r.keep).any()) == drops
    assert int(r.aux["dropped"]) == int((~r.keep).sum())
    # the inverse map names each kept assignment's slot, ascending
    assert int((r.inverse < E * cap).sum()) == int(r.keep.sum())
    assert bool((r.inverse[:, 1:] >= r.inverse[:, :-1]).all())


@pytest.mark.parametrize("e,k", [(64, 8), (4, 2), (64, 6)])
def test_capacity_is_the_reference_bankers_rounding(e, k):
    assert M.capacity(80, 8, 64, 1.25) == 12          # 12.5 -> 12
    assert M.capacity(4, 2, 4, 1.25) == 2             # 2.5 -> 2
    for n in range(1, 600):
        for cf in (1.25, e / k, 1.0):
            assert M.capacity(n, k, e, cf) == JM.capacity(n, k, e, cf)


def test_top_k_ties_go_to_the_lower_expert():
    """Experts 0 and 2, and 1 and 3, have equal router columns, so every
    token's probabilities tie in pairs; and all-zero tokens tie all four.
    The reference's ``jax.lax.top_k`` and the port's stable sort both
    take the lower id first."""
    jp = ref_params()
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 2], w[:, 3] = w[:, 0], w[:, 1]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    x = tokens((2, 6), seed=3)
    x[0, :3] = 0.0
    _, _, gate_idx, idx, _, filled = reference_taps(jp, x, NO_DROP)
    r = route(port(jp), x, NO_DROP)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.filled.numpy(), filled)
    assert r.gate_idx[:3].tolist() == [[0, 1]] * 3
    assert all(row in ([0, 2], [1, 3]) for row in r.gate_idx[3:].tolist())


@pytest.mark.parametrize("cf", [1.25, NO_DROP], ids=["cf1.25", "no-drop"])
def test_combine_is_a_fixed_order_sum(cf):
    """Bitwise the same run to run, and bitwise a float32 sum of each
    token's kept, weighted expert rows in ascending (expert, slot) order
    from zero, computed here slot by slot."""
    jp = ref_params()
    p = port(jp)
    x = tokens((2, 12), seed=4, skew=jp)
    xt = torch.as_tensor(x)
    runs = [M.moe_apply(p, xt, top_k=K, capacity_factor=cf,
                        compute_dtype=torch.float32)[0] for _ in range(3)]
    for y in runs[1:]:
        assert torch.equal(y.view(torch.int32), runs[0].view(torch.int32))
    r = route(p, x, cf)
    xe = xt.reshape(-1, D)[r.idx] * r.filled[..., None]
    ye = M._expert_ffn(p, xe, "swiglu", torch.float32) * r.wgt[..., None]
    want = np.zeros((24, D), np.float32)
    for e in range(E):
        for c in range(r.cap):
            if r.filled[e, c]:
                t = int(r.idx[e, c])
                want[t] = want[t] + ye[e, c].numpy()
    np.testing.assert_array_equal(runs[0].reshape(24, D).numpy(), want)


def test_expert_shards_sum_to_the_whole_layer():
    """Two shards of two experts each (``expert_offset`` 0 and 2, the
    router over all four): each shard routes as the whole layer does, and
    their outputs sum to it."""
    jp = ref_params()
    p = port(jp)
    x = torch.as_tensor(tokens((2, 12), seed=5, skew=jp))
    whole, aux = M.moe_apply(p, x, top_k=K, compute_dtype=torch.float32)
    parts, dropped = [], 0
    for off in (0, 2):
        local = {n: (t if n == "router" else t[off:off + 2])
                 for n, t in p.items()}
        y, a = M.moe_apply_local(local, x, num_experts_global=E,
                                 expert_offset=off, top_k=K,
                                 compute_dtype=torch.float32)
        parts.append(y)
        dropped += int(a["dropped"])
        assert torch.equal(a["aux_loss"], aux["aux_loss"])
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(),
                               rtol=0, atol=1e-6)
    assert dropped == int(aux["dropped"]) > 0


def test_init_layout_matches_reference():
    """Leaf names, shapes and dtypes of ``moe_init``: the router float32,
    the experts in the dtype asked for (bf16 kept), ``w_gate`` only for
    the gated kinds."""
    for kind in KINDS:
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            with jax.threefry_partitionable(False):
                jp = JM.moe_init(jax.random.PRNGKey(0), D, FF, E, kind, jdt)
            tp = M.moe_init(torch.Generator().manual_seed(0), D, FF, E, kind,
                            tdt)
            assert set(tp) == set(jp)
            for n in tp:
                jl, tl = jax.tree.leaves(jp[n]), list(
                    tp[n].values() if isinstance(tp[n], dict) else [tp[n]])
                assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
                assert [str(t.dtype)[6:] for t in tl] == [
                    str(j.dtype) for j in jl]
