"""Port parity, the LM building blocks: each function of
``repro_torch.models.layers`` and ``attention`` against the reference's on
the same numpy inputs, in float32 (1e-5), and ``transformer.init``'s tree
against the reference's leaf names, shapes and dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.pytree import tree_map

ATOL = 1e-5
F32 = jnp.float32


def rng(seed):
    return np.random.default_rng(seed)


def normal(r, *shape, scale=1.0):
    return (scale * r.standard_normal(shape)).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def both(tree):
    """The same numpy tree for the reference (jnp) and the port (torch)."""
    return (jax.tree.map(jnp.asarray, tree),
            tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("rank", [None, 4])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_apply(rank, bias):
    r = rng(0)
    p = ({"w": normal(r, 24, 40, scale=0.2)} if rank is None else
         {"w1": normal(r, 24, rank, scale=0.3), "w2": normal(r, rank, 40)})
    if bias:
        p["b"] = normal(r, 40)
    x = normal(r, 3, 5, 24)
    jp, tp = both(p)
    close(L.dense_apply(tp, torch.from_numpy(x), compute_dtype=torch.float32),
          JL.dense_apply(jp, jnp.asarray(x), compute_dtype=F32))


def test_norms():
    r = rng(1)
    x = normal(r, 2, 7, 32, scale=3.0)
    p = {"scale": normal(r, 32), "bias": normal(r, 32)}
    jp, tp = both(p)
    close(L.rmsnorm_apply({"scale": tp["scale"]}, torch.from_numpy(x), 1e-5),
          JL.rmsnorm_apply({"scale": jp["scale"]}, jnp.asarray(x), 1e-5))
    close(L.layernorm_apply(tp, torch.from_numpy(x)),
          JL.layernorm_apply(jp, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    r = rng(2)
    x = normal(r, 2, 9, 4, 16)
    pos = r.integers(0, 300, (2, 9)).astype(np.int32)
    close(L.rope_freqs(16, theta), JL.rope_freqs(16, theta))
    close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_apply(kind):
    r = rng(3)
    names = ("w_gate", "w_in", "w_out") if kind in ("swiglu", "geglu") \
        else ("w_in", "w_out")
    p = {n: {"w": normal(r, 32, 48, scale=0.2) if n != "w_out"
             else normal(r, 48, 32, scale=0.2)} for n in names}
    x = normal(r, 2, 5, 32)
    jp, tp = both(p)
    close(L.mlp_apply(tp, torch.from_numpy(x), kind,
                      compute_dtype=torch.float32),
          JL.mlp_apply(jp, jnp.asarray(x), kind, compute_dtype=F32))


def test_embed_unembed():
    r = rng(4)
    table = normal(r, 50, 16, scale=0.1)
    toks = r.integers(0, 50, (3, 7))
    x = normal(r, 3, 7, 16)
    jp, tp = both({"table": table})
    close(L.embed_apply(tp, torch.from_numpy(toks), torch.float32),
          JL.embed_apply(jp, jnp.asarray(toks), F32))
    close(L.unembed_apply(tp, torch.from_numpy(x), torch.float32),
          JL.unembed_apply(jp, jnp.asarray(x), F32))


@pytest.mark.parametrize("causal,window,masked", [
    (True, None, False), (False, None, False), (True, 5, False),
    (False, None, True), (True, 4, True)])
def test_attention_scores(causal, window, masked):
    r = rng(5)
    q, k, v = (normal(r, 2, 11, 4, 8) for _ in range(3))
    mask = r.random((2, 11)) > 0.3 if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    close(A.attention_scores(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window,
                             kv_len_mask=mask_t),
          JA.attention_scores(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window, kv_len_mask=mask_j))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 20)])
def test_chunked_attention(causal, window):
    """S = 64 with chunks that do not divide it, so both pads run."""
    r = rng(6)
    q, k, v = (normal(r, 2, 64, 4, 8) for _ in range(3))
    got = A.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal,
                              window, 24, 20)
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), causal,
                                window, 24, 20)
    close(got, want)
    # and the full-score path on the same inputs
    close(got, A.attention_scores(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window))


def test_attn_apply_takes_the_chunked_path_past_the_threshold(monkeypatch):
    r = rng(7)
    cfg = C.reduced(C.get("qwen2-1.5b"), compute_dtype="float32",
                    param_dtype="float32")
    jcfg = JC.reduced(JC.get("qwen2-1.5b"), compute_dtype="float32",
                      param_dtype="float32")
    d, hd = cfg.d_model, cfg.head_dim
    p = {"q": {"w": normal(r, d, 4 * hd, scale=0.1), "b": normal(r, 4 * hd)},
         "k": {"w": normal(r, d, 2 * hd, scale=0.1), "b": normal(r, 2 * hd)},
         "v": {"w": normal(r, d, 2 * hd, scale=0.1), "b": normal(r, 2 * hd)},
         "o": {"w": normal(r, 4 * hd, d, scale=0.1)}}
    x = normal(r, 1, 40, d)
    pos = np.arange(40)[None]
    jp, tp = both(p)
    monkeypatch.setattr(JA, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(A, "CHUNKED_THRESHOLD", 32)
    got, (k, v) = A.attn_apply(tp, torch.from_numpy(x), torch.from_numpy(pos),
                               cfg, compute_dtype=torch.float32)
    want, (jk, jv) = JA.attn_apply(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                   compute_dtype=F32)
    close(got, want)
    close(k, jk)
    close(v, jv)


def leaf_specs(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_specs(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = (tuple(v.shape), str(v.dtype).replace(
                "torch.", ""))
    return out


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2-1.5b",
                                  "olmoe-1b-7b"])
@pytest.mark.parametrize("over", [{}, {"param_dtype": "float32"},
                                  {"lsq_rank": 4}],
                         ids=["published", "float32", "low-rank"])
def test_init_tree_matches_reference_layout(arch, over):
    """Names, shapes and dtypes, the reference's promotion of full-rank
    weights drawn at the default std to float32 included (ROADMAP C2; a
    ``moe`` block's experts keep the param dtype, its router is
    float32)."""
    jcfg = JC.reduced(JC.get(arch), **over)
    cfg = C.reduced(C.get(arch), **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    tp = T.init(cfg, torch.Generator().manual_seed(0))
    assert leaf_specs(tp) == leaf_specs(jp)
    # biases start at zero and norm scales at one, as in the reference
    assert not tp["blocks"]["attn"]["q"].get("b", torch.zeros(1)).any()
    assert bool((tp["final_norm"]["scale"] == 1).all())


def test_truncated_normal_is_seeded_and_bounded():
    a = L.truncated_normal(torch.Generator().manual_seed(3), (4000,), 0.5)
    b = L.truncated_normal(torch.Generator().manual_seed(3), (4000,), 0.5)
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0 and 0.3 < float(a.std()) < 0.5
