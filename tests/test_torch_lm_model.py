"""Port parity, the LM (``repro_torch.models.transformer``) for reduced
deepseek-7b (``dense``, untied head, MHA), qwen2-1.5b (``dense``, tied
embeddings, GQA, QKV bias), olmoe-1b-7b and moonshot-v1-16b-a3b
(``moe``, at the no-drop capacity factor ``num_experts / top_k`` as the
reference's ``tests/test_decode_consistency.py`` runs them, and at the
default 1.25, where a prefill drops tokens in both packages),
mamba2-780m (``ssm``) and zamba2-1.2b
(``hybrid``: mamba layers and one shared attention + MLP block), in
float32 on the reference's own initialised parameters: ``forward``,
``prefill``, ``decode_step``, ``prefill_into_slot`` and
``decode_step_slotted`` against the reference's, caches included (logits
within 1e-4, the reference's bound in ``tests/test_decode_consistency.py``);
the port's decode against its own forward (mirror of that file's
``test_decode_matches_forward``, ``test_prefill_then_decode_continuous``
and ``test_sliding_window_decode_matches_windowed_forward``); an inactive
slot kept bit for bit; the audio family's decode refused in both
packages.  The ``vlm`` and ``audio`` parity cases are in
``tests/test_torch_lm_frontends.py``.  The mamba
layers' scans run through the SSD scan kernel's entry point, its plain
version here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.models import transformer as T

ATOL = 1e-4
MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
ARCHS = ["deepseek-7b", "qwen2-1.5b", *MOE, "mamba2-780m", "zamba2-1.2b"]


def setup(arch, drop=False):
    """Reduced float32 configs of both packages, the reference's init tree
    and its port, and (2, 12) tokens.  A ``moe`` config gets the no-drop
    capacity factor, as the reference's tests give it, unless ``drop``."""
    over = dict(compute_dtype="float32", param_dtype="float32")
    jcfg = JC.reduced(JC.get(arch), **over)
    cfg = C.reduced(C.get(arch), **over)
    if cfg.family == "moe" and not drop:
        cf = cfg.num_experts / cfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    p = weights.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    return jcfg, jp, cfg, p, toks


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def tk(a):
    return torch.as_tensor(np.asarray(a))


def cache_leaves(cache):
    """{name: tensor} of a cache's K/V, SSM and conv tensors (each family
    has its own subset)."""
    out = {n: cache[n] for n in ("k", "v", "ssm")
           if cache.get(n) is not None}
    out.update({f"conv.{n}": t for n, t in cache.get("conv", {}).items()})
    return out


def close_caches(cache, jcache):
    got, want = cache_leaves(cache), cache_leaves(jcache)
    assert set(got) == set(want)
    for name in got:
        close(got[name], want[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jcfg, jp, cfg, p, toks = setup(arch)
    want, jaux, jcaches = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                     emit_caches=True)
    got, aux, caches = T.forward(cfg, p, {"tokens": tk(toks)},
                                 emit_caches=True)
    assert got.dtype == torch.float32 and got.shape == (2, 12,
                                                        cfg.vocab_size)
    close(got, want)
    close_caches(caches, jcaches)
    if cfg.family == "moe":
        for name in ("aux_loss", "router_z_loss"):
            np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                       rtol=1e-5)
        assert int(aux["dropped"]) == 0
    else:
        assert float(aux["aux_loss"]) == 0.0
    want, jcache = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :7])},
                              max_len=16)
    got, cache = T.prefill(cfg, p, {"tokens": tk(toks[:, :7])}, max_len=16)
    close(got, want)
    close_caches(cache, jcache)
    assert cache["len"] == int(jcache["len"]) == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_and_forward(arch):
    """Token by token from an empty cache: each logit row within 1e-4 of
    the reference's decode and of the port's own forward."""
    jcfg, jp, cfg, p, toks = setup(arch)
    full, _, _ = T.forward(cfg, p, {"tokens": tk(toks)})
    jcache = JT.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        want, jcache = JT.decode_step(jcfg, jp, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        got, cache = T.decode_step(cfg, p, cache, tk(toks[:, t:t + 1]))
        close(got, want)
        close(got[:, 0], full[:, t].numpy())
    close_caches(cache, jcache)
    assert cache["len"] == int(jcache["len"]) == toks.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continuous(arch):
    jcfg, jp, cfg, p, toks = setup(arch)
    full, _, _ = T.forward(cfg, p, {"tokens": tk(toks)})
    half = 6
    _, cache = T.prefill(cfg, p, {"tokens": tk(toks[:, :half])}, max_len=16)
    for t in range(half, toks.shape[1]):
        lg, cache = T.decode_step(cfg, p, cache, tk(toks[:, t:t + 1]))
        close(lg[:, 0], full[:, t].numpy())


def slotted_run(T_mod, cfg, p, toks, conv, cache):
    """Admit two sequences into slots 0 and 2 of a 3-slot cache at prompt
    lengths 5 and 7, then 5 ticks with slot 1 empty and slot 2 idle on the
    third; returns the per-tick logits and caches."""
    out = []
    for slot, row, n in ((0, 0, 5), (2, 1, 7)):
        lg, cache = T_mod.prefill_into_slot(
            cfg, p, cache, {"tokens": conv(toks[row:row + 1, :n])}, slot)
        out.append(lg)
    fed = [5, 7]
    for t in range(5):
        active = np.array([True, False, t != 2])
        nxt = np.zeros((3, 1), np.int64)
        nxt[0, 0] = toks[0, fed[0]]
        nxt[2, 0] = toks[1, fed[1]]
        lg, cache = T_mod.decode_step_slotted(cfg, p, cache, conv(nxt),
                                              conv(active))
        fed[0] += 1
        fed[1] += int(active[2])
        out.append(lg)
        out.append(cache["pos"] + 0)  # a copy: the port advances pos in place
    return out, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_slotted_prefill_and_decode_match_reference(arch):
    jcfg, jp, cfg, p, toks = setup(arch)
    want, jcache = slotted_run(
        JT, jcfg, jp, toks, jnp.asarray,
        JT.init_slot_cache(jcfg, 3, 16, dtype=jnp.float32))
    got, cache = slotted_run(
        T, cfg, p, toks, tk, T.init_slot_cache(cfg, 3, 16,
                                               dtype=torch.float32,
                                               device="cpu"))
    for g, w in zip(got, want):
        close(g, w)
    close_caches(cache, jcache)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() \
        == [10, 0, 11]


@pytest.mark.parametrize("arch", ARCHS)
def test_slotted_decode_matches_own_forward(arch):
    _, _, cfg, p, toks = setup(arch)
    full, _, _ = T.forward(cfg, p, {"tokens": tk(toks)})
    cache = T.init_slot_cache(cfg, 2, 16, dtype=torch.float32,
                                device="cpu")
    for slot, n in ((0, 4), (1, 9)):
        lg, cache = T.prefill_into_slot(cfg, p, cache,
                                        {"tokens": tk(toks[slot:slot + 1, :n])},
                                        slot)
        close(lg[0], full[slot, :n].numpy())
    fed = [4, 9]
    for _ in range(3):
        nxt = tk([[toks[0, fed[0]]], [toks[1, fed[1]]]])
        lg, cache = T.decode_step_slotted(cfg, p, cache, nxt)
        for s in (0, 1):
            close(lg[s, 0], full[s, fed[s]].numpy())
            fed[s] += 1
    # the hidden states the quantized-head engine takes, and its rows' head
    h, _ = T.decode_step_slotted(cfg, p, cache, tk([[1], [2]]),
                                 return_hidden=True)
    assert h.shape == (2, 1, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_slot_is_kept_bit_for_bit(arch):
    _, _, cfg, p, toks = setup(arch)
    cache = T.init_slot_cache(cfg, 2, 16, dtype=torch.float32,
                                device="cpu")
    for slot in (0, 1):
        _, cache = T.prefill_into_slot(
            cfg, p, cache, {"tokens": tk(toks[slot:slot + 1, :6])}, slot)
    before = {n: t.clone() for n, t in cache_leaves(cache).items()}
    _, cache = T.decode_step_slotted(cfg, p, cache, tk([[3], [4]]),
                                     tk([True, False]))
    for name, t in cache_leaves(cache).items():
        assert torch.equal(t[:, 1].view(torch.int32),
                           before[name][:, 1].view(torch.int32)), name
        assert not torch.equal(t[:, 0], before[name][:, 0]), name
    assert cache["pos"].tolist() == [7, 6]
    if "k" in cache:
        # a row whose fill level is past the K/V cache writes no K/V either
        cache["pos"][1] = 16
        before = cache["k"].clone()
        _, cache = T.decode_step_slotted(cfg, p, cache, tk([[3], [4]]))
        assert torch.equal(cache["k"][:, 1], before[:, 1])
    # and reset_cache_slot zeroes one slot's rows only (SSM and conv too)
    cache = T.reset_cache_slot(cfg, cache, 1)
    assert int(cache["pos"][1]) == 0
    for name, t in cache_leaves(cache).items():
        assert not t[:, 1].any() and t[:, 0].any(), name


def test_sliding_window_decode_matches_windowed_forward():
    """Mirror of the reference's test on zamba2-1.2b (the shared block's
    attention over a window of 4): the port's windowed forward against the
    reference's, and its decode, plain and slotted, against that forward."""
    jcfg, jp, cfg, p, toks = setup("zamba2-1.2b")
    w = 4
    want, _, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            window=w)
    full, _, _ = T.forward(cfg, p, {"tokens": tk(toks)}, window=w)
    close(full, want)
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        lg, cache = T.decode_step(cfg, p, cache, tk(toks[:, t:t + 1]),
                                  window=w)
        close(lg[:, 0], full[:, t].numpy())
    cache = T.init_slot_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for slot in (0, 1):
        _, cache = T.prefill_into_slot(
            cfg, p, cache, {"tokens": tk(toks[slot:slot + 1, :6])}, slot,
            window=w)
    for t in range(6, toks.shape[1]):
        lg, cache = T.decode_step_slotted(cfg, p, cache, tk(toks[:, t:t + 1]),
                                          window=w)
        close(lg[:, 0], full[:, t].numpy())


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_prompt_shorter_than_the_conv_continues_forward(arch):
    """A 2-token prompt (shorter than the conv's 3-sample state) prefilled,
    then decoded: the logits follow the forward pass (ROADMAP C4: the
    reference keeps a 2-row conv state there)."""
    _, _, cfg, p, toks = setup(arch)
    full, _, _ = T.forward(cfg, p, {"tokens": tk(toks)})
    _, cache = T.prefill(cfg, p, {"tokens": tk(toks[:, :2])}, max_len=16)
    for t in range(2, 8):
        lg, cache = T.decode_step(cfg, p, cache, tk(toks[:, t:t + 1]))
        close(lg[:, 0], full[:, t].numpy())


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_drops_tokens_like_reference(arch):
    """At the default capacity factor 1.25 a full-sequence pass drops
    (token, expert) assignments; the port drops the reference's (the
    logits and aux losses agree), through ``forward``, ``prefill`` and
    ``prefill_into_slot``, and counts them."""
    jcfg, jp, cfg, p, toks = setup(arch, drop=True)
    assert cfg.capacity_factor == 1.25
    want, jaux, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, aux, _ = T.forward(cfg, p, {"tokens": tk(toks)})
    close(got, want)
    for name in ("aux_loss", "router_z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-5)
    assert int(aux["dropped"]) > 0
    want, _ = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=16)
    got, _ = T.prefill(cfg, p, {"tokens": tk(toks)}, max_len=16)
    close(got, want)
    want, jcache = slotted_run(
        JT, jcfg, jp, toks, jnp.asarray,
        JT.init_slot_cache(jcfg, 3, 16, dtype=jnp.float32))
    got, cache = slotted_run(
        T, cfg, p, toks, tk, T.init_slot_cache(cfg, 3, 16,
                                               dtype=torch.float32,
                                               device="cpu"))
    for g, w in zip(got, want):
        close(g, w)
    close_caches(cache, jcache)


@pytest.mark.parametrize("fn", ["decode_step", "decode_step_slotted"])
def test_audio_has_no_decode_path(fn):
    """The audio family is an encoder: both decode paths raise
    ``ValueError`` in both packages.  The reference looks its embedding up
    before it reaches its family check, so both are given a tree with an
    embedding table beside the audio tree's leaves."""
    over = dict(compute_dtype="float32", param_dtype="float32")
    jcfg = JC.reduced(JC.get("hubert-xlarge"), **over)
    cfg = C.reduced(C.get("hubert-xlarge"), **over)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    assert "embed" not in jp
    table = np.zeros((cfg.vocab_size, cfg.d_model), np.float32)
    jp = dict(jp, embed={"table": jnp.asarray(table)})
    p = weights.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.ones((2, 1), np.int32)
    if fn == "decode_step":
        jcache = JT.init_cache(jcfg, 2, 4, dtype=jnp.float32)
        cache = T.init_cache(cfg, 2, 4, dtype=torch.float32, device="cpu")
    else:
        jcache = JT.init_slot_cache(jcfg, 2, 4, dtype=jnp.float32)
        cache = T.init_slot_cache(cfg, 2, 4, dtype=torch.float32,
                                  device="cpu")
    assert cache["k"].shape == jcache["k"].shape   # the encoder's K/V cache
    msgs = []
    for call in (lambda: getattr(JT, fn)(jcfg, jp, jcache,
                                         jnp.asarray(toks)),
                 lambda: getattr(T, fn)(cfg, p, cache, tk(toks))):
        with pytest.raises(ValueError, match="decode path for family") as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_configs_are_the_reference_data():
    import dataclasses
    assert list(C.ARCHS) == list(JC.ARCHS)
    for name, cfg in C.ARCHS.items():
        want = dataclasses.asdict(JC.ARCHS[name])
        assert dataclasses.asdict(cfg) == want, name
        assert C.reduced(cfg) == C.reduced(cfg)
        assert dataclasses.asdict(C.reduced(cfg)) == dataclasses.asdict(
            JC.reduced(JC.ARCHS[name]))
        assert cfg.pdtype == getattr(torch, cfg.param_dtype)
    assert C.applicable(C.get("qwen2-1.5b"), C.SHAPES["long_500k"]) == \
        JC.applicable(JC.get("qwen2-1.5b"), JC.SHAPES["long_500k"])
