"""Port parity, the ``vlm`` and ``audio`` families of the LM assembly
(``repro_torch.models.transformer``) and the engine's ``extra`` inputs
(``repro_torch.serve.engine``): reduced internvl2-76b (patch embeddings in
front of the text, logits and caches counting the patches) and
hubert-xlarge (a bidirectional encoder over frame embeddings, a head with
a bias), in float32 on the reference's own initialised trees.

Logits within 1e-4 of the reference's ``forward`` (the audio encoder at
1,100 frames and at 2,100, where attention takes the chunked path with
both its q and k chunks padded); the vlm ``prefill`` cache ``len`` and
``prefill_into_slot`` ``pos`` equal the reference's; the vlm decode
within 1e-4 of the reference's ``decode_step`` and the slotted decode
within 1e-3 of ``forward``; greedy generations with ``extra=
{"patch_embeds": ...}`` identical to the reference ``Engine``'s at
``quant_bits`` 0 and 16 through 4 and 2 slots; the patch-counting
``max_len`` check; without ``extra`` both engines raise ``KeyError``
(ROADMAP C6)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig

ATOL = 1e-4
VLM, AUDIO = "internvl2-76b", "hubert-xlarge"
F32 = dict(compute_dtype="float32", param_dtype="float32")


@functools.lru_cache(maxsize=None)
def setup(arch):
    """Reduced float32 configs of both packages, the reference's init tree
    (numpy) and its port."""
    jcfg = JC.reduced(JC.get(arch), **F32)
    cfg = C.reduced(C.get(arch), **F32)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, jp, cfg, np_params


def port_params(arch):
    return weights.lm_params_from_numpy(setup(arch)[3], "cpu")


def vlm_inputs(batch=2, text=10, seed=1):
    """(tokens (B, text), patch embeddings (B, P, D)) from numpy."""
    cfg = setup(VLM)[2]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, text))
    patches = rng.standard_normal(
        (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return toks, patches


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def tk(a):
    return torch.as_tensor(np.asarray(a))


def jbatch(**kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def tbatch(**kw):
    return {k: tk(v) for k, v in kw.items()}


# ---------------------------------------------------------------------------
# Init layout
# ---------------------------------------------------------------------------

def layout(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(layout(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                ""))}


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("dtypes", ["config", "float32"])
def test_init_layout_matches_reference(arch, dtypes):
    """Leaf names, shapes and dtypes of the port's ``init`` against the
    reference's: audio has no embedding table and a head with a bias, the
    full-rank dense weights float32 whatever ``param_dtype`` says (C2)."""
    over = F32 if dtypes == "float32" else {}
    jcfg = JC.reduced(JC.get(arch), **over)
    cfg = C.reduced(C.get(arch), **over)
    want = layout(jax.eval_shape(lambda k: JT.init(jcfg, k),
                                 jax.random.PRNGKey(0)))
    got = layout(T.init(cfg, torch.Generator().manual_seed(0)))
    assert got == want
    assert ("/embed/table" in got) == (arch == VLM)
    assert ("/lm_head/b" in got) == (arch == AUDIO)


# ---------------------------------------------------------------------------
# vlm: forward, prefill, decode
# ---------------------------------------------------------------------------

def test_vlm_forward_and_prefill_match_reference():
    jcfg, jp, cfg, _ = setup(VLM)
    p = port_params(VLM)
    toks, patches = vlm_inputs()
    P = cfg.num_patches
    want, _, jcaches = JT.forward(jcfg, jp, jbatch(tokens=toks,
                                                   patch_embeds=patches),
                                  emit_caches=True)
    got, _, caches = T.forward(cfg, p, tbatch(tokens=toks,
                                              patch_embeds=patches),
                               emit_caches=True)
    assert got.shape == (2, 10, cfg.vocab_size) == want.shape
    close(got, want)
    for n in ("k", "v"):
        assert caches[n].shape[2] == P + 10
        close(caches[n], jcaches[n])
    want, jcache = JT.prefill(jcfg, jp, jbatch(tokens=toks[:, :7],
                                               patch_embeds=patches),
                              max_len=32)
    got, cache = T.prefill(cfg, p, tbatch(tokens=toks[:, :7],
                                          patch_embeds=patches), max_len=32)
    close(got, want)
    for n in ("k", "v"):
        close(cache[n], jcache[n])
    assert cache["len"] == int(jcache["len"]) == P + 7


def test_vlm_decode_matches_reference_and_forward():
    """Prefill patches and 4 text tokens, then decode the other 6 one by
    one: each logit row within 1e-4 of the reference's decode and of the
    port's own forward over patches and text."""
    jcfg, jp, cfg, _ = setup(VLM)
    p = port_params(VLM)
    toks, patches = vlm_inputs()
    full, _, _ = T.forward(cfg, p, tbatch(tokens=toks, patch_embeds=patches))
    _, jcache = JT.prefill(jcfg, jp, jbatch(tokens=toks[:, :4],
                                            patch_embeds=patches), max_len=32)
    _, cache = T.prefill(cfg, p, tbatch(tokens=toks[:, :4],
                                        patch_embeds=patches), max_len=32)
    for t in range(4, toks.shape[1]):
        want, jcache = JT.decode_step(jcfg, jp, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        got, cache = T.decode_step(cfg, p, cache, tk(toks[:, t:t + 1]))
        close(got, want)
        close(got[:, 0], full[:, t].numpy())
    for n in ("k", "v"):
        close(cache[n], jcache[n])
    assert cache["len"] == int(jcache["len"]) == cfg.num_patches + 10


def slotted_run(T_mod, cfg, p, toks, patches, conv, cache):
    """Admit two sequences with their patches into slots 0 and 2 of a
    3-slot cache at text lengths 5 and 7, then 4 ticks, slot 2 idle on the
    second; returns the logits, the ``pos`` after admission and each
    tick's ``pos``."""
    out = []
    for slot, row, n in ((0, 0, 5), (2, 1, 7)):
        lg, cache = T_mod.prefill_into_slot(
            cfg, p, cache, {"tokens": conv(toks[row:row + 1, :n]),
                            "patch_embeds": conv(patches[row:row + 1])},
            slot)
        out.append(lg)
    out.append(cache["pos"] + 0)     # a copy: the port advances pos in place
    fed = [5, 7]
    for t in range(4):
        active = np.array([True, False, t != 1])
        nxt = np.zeros((3, 1), np.int64)
        nxt[0, 0], nxt[2, 0] = toks[0, fed[0]], toks[1, fed[1]]
        lg, cache = T_mod.decode_step_slotted(cfg, p, cache, conv(nxt),
                                              conv(active))
        fed[0] += 1
        fed[1] += int(active[2])
        out += [lg, cache["pos"] + 0]
    return out, cache


def test_vlm_slotted_prefill_and_decode_match_reference():
    jcfg, jp, cfg, _ = setup(VLM)
    p = port_params(VLM)
    toks, patches = vlm_inputs()
    want, jcache = slotted_run(
        JT, jcfg, jp, toks, patches, jnp.asarray,
        JT.init_slot_cache(jcfg, 3, 32, dtype=jnp.float32))
    got, cache = slotted_run(
        T, cfg, p, toks, patches, tk,
        T.init_slot_cache(cfg, 3, 32, dtype=torch.float32, device="cpu"))
    P = cfg.num_patches
    assert got[0].shape == (1, 5, cfg.vocab_size)     # text positions only
    assert got[2].tolist() == np.asarray(want[2]).tolist() \
        == [P + 5, 0, P + 7]
    for g, w in zip(got, want):
        close(g, w)
    for n in ("k", "v"):
        close(cache[n], jcache[n])
    assert cache["pos"].tolist() == [P + 9, 0, P + 10]


def test_vlm_slotted_decode_matches_own_forward():
    """The slotted decode after a prefill of patches and text, within 1e-3
    of ``forward`` over the same patches and tokens (the check the card
    makes at full width)."""
    _, _, cfg, _ = setup(VLM)
    p = port_params(VLM)
    toks, patches = vlm_inputs()
    full, _, _ = T.forward(cfg, p, tbatch(tokens=toks, patch_embeds=patches))
    cache = T.init_slot_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    for slot, n in ((0, 3), (1, 6)):
        lg, cache = T.prefill_into_slot(
            cfg, p, cache, {"tokens": tk(toks[slot:slot + 1, :n]),
                            "patch_embeds": tk(patches[slot:slot + 1])},
            slot)
        close(lg[0], full[slot, :n].numpy(), 1e-3)
    fed = [3, 6]
    for _ in range(4):
        nxt = tk([[toks[0, fed[0]]], [toks[1, fed[1]]]])
        lg, cache = T.decode_step_slotted(cfg, p, cache, nxt)
        for s in (0, 1):
            close(lg[s, 0], full[s, fed[s]].numpy(), 1e-3)
            fed[s] += 1
    # the quantized-head engine's hidden states: every position, patches too
    h, _ = T.prefill_into_slot(
        cfg, p, cache, {"tokens": tk(toks[:1, :3]),
                        "patch_embeds": tk(patches[:1])}, 0,
        return_hidden=True)
    assert h.shape == (1, cfg.num_patches + 3, cfg.d_model)


# ---------------------------------------------------------------------------
# audio: the bidirectional encoder
# ---------------------------------------------------------------------------

def frames(n, batch=1, seed=2):
    d = setup(AUDIO)[2].d_model
    return np.random.default_rng(seed).standard_normal(
        (batch, n, d)).astype(np.float32)


@pytest.mark.parametrize("n", [1100, 2100])
def test_audio_forward_matches_reference(n):
    """At 1,100 frames attention takes the full-score path; at 2,100 (past
    ``CHUNKED_THRESHOLD``) the chunked online softmax with its last q
    chunk and last k chunk both padded.  The head has its bias; the
    encoder is bidirectional, so the first frame's logits move with the
    last frame."""
    jcfg, jp, cfg, np_params = setup(AUDIO)
    np_params = dict(np_params, lm_head=dict(
        np_params["lm_head"],
        b=np.linspace(-1, 1, cfg.vocab_size).astype(np.float32)))
    jp = jax.tree.map(jnp.asarray, np_params)
    p = weights.lm_params_from_numpy(np_params, "cpu")
    assert (n >= A.CHUNKED_THRESHOLD) == (n == 2100)
    x = frames(n)
    want, _, _ = JT.forward(jcfg, jp, jbatch(frames=x))
    got, _, _ = T.forward(cfg, p, tbatch(frames=x))
    assert got.shape == (1, n, cfg.vocab_size) and got.dtype == torch.float32
    close(got, want)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved, _, _ = T.forward(cfg, p, tbatch(frames=x2))
    assert float((moved[0, 0] - got[0, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_pads_q_and_k_chunks(causal):
    """``chunked_attention`` at 1,100 positions (a 512-row q chunk padded
    by 436, a 1024-row k chunk by 948), non-causal and causal, against the
    reference's and against the full-score path."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 1100, 2, 8)).astype(np.float32)
               for _ in range(3))
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None)
    got = A.chunked_attention(tk(q), tk(k), tk(v), causal, None)
    close(got, want, 1e-5)
    full = A.attention_scores(tk(q), tk(k), tk(v), causal=causal)
    close(got, full.numpy(), 1e-5)


def test_audio_prefill_matches_reference():
    """The encoder's prefill: its K/V cache and fill level are the
    reference's (``len`` counts the frames)."""
    jcfg, jp, cfg, _ = setup(AUDIO)
    p = port_params(AUDIO)
    x = frames(9, batch=2)
    want, jcache = JT.prefill(jcfg, jp, jbatch(frames=x), max_len=16)
    got, cache = T.prefill(cfg, p, tbatch(frames=x), max_len=16)
    close(got, want)
    for n in ("k", "v"):
        close(cache[n], jcache[n])
    assert cache["len"] == int(jcache["len"]) == 9


# ---------------------------------------------------------------------------
# The engine's extra inputs
# ---------------------------------------------------------------------------

def engines(**scfg):
    jcfg, jp, cfg, np_params = setup(VLM)
    ref = JEngine(jcfg, jp, JServeConfig(**scfg))
    port = Engine(cfg, weights.lm_params_from_numpy(np_params, "cpu"),
                  ServeConfig(**scfg), device="cpu")
    return ref, port


@pytest.mark.parametrize("slots", [4, 2])
@pytest.mark.parametrize("quant_bits", [0, 16])
def test_vlm_greedy_generations_identical_to_reference(quant_bits, slots):
    ref, port = engines(max_len=32, max_slots=slots, quant_bits=quant_bits)
    toks, patches = vlm_inputs(batch=4, text=8)
    want = ref.generate(toks, max_new=12, extra={"patch_embeds": patches})
    got = port.generate(toks, max_new=12, extra={"patch_embeds": patches})
    np.testing.assert_array_equal(got, want)
    assert port.stats() == ref.stats()
    if slots == 2:
        st = port.stats()["scheduler"]
        assert st["recycles"] == 2 and st["spills"] == 2
    # per-request extras through submit, tensors as well as arrays
    rid = port.submit(toks[1], 12, extra={"patch_embeds": tk(patches[1:2])})
    port.run()
    np.testing.assert_array_equal(port.result(rid), want[1])


def test_submit_counts_patch_positions_against_max_len():
    """8 text tokens + 8 patches + 17 new - 1 = 32 fits; 18 does not, in
    both packages, with the same message."""
    ref, port = engines(max_len=32, max_slots=2)
    toks, patches = vlm_inputs(batch=1, text=8)
    extra = {"patch_embeds": patches}
    for eng in (ref, port):
        eng.submit(toks[0], 17, extra=extra)
    msgs = []
    for eng in (ref, port):
        with pytest.raises(ValueError, match="patch positions") as e:
            eng.submit(toks[0], 18, extra=extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_vlm_without_extra_raises_key_error_in_both():
    """ROADMAP C6: a vlm request without ``patch_embeds`` fails at its
    prefill with ``KeyError`` in both engines (the reference's launcher
    passes none)."""
    ref, port = engines(max_len=32, max_slots=2)
    toks, _ = vlm_inputs(batch=1, text=8)
    for eng in (ref, port):
        with pytest.raises(KeyError, match="patch_embeds"):
            eng.generate(toks, max_new=4)


def test_engine_moves_extras_to_its_device():
    """``_admit_slot`` hands the model tensors on the engine's device; the
    model casts them to its compute dtype."""
    _, port = engines(max_len=32, max_slots=1)
    toks, patches = vlm_inputs(batch=1, text=4)
    seen = []
    fwd = T.prefill_into_slot

    def spy(cfg, params, cache, batch, slot, **kw):
        seen.append({k: (v.device.type, v.dtype) for k, v in batch.items()})
        return fwd(cfg, params, cache, batch, slot, **kw)
    T.prefill_into_slot = spy
    try:
        port.generate(toks, 2, extra={"patch_embeds": patches.astype(
            np.float64)})
    finally:
        T.prefill_into_slot = fwd
    assert seen == [{"tokens": ("cpu", torch.int32),
                     "patch_embeds": ("cpu", torch.float64)}]
