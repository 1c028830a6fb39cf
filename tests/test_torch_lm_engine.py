"""Port parity, the LM serving engine (``repro_torch.serve.engine``): the
reference's ``Engine`` and the port's, on the same parameters (the
reference's own initialised trees, carried across) and the same prompts,
in float32 at reduced width.  Greedy generations identical for
``quant_bits`` 0, 8 and 16 through 4 and through 2 slots (mirror of
``tests/test_serve_engine.py``'s greedy and continuous-batching tests),
with equal ``stats()``, for the ``dense`` family, and for 0 and 16 for
mamba2-780m (``ssm``), zamba2-1.2b (``hybrid``) and olmoe-1b-7b and
moonshot-v1-16b-a3b (``moe``: at the no-drop capacity factor of the
reference's ``tests/test_serve_engine.py``, and once at the default 1.25,
where prefills drop tokens in both packages); mixed budgets, cancels, the ``eos_id`` stop, the
``obs=`` spans and counter, the spans' request ids, counts and parents,
and the per-layer spans of the tracer's ``detail`` switch (greedy tokens
unchanged by it); ``quantize_tree`` / ``dequantize_tree`` bitwise the
reference's; temperature sampling valid and seeded."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.compress.tree import dequantize_tree as j_dequantize_tree
from repro.compress.tree import quantize_tree as j_quantize_tree
from repro.compress.tree import tree_size_report as j_tree_size_report
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.compress.tree import (dequantize_tree, quantize_tree,
                                       tree_size_report)
from repro_torch.models import transformer as T
from repro_torch.obs import Observability, Tracer
from repro_torch.pytree import tree_leaves
from repro_torch.serve.engine import Engine, ServeConfig

ARCHS = ["qwen2-1.5b", "deepseek-7b"]     # tied head + QKV bias; untied
MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]


@functools.lru_cache(maxsize=None)
def setup(arch, batch=4, prompt=8, drop=False):
    """A ``moe`` config gets the no-drop capacity factor, as the
    reference's engine tests give it, unless ``drop``."""
    jcfg = JC.reduced(JC.get(arch), compute_dtype="float32",
                      param_dtype="float32")
    cfg = C.reduced(C.get(arch), compute_dtype="float32",
                    param_dtype="float32")
    if cfg.family == "moe" and not drop:
        cf = cfg.num_experts / cfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (batch, prompt))
    return jcfg, jp, cfg, jax.tree.map(np.asarray, jp), toks


def engines(arch, drop=False, **scfg):
    jcfg, jp, cfg, np_params, toks = setup(arch, drop=drop)
    ref = JEngine(jcfg, jp, JServeConfig(**scfg))
    port = Engine(cfg, weights.lm_params_from_numpy(np_params, "cpu"),
                  ServeConfig(**scfg), device="cpu")
    return ref, port, toks


def as_bytes(t):
    return t.reshape(-1).view(torch.uint8)


def smallest_margin(eng):
    """Record the top-1 / top-2 logit margin of every row ``eng`` samples;
    returns the list the margins go into."""
    sample, margins = eng._sample, []

    def recorded(logits):
        top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        return sample(logits)
    eng._sample = recorded
    return margins


@pytest.mark.parametrize("slots", [4, 2])
@pytest.mark.parametrize("quant_bits", [0, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generations_identical_to_reference(arch, quant_bits, slots):
    ref, port, toks = engines(arch, max_len=32, max_slots=slots,
                              quant_bits=quant_bits)
    margins = smallest_margin(ref)
    want = ref.generate(toks, max_new=12)
    got = port.generate(toks, max_new=12)
    # a flipped token would be a near tie: say how near the run came
    print(f"{arch} quant_bits={quant_bits} slots={slots}: smallest top-1 / "
          f"top-2 logit margin of the reference's sampled rows "
          f"{min(margins):.3e}")
    np.testing.assert_array_equal(got, want)
    assert port.stats() == ref.stats()
    if slots == 2:
        st = port.stats()["scheduler"]
        assert st["recycles"] == 2 and st["spills"] == 2
        assert port.stats()["prefills"] == 4


@pytest.mark.parametrize("slots", [4, 2])
@pytest.mark.parametrize("quant_bits", [0, 16])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_greedy_generations_identical_to_reference_mamba(arch, quant_bits,
                                                         slots):
    """The Mamba-2 families: every prefill's scan through the SSD scan
    kernel's entry point (its plain version here), no slot reset on
    admission (prefill overwrites a slot's SSM state and conv tail)."""
    ref, port, toks = engines(arch, max_len=32, max_slots=slots,
                              quant_bits=quant_bits)
    margins = smallest_margin(ref)
    want = ref.generate(toks, max_new=12)
    got = port.generate(toks, max_new=12)
    print(f"{arch} quant_bits={quant_bits} slots={slots}: smallest top-1 / "
          f"top-2 logit margin of the reference's sampled rows "
          f"{min(margins):.3e}")
    np.testing.assert_array_equal(got, want)
    assert port.stats() == ref.stats()
    if slots == 2:
        st = port.stats()["scheduler"]
        assert st["recycles"] == 2 and st["spills"] == 2


@pytest.mark.parametrize("slots", [4, 2])
@pytest.mark.parametrize("quant_bits", [0, 16])
@pytest.mark.parametrize("arch", MOE)
def test_greedy_generations_identical_to_reference_moe(arch, quant_bits,
                                                       slots):
    """The ``moe`` family at the no-drop capacity factor: every prefill
    and decode tick routes through ``models.moe``."""
    ref, port, toks = engines(arch, max_len=32, max_slots=slots,
                              quant_bits=quant_bits)
    margins = smallest_margin(ref)
    want = ref.generate(toks, max_new=12)
    got = port.generate(toks, max_new=12)
    print(f"{arch} quant_bits={quant_bits} slots={slots}: smallest top-1 / "
          f"top-2 logit margin of the reference's sampled rows "
          f"{min(margins):.3e}")
    np.testing.assert_array_equal(got, want)
    assert port.stats() == ref.stats()
    if slots == 2:
        st = port.stats()["scheduler"]
        assert st["recycles"] == 2 and st["spills"] == 2


@pytest.mark.parametrize("quant_bits", [0, 16])
def test_moe_engine_at_the_default_capacity_factor(quant_bits):
    """olmoe-1b-7b at capacity factor 1.25: prefills drop (token, expert)
    assignments (the port's count over the same prompts is nonzero, and
    its routing is the reference's, ``tests/test_torch_moe.py``); the
    decode ticks never do.  Greedy generations identical through 2
    slots."""
    arch = "olmoe-1b-7b"
    _, _, cfg, np_params, toks = setup(arch, drop=True)
    assert cfg.capacity_factor == 1.25
    p = weights.lm_params_from_numpy(np_params, "cpu")
    dropped = sum(int(T.forward(cfg, p, {"tokens": torch.as_tensor(
        row[None])})[1]["dropped"]) for row in toks)
    assert dropped > 0
    ref, port, toks = engines(arch, drop=True, max_len=32, max_slots=2,
                              quant_bits=quant_bits)
    want = ref.generate(toks, max_new=12)
    got = port.generate(toks, max_new=12)
    np.testing.assert_array_equal(got, want)
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_budgets_recycle_slots_per_step(arch):
    ref, port, toks = engines(arch, max_len=32, max_slots=2, quant_bits=16)
    budgets = [3, 10, 3, 10]
    for eng in (ref, port):
        rids = [eng.submit(toks[i], budgets[i], request_id=f"q{i}")
                for i in range(4)]
        eng.run()
        eng.rows = [eng.result(rid) for rid in rids]
    for b, got, want in zip(budgets, port.rows, ref.rows):
        assert got.shape == (b,)
        np.testing.assert_array_equal(got, want)
    assert port.stats() == ref.stats()
    assert port.stats()["scheduler"]["completed"] == 4


def test_cancel_resident_and_pending():
    ref, port, toks = engines("qwen2-1.5b", max_len=32, max_slots=1)
    out = []
    for eng in (ref, port):
        eng.submit(toks[0], 10, request_id="resident")
        eng.submit(toks[1], 10, request_id="queued")
        pending = eng.cancel("queued")
        assert not pending.finished and pending.tokens.shape == (0,)
        np.testing.assert_array_equal(eng.result("queued"),
                                      np.zeros(0, np.int32))
        eng.tick()
        eng.tick()
        ev = eng.cancel("resident")
        assert not ev.finished and 1 <= ev.tokens.shape[0] < 10
        np.testing.assert_array_equal(eng.result("resident"), ev.tokens)
        out.append(ev.tokens)
    np.testing.assert_array_equal(out[1], out[0])
    assert port.stats() == ref.stats()


def test_eos_stops_a_sequence_early():
    _, _, toks = engines("qwen2-1.5b", max_len=32, max_slots=2)
    free = engines("qwen2-1.5b", max_len=32, max_slots=2)[1]
    row = free.generate(toks[:1], max_new=12)[0]
    eos = int(row[3])                       # the 4th greedy token
    ref, port, _ = engines("qwen2-1.5b", max_len=32, max_slots=2,
                           eos_id=eos)
    want = ref.generate(toks[:2], max_new=12)
    got = port.generate(toks[:2], max_new=12)
    np.testing.assert_array_equal(got, want)
    stop = list(row).index(eos)
    assert (got[0, stop:] == eos).all()
    assert port.stats()["tokens_generated"] == ref.stats()["tokens_generated"]


def test_submit_validation():
    _, port, toks = engines("qwen2-1.5b", max_len=16, max_slots=1)
    for bad in (lambda: port.submit(toks, 4),          # 2-D prompt
                lambda: port.submit(toks[0], 0),       # empty budget
                lambda: port.submit(toks[0], 16)):     # prompt + new > len
        with pytest.raises(ValueError):
            bad()


def test_obs_spans_and_token_counter():
    _, _, cfg, np_params, toks = setup("qwen2-1.5b")
    obs = Observability.full()
    eng = Engine(cfg, weights.lm_params_from_numpy(np_params, "cpu"),
                 ServeConfig(max_len=32, max_slots=2, quant_bits=8),
                 obs=obs, device="cpu")
    eng.generate(toks, max_new=5)
    st = obs.tracer.phase_stats()
    assert st["lm.prefill"]["count"] == eng.stats()["prefills"] == 4
    assert st["lm.decode"]["count"] == eng.stats()["decode_ticks"]
    assert st["lm.tick"]["count"] == eng.stats()["scheduler"]["ticks"]
    assert "sched.admit" in st
    snap = obs.metrics.snapshot()
    decoded = eng.stats()["tokens_generated"] - eng.stats()["prefills"]
    assert snap["counters"]["lm.tokens_generated"] == decoded
    assert snap["histograms"]["lm.tick_us"]["count"] == \
        eng.stats()["scheduler"]["ticks"]


def traced_run(arch, tracer, quant_bits=16):
    """Five requests of mixed prompt lengths and budgets, submitted as
    ``q0``..``q4``, through 2 slots with ``tracer`` attached (none
    without one). -> (their tokens, the engine's stats)."""
    _, _, cfg, np_params, _ = setup(arch)
    obs = None if tracer is None else Observability(tracer=tracer)
    eng = Engine(cfg, weights.lm_params_from_numpy(np_params, "cpu"),
                 ServeConfig(max_len=32, max_slots=2,
                             quant_bits=quant_bits), obs=obs, device="cpu")
    rng = np.random.default_rng(7)
    for i, (s, new) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(rng.integers(0, cfg.vocab_size, s), new,
                   request_id=f"q{i}")
    eng.run()
    return [eng.result(f"q{i}") for i in range(len(PROMPTS))], eng.stats()


PROMPTS, BUDGETS = (5, 9, 3, 7, 6), (4, 2, 5, 3, 4)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_spans_carry_request_ids_counts_and_parents(arch):
    """``lm.prefill`` names its request and counts its prompt positions,
    in admission order; ``lm.decode`` counts the rows it advanced;
    ``sched.admit`` the requests it placed; each prefill and decode holds
    one ``lm.forward``."""
    tr = Tracer(capacity=1024)
    _, st = traced_run(arch, tr)
    fl = tr.flight()
    by_seq = {r["seq"]: r for r in fl}
    of = lambda phase: [r for r in fl if r["phase"] == phase]
    assert [r["req"] for r in of("lm.prefill")] == \
        [f"q{i}" for i in range(len(PROMPTS))]
    assert [r["n"] for r in of("lm.prefill")] == list(PROMPTS)
    assert sum(r["n"] for r in of("lm.decode")) == \
        st["tokens_generated"] - st["prefills"]
    assert len(of("lm.decode")) == st["decode_ticks"]
    assert sum(r["n"] for r in of("sched.admit")) == st["prefills"]
    fwd = of("lm.forward")
    assert len(fwd) == st["prefills"] + st["decode_ticks"]
    parents = [by_seq[r["parent"]]["phase"] for r in fwd]
    assert sorted(parents) == sorted(["lm.prefill"] * st["prefills"]
                                     + ["lm.decode"] * st["decode_ticks"])
    assert len({r["parent"] for r in fwd}) == len(fwd)
    assert not [r for r in fl if r["phase"].startswith("model.")]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b",
                                  "qwen2-1.5b"])
def test_model_spans_only_under_detail(arch):
    """With the tracer's ``detail`` on, every model call holds one span
    per layer (``model.mamba``; ``model.attn`` for an attention block,
    the hybrid's shared block among them) and every prefill one
    ``model.ssd`` per mamba layer; greedy tokens stay bit for bit those
    of an untraced engine."""
    cfg = setup(arch)[2]
    want, _ = traced_run(arch, None)
    tr = Tracer(capacity=4096)
    tr.detail = True
    got, st = traced_run(arch, tr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fl = tr.flight()
    by_seq = {r["seq"]: r for r in fl}
    up = lambda r: by_seq[r["parent"]]
    mamba = cfg.num_layers if cfg.uses_mamba else 0
    attn = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
            else 0 if cfg.uses_mamba else cfg.num_layers)
    forwards = st["prefills"] + st["decode_ticks"]
    layers = [r for r in fl if r["phase"] in ("model.mamba", "model.attn")]
    assert all(up(r)["phase"] == "lm.forward" for r in layers)
    assert sum(r["phase"] == "model.mamba" for r in layers) == \
        mamba * forwards
    assert sum(r["phase"] == "model.attn" for r in layers) == attn * forwards
    ssd = [r for r in fl if r["phase"] == "model.ssd"]
    assert len(ssd) == mamba * st["prefills"]
    assert all(up(r)["phase"] == "model.mamba"
               and up(up(up(r)))["phase"] == "lm.prefill" for r in ssd)
    tr.detail = False
    last = fl[-1]["seq"]
    off, _ = traced_run(arch, tr)
    for a, b in zip(off, want):
        np.testing.assert_array_equal(a, b)
    assert not [r for r in tr.flight() if r["seq"] > last
                and r["phase"].startswith("model.")]


@pytest.mark.parametrize("bits", [8, 16, 7, 15])
@pytest.mark.parametrize("arch", ARCHS + MOE[:1])
def test_quantize_tree_bitwise_reference(arch, bits):
    """The published bf16 trees (float32 dense weights, bf16 embedding
    table and norms, ROADMAP C2), so both float widths are quantized; for
    ``moe`` also the float32 router and the bf16 ``(L, E, d_in, d_out)``
    expert stacks, one scale each."""
    jcfg = JC.reduced(JC.get(arch))
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    jq, js = j_quantize_tree(jp, bits)
    q, s = quantize_tree(weights.lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"), bits)
    want_q = weights.lm_params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    want_s = weights.lm_params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for got, want in ((q, want_q), (s, want_s)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(as_bytes(g), as_bytes(w))
    deq = dequantize_tree(q, s)
    want = weights.lm_params_from_numpy(jax.tree.map(
        np.asarray, j_dequantize_tree(jq, js)), "cpu")
    for g, w in zip(tree_leaves(deq), tree_leaves(want)):
        assert g.dtype == w.dtype
        assert torch.equal(as_bytes(g), as_bytes(w))
    assert tree_size_report(q, bits) == j_tree_size_report(jq, bits)


def test_quantize_tree_refuses_other_widths():
    with pytest.raises(ValueError):
        quantize_tree({"w": torch.ones(2, 2)}, 4)


def test_temperature_sampling_is_valid_and_seeded():
    _, _, cfg, np_params, toks = setup("qwen2-1.5b")
    runs = []
    for seed in (3, 3, 4):
        eng = Engine(cfg, weights.lm_params_from_numpy(np_params, "cpu"),
                     ServeConfig(max_len=32, max_slots=2, temperature=1.0,
                                 seed=seed, quant_bits=16), device="cpu")
        runs.append(eng.generate(toks, max_new=10))
    for out in runs:
        assert out.shape == (4, 10)
        assert (out >= 0).all() and (out < cfg.vocab_size).all()
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_quantized_head_layout():
    for arch, tied in (("qwen2-1.5b", True), ("deepseek-7b", False),
                       ("mamba2-780m", False), ("zamba2-1.2b", False),
                       ("olmoe-1b-7b", False)):
        _, _, cfg, np_params, _ = setup(arch)
        eng = Engine(cfg, weights.lm_params_from_numpy(np_params, "cpu"),
                     ServeConfig(max_len=16, max_slots=1, quant_bits=8),
                     device="cpu")
        want = (eng.qparams["embed"]["table"].T if tied
                else eng.qparams["lm_head"]["w"])
        assert eng._head_wq.is_contiguous()
        assert torch.equal(eng._head_wq, want)
        assert eng._head_wq.shape == (cfg.d_model, cfg.vocab_size)
