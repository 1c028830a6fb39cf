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
``obs=`` spans and counter; ``quantize_tree`` / ``dequantize_tree``
bitwise the reference's; temperature sampling valid and seeded."""
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
from repro_torch.obs import Observability
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
