"""The LM engine's decode tick over device buffers written in place
(``serve/engine.py``: one CUDA graph a tick on the card), for a reduced
config of every decoder family: dense, moe, ssm, hybrid and vlm.

On the CPU every tick runs eagerly.  Each tick of a continuous-batching
run (slots recycling, some rows inactive) is held bit for bit against
``decode_step_slotted`` run on a copy of the cache from fresh input
tensors: the logits, every cache tensor after the tick, ``pos`` the same
tensor before and after, and an inactive row's ``pos`` and cache rows as
they were.  The engine's metrics counters count every tick as eager and
none as replayed.

The tests marked ``chip`` need a CUDA card and skip without one (run on
the card: ``python3 -m pytest -q -m chip
tests/test_torch_lm_decode_graph.py``).
There the same per-tick check holds the graph's replays against the
eager step; the graph engine's greedy tokens equal those of an engine
whose ticks run eagerly; the first tick runs eagerly and every later one
replays; ``Q15Matmul.launches`` counts the K5 launches made from the
host (one a prefill and one for the first, eager tick) and the device
trace of replayed ticks holds one K5 kernel a tick; the
tracer's ``detail`` runs every tick eagerly with its per-layer spans; and
a freed engine gives its memory, graph pool included, back.
"""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.kernels.q15_matmul.kernel import Q15Matmul
from repro_torch.models import transformer as T
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, Observability,
                             Tracer)
from repro_torch.pytree import tree_map
from repro_torch.serve.engine import Engine, ServeConfig

# one reduced config of each decoder family
FAMILIES = {"dense": "qwen2-1.5b", "moe": "olmoe-1b-7b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
            "vlm": "internvl2-76b"}
# five requests over three slots: slots recycle, and rows go idle as
# budgets run out at different ticks
PROMPTS, BUDGETS = (5, 9, 3, 7, 6), (4, 2, 6, 3, 5)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, at the test, never at
    import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_engine(arch, device, quant_bits=16, obs=None, **cfg_kw):
    """An engine over a reduced config of ``arch``, with a metrics
    registry unless ``obs`` brings its own."""
    if obs is None:
        obs = Observability(metrics=MetricsRegistry())
    cfg = C.reduced(C.get(arch), **cfg_kw)
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0))
    return Engine(cfg, params, ServeConfig(max_len=32, max_slots=3,
                                           quant_bits=quant_bits),
                  obs=obs, device=device)


def submit(eng, rng, prompt, new, request_id):
    """One request of ``prompt`` random tokens (a vlm's with its patch
    embeddings)."""
    cfg, extra = eng.cfg, None
    if cfg.family == "vlm":
        extra = {"patch_embeds": rng.standard_normal(
            (1, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    eng.submit(rng.integers(0, cfg.vocab_size, prompt), new,
               request_id=request_id, extra=extra)


def submit_all(eng):
    """The five requests, as ``q0``..``q4``."""
    rng = np.random.default_rng(7)
    for i, (s, new) in enumerate(zip(PROMPTS, BUDGETS)):
        submit(eng, rng, s, new, f"q{i}")


def run(eng):
    submit_all(eng)
    eng.run()
    return [eng.result(f"q{i}") for i in range(len(PROMPTS))]


def ticks_by_path(eng) -> tuple[int, int]:
    """(decode ticks replayed, decode ticks run eagerly) from the engine's
    metrics counters."""
    counters = eng._obs.metrics.snapshot()["counters"]
    return (counters.get("lm.decode_graph_replays", 0),
            counters.get("lm.decode_eager_ticks", 0))


def slot_rows(cache):
    """Every cache tensor with the slot axis first: ``pos`` (S,), the
    K/V, SSM states and conv tails (L, S, ...) moved to (S, L, ...)."""
    rows = {"pos": cache["pos"]}
    rows.update({n: cache[n].movedim(1, 0) for n in ("k", "v", "ssm")
                 if cache.get(n) is not None})
    rows.update({f"conv.{n}": t.movedim(1, 0)
                 for n, t in cache.get("conv", {}).items()})
    return rows


def same_bytes(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def checked_ticks(eng) -> list:
    """Hold each of the engine's decode ticks against
    ``decode_step_slotted`` and the head run eagerly on a copy of the
    cache taken before the tick, from fresh copies of the tick's inputs:
    logits and every cache tensor bit for bit, ``pos`` the same tensor,
    and an inactive row's ``pos`` and cache rows as they were.  Returns
    the list each tick's active rows go into."""
    tick, seen = eng._decode_logits, []

    def checked():
        before = tree_map(torch.clone, eng.cache)
        ref_cache = tree_map(torch.clone, eng.cache)
        toks, need = eng._tok_dev.clone(), eng._need_dev.clone()
        pos = eng.cache["pos"]
        got = tick()
        out, ref_cache = T.decode_step_slotted(
            eng.cfg, eng.params, ref_cache, toks, need,
            return_hidden=eng._quant_head)
        want = eng._head_logits(out) if eng._quant_head else out[:, 0, :]
        assert eng.cache["pos"] is pos
        assert same_bytes(got, want)
        now, ref, old = (slot_rows(c)
                         for c in (eng.cache, ref_cache, before))
        idle = ~need
        for name, t in now.items():
            assert same_bytes(t, ref[name]), name
            assert same_bytes(t[idle], old[name][idle]), name
        seen.append(need.cpu())
        return got
    eng._decode_logits = checked
    return seen


def eager_only(eng) -> None:
    """Run every decode tick of ``eng`` eagerly, as the CPU does."""
    eng._decode_logits = lambda: eng._forward_tick(NULL_TRACER)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_bits", [0, 16])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tick_on_static_buffers_equals_the_eager_step(family, quant_bits):
    obs = Observability(metrics=MetricsRegistry())
    eng = make_engine(FAMILIES[family], "cpu", quant_bits, obs=obs,
                      compute_dtype="float32", param_dtype="float32")
    seen = checked_ticks(eng)
    out = run(eng)
    st = eng.stats()
    assert [o.shape[0] for o in out] == list(BUDGETS)
    assert len(seen) == st["decode_ticks"] > 0
    assert st["scheduler"]["recycles"] > 0
    assert any(not bool(n.all()) for n in seen)      # some rows inactive
    assert ticks_by_path(eng) == (0, st["decode_ticks"])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.chip
@pytest.mark.parametrize("family", list(FAMILIES))
def test_graph_replays_equal_the_eager_step_on_the_card(card, family):
    eng = make_engine(FAMILIES[family], card)
    seen = checked_ticks(eng)
    run(eng)
    st = eng.stats()
    assert len(seen) == st["decode_ticks"]
    assert any(not bool(n.all()) for n in seen)
    replays, eager = ticks_by_path(eng)
    assert eager == 1 and replays == st["decode_ticks"] - 1 > 0


PROFILED_TICKS = 4


def k5_in_profiled_replays(eng) -> int:
    """Fill every slot of the drained engine, run the tick that admits
    them, then PROFILED_TICKS replayed decode ticks under torch.profiler
    (host and device) -> the trace's count of K5 kernels over those
    ticks.  The host launches none of them: ``Q15Matmul.launches`` does
    not move."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(11)
    slots = eng.scfg.max_slots
    for i in range(slots):
        submit(eng, rng, 4, PROFILED_TICKS + 4, f"p{i}")
    eng.tick()
    torch.cuda.synchronize()
    ticks, replays = eng.stats()["decode_ticks"], ticks_by_path(eng)[0]
    k5 = Q15Matmul.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_TICKS):
            eng.tick()
        torch.cuda.synchronize()
    assert eng.stats()["decode_ticks"] - ticks == PROFILED_TICKS
    assert ticks_by_path(eng)[0] - replays == PROFILED_TICKS
    assert Q15Matmul.launches == k5
    eng.run()
    return sum(e.count for e in prof.key_averages()
               if "q15_matmul_kernel" in e.key
               and getattr(e, "device_time_total", 0.0) > 0)


def freed(device) -> int:
    """Collect what was let go, as the benchmark does after freeing its
    engine -> the card's allocated bytes afterwards."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(device)


@pytest.mark.chip
@pytest.mark.parametrize("family", list(FAMILIES))
def test_graph_engine_serves_the_eager_tokens_on_the_card(card, family):
    arch = FAMILIES[family]
    eager = make_engine(arch, card)
    eager_only(eager)
    want = run(eager)
    del eager
    after = []
    for _ in range(2):          # a second engine: nothing of the first kept
        obs = Observability(tracer=Tracer(), metrics=MetricsRegistry())
        eng = make_engine(arch, card, obs=obs)
        Q15Matmul.launches = 0
        got = run(eng)
        k5 = Q15Matmul.launches
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        st = eng.stats()
        replays, eager = ticks_by_path(eng)
        assert eager == 1 and replays == st["decode_ticks"] - 1 > 0
        assert k5 == st["prefills"] + eager
        assert obs.tracer.phase_stats()["lm.graph_capture"]["count"] == 1
        assert k5_in_profiled_replays(eng) == PROFILED_TICKS
        del eng, obs
        after.append(freed(card))
    assert after[1] == after[0]


@pytest.mark.chip
@pytest.mark.parametrize("family", list(FAMILIES))
def test_detail_runs_every_tick_eagerly_on_the_card(card, family):
    tr = Tracer(capacity=8192)
    tr.detail = True
    eng = make_engine(FAMILIES[family], card,
                      obs=Observability(tracer=tr, metrics=MetricsRegistry()))
    run(eng)
    st = eng.stats()
    assert ticks_by_path(eng) == (0, st["decode_ticks"]) and \
        st["decode_ticks"] > 0
    fl = tr.flight()
    by_seq = {r["seq"]: r for r in fl}
    under_decode = [r for r in fl if r["phase"] in ("model.mamba",
                                                    "model.attn")
                    and by_seq[by_seq[r["parent"]]["parent"]]["phase"]
                    == "lm.decode"]
    cfg = eng.cfg
    per_tick = (cfg.num_layers + (cfg.num_layers // cfg.attn_every
                                  if cfg.family == "hybrid" else 0))
    assert len(under_decode) == per_tick * st["decode_ticks"]
    assert not [r for r in fl if r["phase"] == "lm.graph_capture"]
