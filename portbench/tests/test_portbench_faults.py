"""The check that decides ``correct``, shown to fail.

Faults: the rest of a run (the harness's look for a card skipped: the
tiny cells on the CPU) with the timed path broken underneath, once for
each fault a serving cell can have: a step that returns its state
unchanged, half of the batch left out, a token altered where it is
produced.  A one-chip cell has no exchange between chips.

Control: the reference with every weight product's operands rounded to
float8 e4m3 (the nearest precision below the configuration's bfloat16)
in the program's place; it has to come out not correct on every seed,
on the card at the cells' own size and here at the tiny size.  Run on the card: ``python3 -m pytest -q -m chip
portbench/tests``."""
import time

import numpy as np
import pytest
import torch

from portbench import run as R

CELLS = ["tiny-ssm.tiny-serve", "tiny-hybrid.tiny-serve"]


def _run(root, cell, seed=2**31 + 3, seconds=1.0, **kw):
    return R.run_cell(root, cell, seed, seconds, False, "cpu",
                      t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_path_is_correct(tiny_root, cell):
    assert _run(tiny_root, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(tiny_root, cell, monkeypatch):
    from repro_torch.models import transformer as T
    step = T._mamba_decode_layer

    def stale(cfg, bp, cache, i, x, active, mesh=None):
        ssm = cache["ssm"][i].clone()
        conv = {k: t[i].clone() for k, t in cache["conv"].items()}
        out = step(cfg, bp, cache, i, x, active, mesh)
        cache["ssm"][i].copy_(ssm)
        for k, t in cache["conv"].items():
            t[i].copy_(conv[k])
        return out
    monkeypatch.setattr(T, "_mamba_decode_layer", stale)
    res = _run(tiny_root, cell)
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_not_correct(tiny_root, cell,
                                                monkeypatch):
    from repro_torch.models import transformer as T
    decode = T.decode_step_slotted

    def half(cfg, params, cache, tokens, active=None, **kw):
        # the second half of the rows is not computed: the first half's
        # outputs stand in for it
        out, cache = decode(cfg, params, cache, tokens, active, **kw)
        h = (tokens.shape[0] + 1) // 2
        out = out.clone()
        out[h:] = out[:tokens.shape[0] - h]
        return out, cache
    monkeypatch.setattr(T, "decode_step_slotted", half)
    res = _run(tiny_root, cell)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_token_altered_where_produced_is_not_correct(tiny_root, cell):
    def alter(eng):
        sample = eng._sample
        eng._sample = lambda logits: ((sample(logits) + 1)
                                      % logits.shape[-1]).astype(np.int32)
    res = _run(tiny_root, cell, break_path=alter)
    assert res["correct"] is False


def _stale_step(step):
    """A training step that returns its parameters and state unchanged
    (it computes on copies)."""
    from repro_torch.pytree import tree_map

    def f(params, state, batch):
        _, _, met = step(tree_map(torch.clone, params),
                         tree_map(torch.clone, state), batch)
        return params, state, met
    return f


def _half_batch_step(step):
    """A training step over the first half of the batch's rows, the mean
    taken over them."""
    def f(params, state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(params, state, {k: v[:n] for k, v in batch.items()})
    return f


@pytest.mark.parametrize("fault", [None, _stale_step, _half_batch_step])
def test_training_faults_are_not_correct(tiny_root, fault):
    res = _run(tiny_root, "tiny-ssm.tiny-train", break_path=fault)
    assert res["correct"] is (fault is None), res["checks"]


SERVE_CELLS = ["mamba2-780m.prefill-long"]


@pytest.mark.parametrize("cell", CELLS + ["tiny-ssm.tiny-train"])
def test_fp8_control_is_not_correct_tiny(tiny_root, cell):
    # the closed loop finishes as many requests as the host's speed
    # allows: a longer window gives the control a dozen or more to read
    # on a loaded host too
    res = _run(tiny_root, cell, seconds=3.0, control="fp8")
    assert res["correct"] is False, (res["attempted"], res["checks"])


@pytest.mark.chip
@pytest.mark.parametrize("cell", SERVE_CELLS + ["mamba2-780m.train-4k"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_fp8_control_is_not_correct(card, cell, seed):
    from portbench.tests.tiny import REPO
    res = R.run_cell(REPO, cell, seed, 6.0, False, card,
                     t_start=time.perf_counter(), control="fp8")
    print("reading", cell, seed, res["checks"])
    assert res["correct"] is False, res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("fault", [_stale_step, _half_batch_step])
@pytest.mark.parametrize("seed", [2**31 + 111, 2**31 + 112, 2**31 + 113])
def test_training_faults_at_size_are_not_correct(card, fault, seed):
    from portbench.tests.tiny import REPO
    res = R.run_cell(REPO, "mamba2-780m.train-4k", seed, 4.0, False, card,
                     t_start=time.perf_counter(), break_path=fault)
    print("reading", fault.__name__, seed, res["checks"],
          res["notes"]["worst_leaf"])
    assert res["correct"] is False, res["checks"]
