"""Port parity, the training substrate (``repro_torch.train``,
``repro_torch.data.tokens``): the mirror of ``tests/test_train_infra.py``
(optimizer, checkpoints, straggler monitor, trainer fault tolerance) and,
against the reference on the same inputs:

* ``batch_at`` / ``lm_batch`` bitwise over seed x step x shard x shards;
* ``optimizer.update``: parameters and float32 moments within 1e-6 of the
  reference's, bfloat16 moments (and a bfloat16 parameter) within one
  bfloat16 ulp, ``grad_norm``, the clip scale and ``lr`` within 1e-6, over
  three steps with clipping and weight decay; the IHT masks bitwise;
* ``StragglerMonitor`` verdicts equal on one seeded time series;
* checkpoint files crossing both ways: a reference-written tree restores
  here bitwise, bfloat16 leaves included (also from ``meta`` stand-ins);
  a port-written tree restores in the reference bitwise, and its bfloat16
  leaf fails there as the reference's own does (ROADMAP C7, pinned);
* ``keep_last``, the atomic rename, the shape-mismatch ``ValueError``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.straggler import StragglerMonitor as JStragglerMonitor
from repro_torch.data import tokens
from repro_torch.pytree import tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.straggler import StragglerMonitor
from repro_torch.train.trainer import Trainer, TrainerConfig

ADAM_ATOL = 1e-6


def t(x):
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Mirror of tests/test_train_infra.py
# ---------------------------------------------------------------------------

def test_adam_converges_quadratic():
    cfg = opt.AdamConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
    params = {"x": t([5.0, -3.0])}
    state = opt.init(params, cfg)
    for _ in range(200):
        grads = {"x": 2 * params["x"]}
        params, state, m = opt.update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.05


def test_adam_bf16_states_still_converge():
    cfg = opt.AdamConfig(lr=0.1, warmup_steps=1, state_dtype="bfloat16")
    params = {"x": t([5.0, -3.0])}
    state = opt.init(params, cfg)
    assert state["m"]["x"].dtype == torch.bfloat16
    for _ in range(200):
        params, state, _ = opt.update(params, {"x": 2 * params["x"]}, state,
                                      cfg)
    assert float(params["x"].abs().max()) < 0.1


def test_grad_clip_reported():
    cfg = opt.AdamConfig(grad_clip=1.0)
    params = {"x": torch.zeros(3)}
    state = opt.init(params, cfg)
    _, _, m = opt.update(params, {"x": t([100.0, 0, 0])}, state, cfg)
    assert float(m["grad_norm"]) > 99


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.tensor(3)}}
    d = str(tmp_path)
    ckpt.save(d, 5, tree, metadata={"next_step": 5})
    assert ckpt.latest_step(d) == 5
    out = ckpt.restore(d, 5, tree_map(torch.zeros_like, tree))
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert ckpt.read_metadata(d, 5)["next_step"] == 5


def test_checkpoint_keep_last(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, {"x": torch.tensor(s)}, keep_last=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, {"x": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        ckpt.restore(d, 0, {"x": torch.zeros((3, 3))})


def test_straggler_monitor_flags_outlier():
    m = StragglerMonitor(min_samples=4, abs_floor_s=0.0)
    for _ in range(20):
        m.observe(0.1)
    v = m.observe(0.9)
    assert v["straggler"]
    v2 = m.observe(5.0)
    assert v2["hard_fault"]


def _toy_trainer(tmp_path, fault_at=None, total=12):
    calls = {"n": 0}
    acfg = opt.AdamConfig(lr=0.2, warmup_steps=1)

    def init_params():
        return {"w": torch.zeros(4)}

    def step_fn(params, opt_state, batch):
        loss = torch.sum(torch.square(params["w"] - batch))
        grads = {"w": params["w"] - batch}
        p, s, m = opt.update(params, grads, opt_state, acfg)
        return p, s, {"loss": loss}

    def batch_fn(step):
        return torch.full((4,), 1.0)

    def fault_hook(step):
        if fault_at is not None and step == fault_at and calls["n"] == 0:
            calls["n"] = 1
            raise RuntimeError("simulated node failure")

    cfg = TrainerConfig(total_steps=total, checkpoint_every=4,
                        checkpoint_dir=str(tmp_path), max_restarts=2,
                        adam=acfg)
    return Trainer(cfg, init_params_fn=init_params, step_fn=step_fn,
                   batch_fn=batch_fn, fault_hook=fault_hook)


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = _toy_trainer(tmp_path)
    hist = tr.run()
    steps = [h["step"] for h in hist if "step" in h]
    assert steps == list(range(12))
    assert ckpt.latest_step(str(tmp_path)) == 12


def test_trainer_fault_restart_resumes_exactly(tmp_path):
    tr = _toy_trainer(tmp_path, fault_at=6)
    hist = tr.run()
    events = [h for h in hist if h.get("event") == "restart"]
    assert len(events) == 1
    steps = [h["step"] for h in hist if "step" in h]
    # steps 0..5 ran, fault at 6, restart resumes from checkpoint at 4
    assert steps == list(range(0, 6)) + list(range(4, 12))
    assert tr.restarts == 1
    # and the replayed steps give the uninterrupted run's losses, bitwise
    clean = _toy_trainer(tmp_path / "clean").run()
    assert [h["loss"] for h in hist if "loss" in h][6:] == \
        [h["loss"] for h in clean][4:]


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_bitwise_reference(seed):
    for vocab, seq, gb in ((128, 32, 8), (151_936, 64, 4)):
        cfg = tokens.TokenStreamConfig(vocab_size=vocab, seq_len=seq,
                                       global_batch=gb, seed=seed)
        jcfg = jtokens.TokenStreamConfig(vocab_size=vocab, seq_len=seq,
                                         global_batch=gb, seed=seed)
        for step in (0, 1, 13):
            for num_shards in (1, 2, 4):
                for shard in range(num_shards):
                    a = tokens.batch_at(cfg, step, shard, num_shards)
                    b = jtokens.batch_at(jcfg, step, shard, num_shards)
                    assert a.dtype == b.dtype and np.array_equal(a, b)
            got, want = tokens.lm_batch(cfg, step), jtokens.lm_batch(jcfg,
                                                                     step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert np.array_equal(got[k], want[k])


def adam_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32),
                  "b": rng.standard_normal(7).astype(np.float32)},
            "table": (0.02 * rng.standard_normal((9, 4))).astype(np.float32)}


def to_port(tree, table_dtype):
    out = tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    out["table"] = out["table"].to(table_dtype)
    return out


def to_ref(tree, table_dtype):
    out = jax.tree.map(jnp.asarray, tree)
    out["table"] = out["table"].astype(table_dtype)
    return out


def bf16_ulps(got: torch.Tensor, want) -> int:
    """Largest distance in bfloat16 steps between a tensor and a reference
    array of bfloat16 values (compared through their bit patterns)."""
    g = got.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    w = np.asarray(want).astype(np.float32).view(np.int32) >> 16
    return int(np.abs(g - w.astype(np.int64)).max())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adam_update_matches_reference(state_dtype):
    acfg = dict(lr=1e-2, warmup_steps=3, weight_decay=0.01, grad_clip=1.0,
                state_dtype=state_dtype)
    cfg, jcfg = opt.AdamConfig(**acfg), jopt.AdamConfig(**acfg)
    p0 = adam_tree(0)
    params, jparams = to_port(p0, torch.bfloat16), to_ref(p0, jnp.bfloat16)
    state, jstate = opt.init(params, cfg), jopt.init(jparams, jcfg)
    for step in range(3):
        g = adam_tree(10 + step)
        g = tree_map(lambda a: a * (3.0 if step == 0 else 0.05), g)
        params, state, m = opt.update(params, to_port(g, torch.float32),
                                      state, cfg)
        jparams, jstate, jm = jopt.update(jparams, to_ref(g, jnp.float32),
                                          jstate, jcfg)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            ADAM_ATOL * float(jm["grad_norm"])
        assert abs(float(m["lr"]) - float(jm["lr"])) <= ADAM_ATOL
        scale = min(1.0, 1.0 / (float(m["grad_norm"]) + 1e-9))
        jscale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
        assert abs(scale - jscale) <= ADAM_ATOL
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for k in ("w", "b"):
            np.testing.assert_allclose(params["a"][k].numpy(),
                                       np.asarray(jparams["a"][k]), rtol=0,
                                       atol=ADAM_ATOL)
        assert bf16_ulps(params["table"], jparams["table"]) <= 1
        for mom in ("m", "v"):
            got = state[mom]
            want = jstate[mom]
            assert got["table"].dtype == getattr(torch, state_dtype)
            for leaf, jleaf in ((got["a"]["w"], want["a"]["w"]),
                                (got["a"]["b"], want["a"]["b"]),
                                (got["table"], want["table"])):
                if state_dtype == "float32":
                    np.testing.assert_allclose(
                        leaf.numpy(), np.asarray(jleaf), rtol=0,
                        atol=ADAM_ATOL)
                else:
                    assert bf16_ulps(leaf, jleaf) <= 1


def test_iht_masks_match_reference():
    rng = np.random.default_rng(3)
    tree = {"blocks": {"w": rng.standard_normal((2, 6, 5)).astype(
        np.float32), "b": rng.standard_normal(5).astype(np.float32)}}
    prev = jprev = None
    for epoch in range(5):
        prev = opt.iht_epoch_masks(tree_map(torch.from_numpy, tree), epoch,
                                   0.5, 3, prev)
        jprev = jopt.iht_epoch_masks(jax.tree.map(jnp.asarray, tree), epoch,
                                     0.5, 3, jprev)
        assert prev.frozen == jprev.frozen
        for k in ("w", "b"):
            assert np.array_equal(prev.masks["blocks"][k].numpy(),
                                  np.asarray(jprev.masks["blocks"][k]))
    got = opt.apply_iht(tree_map(torch.from_numpy, tree), prev)
    want = jopt.apply_iht(jax.tree.map(jnp.asarray, tree), jprev)
    assert np.array_equal(got["blocks"]["w"].numpy(),
                          np.asarray(want["blocks"]["w"]))


def test_straggler_verdicts_match_reference():
    rng = np.random.default_rng(11)
    series = 0.1 + 0.01 * rng.standard_normal(200)
    series[[30, 31, 90, 150]] = [0.5, 2.0, 0.3, 5.0]
    m, jm = StragglerMonitor(min_samples=4), JStragglerMonitor(min_samples=4)
    verdicts = [m.observe(float(x)) for x in series]
    assert verdicts == [jm.observe(float(x)) for x in series]
    assert m.flagged == jm.flagged > 0
    assert any(v["hard_fault"] for v in verdicts)


def mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": {"table": rng.standard_normal((6, 4))},
                       "blocks": {"w": rng.standard_normal((2, 4, 3))}},
            "opt": {"step": np.int32(7)}}


def test_checkpoint_restores_reference_files_bitwise(tmp_path):
    """The reference's own checkpoint (its ``save``), float32, int32 and
    bfloat16 leaves, restored here bit for bit: into tensors and from
    ``meta`` stand-ins."""
    raw = mixed_tree(0)
    jtree = {"params": {
        "embed": {"table": jnp.asarray(raw["params"]["embed"]["table"],
                                       jnp.bfloat16)},
        "blocks": {"w": jnp.asarray(raw["params"]["blocks"]["w"],
                                    jnp.float32)}},
        "opt": {"step": jnp.asarray(raw["opt"]["step"])}}
    d = str(tmp_path)
    jckpt.save(d, 3, jtree, metadata={"next_step": 3})
    like = {"params": {"embed": {"table": torch.zeros(
        (6, 4), dtype=torch.bfloat16)}, "blocks": {"w": torch.zeros(2, 4, 3)}},
        "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), like)
    for out in (ckpt.restore(d, 3, like), ckpt.restore(d, 3, meta,
                                                       device="cpu")):
        table = jtree["params"]["embed"]["table"]
        assert out["params"]["embed"]["table"].dtype == torch.bfloat16
        assert np.array_equal(
            out["params"]["embed"]["table"].view(torch.int16).numpy(),
            np.asarray(table).view(np.int16))
        assert np.array_equal(out["params"]["blocks"]["w"].numpy(),
                              np.asarray(jtree["params"]["blocks"]["w"]))
        assert out["opt"]["step"].dtype == torch.int32
        assert int(out["opt"]["step"]) == 7
    params = ckpt.restore(d, 3, {"params": meta["params"]}, device="cpu")
    assert set(params) == {"params"}
    assert ckpt.read_metadata(d, 3) == {"next_step": 3}
    with pytest.raises(ValueError, match="meta"):
        ckpt.restore(d, 3, meta)
    import distharness
    from repro_torch.launch import sharding as S
    with distharness.one_rank_mesh(tmp_path) as mesh:
        sh = S.named(mesh, {"params": {
            "embed": {"table": S.P("model", None)},
            "blocks": {"w": S.P("data", None)}},
            "opt": {"step": S.P()}})
        out = ckpt.restore(d, 3, like, shardings=sh)
        table = out["params"]["embed"]["table"]
        assert table.placements == sh["params"]["embed"]["table"].placements
        assert np.array_equal(table.full_tensor().view(torch.int16).numpy(),
                              np.asarray(jtree["params"]["embed"]["table"])
                              .view(np.int16))
        assert int(out["opt"]["step"].full_tensor()) == 7


def test_reference_restores_port_files(tmp_path):
    """A port-written checkpoint restores in the reference bit for bit;
    its bfloat16 leaf, stored under the reference's own ``|V2``
    descriptor, fails there as the reference's own file does (C7)."""
    raw = mixed_tree(1)
    tree = {"params": {"blocks": {"w": torch.from_numpy(
        raw["params"]["blocks"]["w"]).float()}},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    d = str(tmp_path)
    ckpt.save(d, 2, tree, metadata={"next_step": 2})
    like = {"params": {"blocks": {"w": jnp.zeros((2, 4, 3))}},
            "opt": {"step": jnp.zeros((), jnp.int32)}}
    out = jckpt.restore(d, 2, like)
    assert np.array_equal(np.asarray(out["params"]["blocks"]["w"]),
                          tree["params"]["blocks"]["w"].numpy())
    assert int(out["opt"]["step"]) == 7
    assert jckpt.read_metadata(d, 2) == {"next_step": 2}
    e = str(tmp_path / "bf16")
    table = torch.from_numpy(raw["params"]["embed"]["table"]).to(
        torch.bfloat16)
    ckpt.save(e, 0, {"table": table})
    with np.load(os.path.join(e, "step_00000000", "arrays.npz")) as z:
        assert z["['table']"].dtype == np.dtype("V2")
        assert np.array_equal(z["['table']"].view(np.int16),
                              table.view(torch.int16).numpy())
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(e, 0, {"table": jnp.zeros((6, 4), jnp.bfloat16)})


def test_reference_cannot_restore_its_own_bfloat16_checkpoint(tmp_path):
    """ROADMAP C7, pinned: the reference's ``save`` of a bfloat16 leaf,
    then its own ``restore``, raises (``np.savez`` stores ``ml_dtypes``'
    bfloat16 as ``|V2``, which ``astype`` cannot cast back); the port
    reads the same file."""
    d = str(tmp_path)
    x = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3),
                    jnp.bfloat16)
    jckpt.save(d, 1, {"x": x})
    with pytest.raises(ValueError, match="No cast function available"):
        jckpt.restore(d, 1, {"x": jnp.zeros((2, 3), jnp.bfloat16)})
    out = ckpt.restore(d, 1, {"x": torch.zeros((2, 3),
                                                dtype=torch.bfloat16)})
    assert torch.equal(out["x"].float(), torch.arange(6.0).reshape(2, 3))


def test_checkpoint_atomic_rename_and_manifest(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crashed write
    assert ckpt.latest_step(d) is None
    path = ckpt.save(d, 4, {"a": torch.ones(2, dtype=torch.bfloat16),
                            "b": {"c": torch.zeros(3)}}, keep_last=1)
    assert path == os.path.join(d, "step_00000004")
    assert not os.path.exists(path + ".tmp")
    assert ckpt.latest_step(d) == 4
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"] == {"['a']": {"shape": [2], "dtype": "bfloat16"},
                             "['b']['c']": {"shape": [3],
                                            "dtype": "float32"}}
    ckpt.save(d, 4, {"a": torch.zeros(2)}, keep_last=1)   # overwrite
    assert torch.equal(ckpt.restore(d, 4, {"a": torch.ones(2)})["a"],
                       torch.zeros(2))
    ckpt.save(d, 5, {"a": torch.zeros(2)}, keep_last=1)
    assert sorted(x for x in os.listdir(d) if not x.endswith(".tmp")) == \
        ["step_00000005"]
